"""The share of the traced segment in which no operation ran on the
device (the union of its operations' intervals)."""
from benchmark.layers import idle_pct


def read(layer):
    return idle_pct(layer)
