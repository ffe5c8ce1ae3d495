"""Kernel #1 (masked flash-attention forward) against its roofline in
serving, over the traced segment."""
from benchmark.layers import flash_roofline_pct


def read(layer):
    return flash_roofline_pct(layer, "fwd")
