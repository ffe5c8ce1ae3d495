"""Kernels #2 and #3 (masked flash-attention backward, dq and dk/dv)
against their roofline in the training step, over the traced segment."""
from benchmark.layers import flash_roofline_pct


def read(layer):
    return flash_roofline_pct(layer, "bwd")
