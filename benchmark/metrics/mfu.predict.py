"""Serving's useful operations (the forward over each served slide's valid
patches at every level) over the window and the f32 peak."""
from benchmark.layers import mfu_pct


def read(layer):
    return mfu_pct(layer, layer.driver.useful_flops(), "float32")
