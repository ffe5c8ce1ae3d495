"""UNI encoding's useful operations (the ViT forward of every tissue
patch of the window's passes, padding rows not counted) over the window and
the bf16 peak."""
from benchmark.layers import mfu_pct


def read(layer):
    d = layer.driver
    return mfu_pct(layer, d.useful_flops(d.window_passes), "bfloat16")
