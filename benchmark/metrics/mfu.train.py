"""The training step's useful operations (forward and backward, three
forwards' worth, over the real slides and each bag's valid patches) over
the window and the f32 peak."""
from benchmark.layers import mfu_pct


def read(layer):
    return mfu_pct(layer, layer.driver.useful_flops(), "float32")
