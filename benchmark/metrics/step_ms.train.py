"""Mean time of a step on the device's stream: from a CUDA event recorded
before `update` to one recorded after it, over the window's steps (so the
gaps while the host dispatches the step count, the wait for a batch not)."""
import numpy as np


def read(layer):
    ms = layer.driver.window_step_ms
    return float(np.mean(ms)) if ms else None
