"""Median wall time of `ServingSession.predict`, over the window's
requests."""
from benchmark.layers import percentile_ms


def read(layer):
    return percentile_ms([s for _, _, s in layer.driver.window_log], 50)
