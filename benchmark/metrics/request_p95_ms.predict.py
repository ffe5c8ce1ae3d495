"""95th percentile of the wall time of `ServingSession.predict`, over all
of the window's requests."""
from benchmark.layers import percentile_ms


def read(layer):
    return percentile_ms([s for _, _, s in layer.driver.window_log], 95)
