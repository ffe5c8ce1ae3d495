"""Mean host time a step waits in `next()` on the trainer's batch iterator
(collation on the prefetch thread not yet done), over the window."""


def read(layer):
    d = layer.driver
    if not d.window_steps:
        return None
    return 1000.0 * sum(d.window_waits) / len(d.window_steps)
