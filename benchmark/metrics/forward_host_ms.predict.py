"""Mean host time of the session's forward of a batch: the program's
`paths.forward` spans that start and end inside the traced segment, the
forward's dispatch and any wait for the device inside it."""
from benchmark.program_spans import mean_ms


def read(layer):
    return mean_ms(layer, "paths.forward")
