"""Mean host time of a batch's encode dispatch (`paths.preprocess.encode`:
the staged batch taken and the encoder's launches queued, and any wait
for the device inside them), over the spans that start and end inside the
traced segment."""
from benchmark.program_spans import mean_ms


def read(layer):
    return mean_ms(layer, "paths.preprocess.encode")
