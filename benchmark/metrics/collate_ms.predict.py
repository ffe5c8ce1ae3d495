"""Mean host time of the program's collation (`paths.collate`: stacking
a batch's tables and handing them to the device) inside the request,
over the spans that start and end inside the traced segment."""
from benchmark.program_spans import mean_ms


def read(layer):
    return mean_ms(layer, "paths.collate")
