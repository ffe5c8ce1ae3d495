"""The share of the rows the encode dispatches send through the encoder
that are bucket padding: the program's `vit_pad_rows` over its `vit_rows`,
summed over the `paths.preprocess.encode` spans of the traced segment, in
%; nothing where the program counts no rows."""
from benchmark.program_spans import per_span


def read(layer):
    rows = per_span(layer, "vit_rows", "paths.preprocess.encode")
    if not rows:
        return None
    return 100.0 * per_span(layer, "vit_pad_rows", "paths.preprocess.encode") / rows
