"""Host bytes a request hands to the device: the program's `h2d_bytes`
counter summed under the `paths.serve.request` spans of the traced segment,
over their number, in MB (1e6 bytes); 0 where the batch cache hits."""
from benchmark.program_spans import per_span


def read(layer):
    v = per_span(layer, "h2d_bytes", "paths.serve.request")
    return None if v is None else v / 1e6
