"""Host bytes the trainer's collation hands to the device a step: the
program's `h2d_bytes` counter summed over the `paths.collate` spans of the
traced segment, over their number, in MB (1e6 bytes)."""
from benchmark.program_spans import per_span


def read(layer):
    v = per_span(layer, "h2d_bytes", "paths.collate")
    return None if v is None else v / 1e6
