"""The share of the traced segment in which the device idled while
`paths.preprocess.read_wait` was the innermost program span open on the
main thread: the wait for the next batch's patch reads."""
from benchmark.program_spans import idle_pct_under


def read(layer):
    return idle_pct_under(layer, "paths.preprocess.read_wait")
