"""The share of the traced segment in which the device idled while
`paths.preprocess.drain` was the innermost program span open on the main
thread: the level's copy of its embeddings back to the host and their
scatter."""
from benchmark.program_spans import idle_pct_under


def read(layer):
    return idle_pct_under(layer, "paths.preprocess.drain")
