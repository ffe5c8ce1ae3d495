"""The share of the traced segment in which the device idled while
`paths.preprocess.plan` was the innermost program span open on the main
thread: the level's tissue plan (Otsu mask and tissue proportions)."""
from benchmark.program_spans import idle_pct_under


def read(layer):
    return idle_pct_under(layer, "paths.preprocess.plan")
