"""The share of the session's batch-cache lookups (`paths.serve.batch`
spans, attribute `hit` 0 or 1) that hit, over the traced segment, in %."""
from benchmark.program_spans import named


def read(layer):
    spans = named(layer, "paths.serve.batch")
    if spans is None:
        return None
    return 100.0 * sum(s.attrs.get("hit", 0) for s in spans) / len(spans)
