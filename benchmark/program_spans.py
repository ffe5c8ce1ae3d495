"""The program's own spans and counters (`paths_tpu_torch.profiling.spans()`)
on the clock of a traced segment's `Trace`, for the per-layer readers.

The program stamps a span with `time.time_ns()`; a Kineto trace's `ts` is
microseconds from the file's `baseTimeNanoseconds` (0 where a version
writes none, and absolute microseconds). `Trace` keeps no base, so the base
is read from a profiler export of this process's own: Kineto fixes it once
a process. The spans kept are those that overlap the segment.

Every function returns None where the program records no spans: a program
without the recorder, or a segment in which it recorded nothing.
"""
from __future__ import annotations

import copy
import functools
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.trace import Span


@dataclass
class PSpan:
    start: float                    # microseconds on the trace's clock
    end: float
    name: str
    tid: int
    attrs: dict = field(default_factory=dict)
    parent: Optional["PSpan"] = None

    def enclosing(self, name: str) -> Optional["PSpan"]:
        """This span or the innermost enclosing one named `name`."""
        s = self
        while s is not None and s.name != name:
            s = s.parent
        return s


def base_ns_of(path: str) -> int:
    """A Chrome trace file's `baseTimeNanoseconds`, 0 where absent."""
    with open(path) as f:
        return int(json.load(f).get("baseTimeNanoseconds", 0))


@functools.lru_cache(maxsize=None)
def profiler_base_ns() -> int:
    """The base of this process's profiler traces, from a CPU-only session
    of its own exported to a temporary file."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pass
    with tempfile.TemporaryDirectory(prefix="bench-base-") as d:
        path = os.path.join(d, "base.json")
        prof.export_chrome_trace(path)
        return base_ns_of(path)


def _program_records() -> Optional[list]:
    from paths_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if callable(read) else None


def on_clock(records, base_ns: int) -> List[PSpan]:
    """The records (with `name`, `tid`, `start_ns`, `end_ns`, `attrs` and
    `parent`) on a trace's clock, in order of start, parents kept."""
    moved: Dict[int, PSpan] = {}
    for r in records:
        moved[id(r)] = PSpan((r.start_ns - base_ns) / 1e3,
                             (r.end_ns - base_ns) / 1e3, r.name, r.tid,
                             dict(r.attrs))
    for r in records:
        if r.parent is not None:
            moved[id(r)].parent = moved.get(id(r.parent))
    return sorted(moved.values(), key=lambda s: s.start)


def overlapping(trace, spans: List[PSpan]) -> List[PSpan]:
    return [s for s in spans if s.end > trace.t0 and s.start < trace.t1]


def _moved(layer) -> Optional[List[PSpan]]:
    """Every recorded span on the layer's trace clock (cached on the
    layer), or None."""
    if layer.trace is None:
        return None
    if not hasattr(layer, "_program_spans"):
        records = _program_records()
        layer._program_spans = (on_clock(records, profiler_base_ns())
                                if records else None)
    return layer._program_spans


def of(layer) -> Optional[List[PSpan]]:
    """The program's spans that overlap the layer's traced segment, or
    None."""
    spans = _moved(layer)
    return (overlapping(layer.trace, spans) or None) if spans else None


def idle_by_span(trace, spans: List[PSpan]) -> Dict[str, float]:
    """`Trace.idle_by_span` with the program's spans in place of the
    benchmark's: idle seconds by the innermost program span on the main
    thread open at each idle gap's midpoint."""
    t = copy.copy(trace)
    t.spans = [Span(s.start, s.end, s.name, s.tid) for s in spans]
    return t.idle_by_span()


def idle_pct_under(layer, name: str) -> Optional[float]:
    """The share of the segment in which the device idled while `name` was
    the innermost program span open on the main thread, in %."""
    spans = of(layer)
    if spans is None:
        return None
    t = layer.trace
    return 100.0 * idle_by_span(t, spans).get(name, 0.0) / t.window_s


def named(layer, name: str) -> Optional[List[PSpan]]:
    spans = of(layer)
    if spans is None:
        return None
    return [s for s in spans if s.name == name] or None


def mean_ms(layer, name: str) -> Optional[float]:
    """Mean duration of the spans named `name` that start and end inside
    the segment, in ms. One that runs past its end (a producer thread's,
    starved while the profiler stops and exports) would read long."""
    t = layer.trace
    spans = [s for s in named(layer, name) or ()
             if s.start >= t.t0 and s.end <= t.t1]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / len(spans) / 1e3


def per_span(layer, key: str, name: str) -> Optional[float]:
    """Attribute `key` summed over the spans named `name` that overlap the
    segment and every span they enclose (inside the segment or not), over
    the number of those spans."""
    spans = named(layer, name)
    if spans is None:
        return None
    kept = {id(s) for s in spans}
    total = 0
    for s in _moved(layer):
        outer = s.enclosing(name)
        if outer is not None and id(outer) in kept:
            total += s.attrs.get(key, 0)
    return float(total) / len(spans)
