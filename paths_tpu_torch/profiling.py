"""Profiling: the profiler session, the program's own spans and counters,
and the host's memory (counterpart of `paths_tpu.profiling`).

* `trace(logdir)`: a context manager around `torch.profiler.profile`, CPU
  activity plus the card's kernels where a card is present, written to
  `logdir` as a `*.pt.trace.json` that Perfetto and TensorBoard open, with
  the program's spans of the session beside the profiler's events
* `span(name, **attrs)`, `record_span`, `count(key, n)`, `spans()`: the
  program's recorder. It records only while a profiler session runs (any
  session: this module's `trace` or the caller's own), on every thread,
  and stamps each span with `time.time_ns()`, the clock a profiler trace's
  `ts` counts from its `baseTimeNanoseconds`. A span opened on a worker
  thread (collation's prefetch thread, the patch readers, the staging
  thread), which `torch.profiler.record_function` leaves out of the
  trace, is recorded here. With no session, a span site costs one
  attribute read
* `host_rss_mb`: the process's resident set size, recorded per epoch
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import socket
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _torch_profiler

# the recorder keeps the newest records only, so a long profiled run holds
# a bounded amount of host memory
MAX_RECORDS = 1 << 20
SPAN_CATEGORY = "paths_span"

_records: "collections.deque" = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()


def host_rss_mb() -> float | None:
    """Current process resident set size in MB (Linux /proc), or None.

    The train loop records it per epoch, so long runs show that their host
    memory stays bounded."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return None


def _stack() -> list:
    """The calling thread's open spans. Its native id is read once, with
    the stack: a system call on some hosts (7.5 us a call on an H100
    machine's, against 0.07 us for `time.time_ns()`)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.tid = threading.get_native_id()
    return stack


class Span:
    """One recorded span: its name, the native id of its thread (the `tid`
    of the profiler's events), its `time.time_ns()` start and end, the
    span open on the same thread where it was made (or None) and its
    attributes, which `count` adds to while it is the innermost open span
    of its thread."""

    __slots__ = ("name", "tid", "start_ns", "end_ns", "parent", "attrs")

    def __init__(self, name: str, attrs: dict):
        stack = _stack()
        self.name, self.attrs = name, attrs
        self.tid = _local.tid
        self.parent: Optional[Span] = stack[-1] if stack else None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        _stack().append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _stack().pop()
        _records.append(self)
        return False


# the span of every site while no profiler runs: shared, and does nothing
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the block as a span named `name`
    with `attrs` while a profiler session runs (checked once, on entry),
    and the one shared no-op otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def record_span(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a span from two `time.time_ns()` stamps the caller took
    itself (for a site that times the block whether or not a profiler
    runs), while a profiler session runs."""
    if not _torch_profiler._is_profiler_enabled:
        return
    s = Span(name, attrs)
    s.start_ns, s.end_ns = start_ns, end_ns
    _records.append(s)


def count(key: str, n) -> None:
    """Add `n` to attribute `key` of the innermost open span of the calling
    thread; nothing where no recorded span is open."""
    stack = getattr(_local, "stack", None)
    if stack:
        attrs = stack[-1].attrs
        attrs[key] = attrs.get(key, 0) + n


def spans() -> List[Span]:
    """The recorded spans, oldest first (the newest `MAX_RECORDS`)."""
    return list(_records)


def _write_spans(path: str, since_ns: int) -> None:
    """Add the spans recorded from `since_ns` on to the Chrome trace at
    `path`, on its clock (`ts` in microseconds from the file's
    `baseTimeNanoseconds`; older Kineto writes none, and absolute times)."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = data.setdefault("traceEvents", [])
    for s in spans():
        if s.start_ns < since_ns:
            continue
        args = dict(s.attrs)
        if s.parent is not None:
            args["parent"] = s.parent.name
        events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": s.name,
                       "pid": pid, "tid": s.tid,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body into `logdir` (CPU activity, and CUDA kernels when
    `torch.cuda.is_available()`) as `<host>_<pid>.<ns>.pt.trace.json`,
    with the program's spans of the session as events of category
    `paths_span`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = time.time_ns()

    def ready(prof) -> None:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                    f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        _write_spans(path, since)

    with profile(activities=activities, on_trace_ready=ready):
        yield
