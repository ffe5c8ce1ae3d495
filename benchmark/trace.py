"""Reduction of a torch.profiler (Kineto) Chrome trace to what the
per-layer readers take: the device's busy time as the union of its
operations' intervals (two streams running at once count once), the idle
gaps between them named by the benchmark's own host span that was open,
device time by kernel family, and the kernels themselves in order.

The traced window is the benchmark's `bench.window` annotation.
"""
from __future__ import annotations

import collections
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


@dataclass
class Op:
    start: float    # microseconds
    end: float
    name: str
    cat: str
    args: dict


@dataclass
class Span:
    start: float
    end: float
    name: str
    tid: int


class Trace:
    """The device operations and the benchmark's spans of one traced
    window, clipped to it."""

    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("ph") == "X"
                  and e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError(f"the trace holds no {WINDOW} span")
        w = window[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.main_tid = w.get("tid")
        self.ops: List[Op] = []
        self.spans: List[Span] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if s + d <= self.t0 or s >= self.t1:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.ops.append(Op(max(s, self.t0), min(s + d, self.t1),
                                   e.get("name", ""), cat, e.get("args", {})))
            elif (cat == "user_annotation" and e.get("name", "").startswith("bench.")
                  and e.get("name") != WINDOW):
                self.spans.append(Span(s, s + d, e["name"], e.get("tid")))
        self.ops.sort(key=lambda o: o.start)
        if not self.ops:
            raise ValueError("the trace holds no device operation in its "
                             "window: it was not taken on a card")

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            return Trace(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for o in self.ops:
            if merged and o.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o.end)
            else:
                merged.append([o.start, o.end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost benchmark span on the main thread
        open at each gap's midpoint ("no bench span" where none is)."""
        spans = sorted((s for s in self.spans if s.tid == self.main_tid),
                       key=lambda s: s.start)
        out: Dict[str, float] = collections.defaultdict(float)
        active: List[Span] = []
        nxt = 0
        for a, b in self.idle_gaps():       # in time order
            t = 0.5 * (a + b)
            while nxt < len(spans) and spans[nxt].start <= t:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s.end > t]
            name = max(active, key=lambda s: s.start).name if active else "no bench span"
            out[name] += (b - a) * 1e-6
        return dict(out)

    def by_family(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for o in self.ops:
            out[op_family(o.name)] += (o.end - o.start) * 1e-6
        return dict(out)

    def kernels(self, pattern: str) -> List[Op]:
        rx = re.compile(pattern)
        return [o for o in self.ops if o.cat == "kernel" and rx.search(o.name)]

    def breakdown(self, top: int = 10) -> dict:
        def biggest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": biggest(self.by_family()),
                "idle_gaps": biggest(self.idle_by_span())}


# ------------------------------------------------- kernel families
# (the grouping of `paths_tpu_torch/tools/profile_step.py`, copied)

_SUFFIX = re.compile(r"[._-]?\d+$")
_TAG = re.compile(r"[A-Za-z_]\w*(?:Functor|functor|_kernel)\w*")
_WRAPPERS = ("gpu_kernel",)


def _strip_templates(name: str) -> str:
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def _strip_call(name: str) -> str:
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if not depth:
                return name[:i]
    return name


def _template_args(name: str) -> str:
    start = name.find("<")
    if start < 0:
        return ""
    depth = 0
    for i in range(start, len(name)):
        if name[i] == "<":
            depth += 1
        elif name[i] == ">":
            depth -= 1
            if not depth:
                return name[start + 1:i]
    return ""


def op_family(name: str) -> str:
    """A device operation's family: its name without template arguments,
    argument list and instance suffix, tagged with the functor or kernel
    body its template arguments name (`Memcpy HtoD (Pageable -> Device)` ->
    `Memcpy HtoD`)."""
    if name.startswith("void "):
        name = name[len("void "):]
    base = _SUFFIX.sub("", _strip_call(_strip_templates(name)).strip())
    args = _template_args(name)
    tags = [t for t in _TAG.findall(args) if not t.startswith(_WRAPPERS)]
    first = _strip_templates(args.split(",")[0]).strip()
    if tags:
        return f"{base}<{tags[0]}>"
    if "_" in first and not first[0].isdigit():
        return f"{base}<{first.split('::')[-1]}>"
    return base or name
