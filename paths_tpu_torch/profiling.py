"""Profiling and timing harnesses (counterpart of `paths_tpu.profiling`).

* `trace(logdir)`: a context manager around `torch.profiler.profile`, CPU
  activity plus the card's kernels where a card is present, written to
  `logdir` as a `*.pt.trace.json` that Perfetto and TensorBoard open
* `time_fn`: steady-state wall timing that waits for the card around every
  call (a CUDA launch returns before the kernel has run)
* `step_timer`: per-step timer accumulating named wall-time buckets
* `host_rss_mb`: the process's resident set size, recorded per epoch
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body into `logdir` (CPU activity, and CUDA kernels when
    `torch.cuda.is_available()`)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Time `fn(*args)` steady-state; returns seconds per call stats."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"mean_s": sum(times) / len(times), "p50_s": times[len(times) // 2],
            "min_s": times[0], "max_s": times[-1], "iters": iters}


class step_timer:
    """Accumulates named wall-time buckets:

        timer = step_timer()
        with timer("data"):   batch = next(it)
        with timer("step"):   ... update ...
        timer.summary()  -> {"data_s": ..., "step_s": ..., "data_frac": ...}
    """

    def __init__(self):
        self.buckets: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.buckets[name] = (self.buckets.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        total = sum(self.buckets.values()) or 1.0
        out = {f"{k}_s": round(v, 4) for k, v in self.buckets.items()}
        out.update({f"{k}_frac": round(v / total, 4)
                    for k, v in self.buckets.items()})
        return out

    def reset(self):
        self.buckets.clear()
