"""One run of one benchmark cell: set-up, the measured window, an optional
traced segment, the correctness check and the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration in `benchmark/configs/<config>.json`, its traffic in
`benchmark/traffic/<traffic>.json` (which names its driver,
`benchmark/drivers/<driver>.py`), and each per-layer metric's reader in
`benchmark/metrics/<metric>.py`. A later cell adds files and entries.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "paths_tpu")


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; no library loads JAX."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")):
    """(benchmark, cell entry, configuration, traffic) of the named cell."""
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    config = read_json(os.path.join(BENCH, "configs", f"{cell['config']}.json"))
    traffic = read_json(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str) -> Callable:
    """The `read` function of `benchmark/metrics/<metric>.py`."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a driver is given: the cell's files, the run's arguments, where
    to write, and the span and trace switches."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: str = "cuda"
    tmp: str = ""
    cache: str = CACHE
    tracing: bool = False
    peaks: Optional[dict] = None

    def span(self, name: str):
        """A `record_function` span while the traced segment runs."""
        if not self.tracing:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def sync(self) -> None:
        import torch
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()


@dataclass
class Layer:
    """What a per-layer reader is given."""
    run: Run
    driver: object
    trace: object = None          # benchmark.trace.Trace of the segment


@contextlib.contextmanager
def traced_segment(run: Run, out: dict):
    """The profiler over the block, its window marked `bench.window`;
    `out["trace"]` gets the reduced trace."""
    import torch
    from benchmark.trace import Trace

    run.sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device.startswith("cuda"):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    run.tracing = True
    try:
        with torch.profiler.record_function("bench.window"):
            yield
            run.sync()
    finally:
        run.tracing = False
        prof.__exit__(None, None, None)
    path = os.path.join(run.tmp, "trace.json")
    prof.export_chrome_trace(path)
    try:
        out["trace"] = Trace.load(path)
    finally:
        os.remove(path)


@contextlib.contextmanager
def host_threads(traffic: dict):
    """The intra-op thread count of the cell's traffic file
    (`torch_threads`) while the run lasts; the library's default (one a
    core) where the file names none."""
    import torch

    old = torch.get_num_threads()
    if traffic.get("torch_threads"):
        torch.set_num_threads(int(traffic["torch_threads"]))
    try:
        yield
    finally:
        torch.set_num_threads(old)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(cell: str, config: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, e2e: List[dict], per_layer: List[dict],
            device: str = "cuda", chips: int = 1,
            t_start: Optional[float] = None, cache: str = CACHE) -> dict:
    """Run the cell once and return its result line (a dict)."""
    import torch

    from benchmark import roofline

    t_start = time.perf_counter() if t_start is None else t_start
    tmp = tempfile.mkdtemp(prefix="bench-")
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed,
              seconds=seconds, device=device, tmp=tmp, cache=cache)
    if device.startswith("cuda"):
        kind = torch.cuda.get_device_name(0)
        run.peaks = roofline.peaks(kind)
    else:
        kind = "cpu"
    drv = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}").Driver(run)
    try:
        with host_threads(traffic):
            result = _measure(run, drv, traffic, trace, e2e, per_layer, chips,
                              kind, t_start)
    finally:
        drv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    # last, after the check and every reader: what loaded JAX anywhere in
    # the run leaves no result
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        raise SystemExit(3)
    return result


def _measure(run: Run, drv, traffic: dict, trace: bool, e2e: List[dict],
             per_layer: List[dict], chips: int, kind: str,
             t_start: float) -> dict:
    """Set-up, window, traced segment, check and readers: the result line."""
    import torch

    device = run.device
    drv.setup()
    run.sync()
    setup_s = time.perf_counter() - t_start
    window = drv.window(run.seconds)
    seg: dict = {}
    if trace:
        with traced_segment(run, seg):
            drv.traced(traffic["trace_seconds"])
    run.sync()
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    drv.release()
    checks = drv.check()
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": window["attempted"], "failed": window["failed"]}
    metrics = {}
    if not trace:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        layer = Layer(run=run, driver=drv, trace=seg.get("trace"))
        for m in per_layer:
            value = reader(m["name"])(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": kind, "count": chips, "memory_peak_bytes": peak}
    result["metrics"] = metrics
    result["device"] = dev
    if trace and seg.get("trace") is not None:
        t = seg["trace"]
        dev["busy_s"] = t.busy_s()
        dev["window_s"] = t.window_s
        result["breakdown"] = t.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
