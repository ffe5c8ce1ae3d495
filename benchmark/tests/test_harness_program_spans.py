"""The program's spans on the trace's clock (`benchmark/program_spans.py`)
and the ten readers of them: the base of the clock, the idle attribution by
the innermost program span on the main thread, the means and the counters
per span; the trace's own readings unchanged by program spans in the file;
and every new reader silent where the program has no recorder.

Card-only cases (`-m cuda`): a traced `uni.preprocess` run gives the three
idle shares of the pipeline's stages, and every `paths.preprocess.level`
lies inside its `bench.process_level` on the card's trace.
"""
from __future__ import annotations

import copy
import json
from types import SimpleNamespace

import pytest

from benchmark import harness, layers, program_spans
from benchmark.harness import Layer, Run
from benchmark.tests.test_harness_trace import EVENTS
from benchmark.trace import Trace

NEW = ["idle_plan_pct.encode", "idle_read_wait_pct.encode",
       "idle_drain_pct.encode", "collate_ms.train", "h2d_mb_per_step.train",
       "forward_host_ms.train", "collate_ms.predict",
       "h2d_mb_per_request.predict", "batch_cache_hit_pct.predict",
       "forward_host_ms.predict"]


def _trace(tmp_path, events, **top) -> Trace:
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events, **top}))
    return Trace.load(str(p))


def _rec(name, start_us, end_us, tid=1, parent=None, **attrs):
    """A program record as `paths_tpu_torch.profiling.spans()` gives it,
    stamped in ns on a clock whose base is 0."""
    return SimpleNamespace(name=name, tid=tid, start_ns=int(start_us * 1e3),
                           end_ns=int(end_us * 1e3), parent=parent, attrs=attrs)


def _layer(trace) -> Layer:
    run = Run(cell="x", config={}, traffic={}, seed=0, seconds=1, device="cuda")
    return Layer(run=run, driver=None, trace=trace)


@pytest.fixture()
def program(monkeypatch):
    """Plants records as the program's, on a clock with base 0."""
    def plant(records):
        monkeypatch.setattr(program_spans, "_program_records", lambda: records)
        monkeypatch.setattr(program_spans, "profiler_base_ns", lambda: 0)
    return plant


def test_base_of_a_trace_file(tmp_path):
    p = tmp_path / "a.json"
    p.write_text(json.dumps({"traceEvents": [], "baseTimeNanoseconds": 1790857026000000000}))
    assert program_spans.base_ns_of(str(p)) == 1790857026000000000
    p.write_text(json.dumps({"traceEvents": []}))       # older Kineto
    assert program_spans.base_ns_of(str(p)) == 0


def test_profiler_base_is_this_process_traces_base(tmp_path):
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    assert program_spans.profiler_base_ns() == program_spans.base_ns_of(path)


def test_program_spans_inside_the_benchmark_spans_on_the_cpu(tmp_path):
    """The card test's rule on a CPU trace: each program span, moved onto
    the trace's clock, lies inside the `record_function` span around it
    within 50 us."""
    import torch

    from paths_tpu_torch.profiling import span, spans

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.window"):
            for i in range(10):
                with torch.profiler.record_function("bench.process_level"):
                    with span("paths.preprocess.level", power=float(i)):
                        torch.ones(64).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    w = next(e for e in data["traceEvents"] if e.get("name") == "bench.window")
    data["traceEvents"].append({"ph": "X", "cat": "kernel", "name": "k",
                                "ts": w["ts"], "dur": 1.0, "tid": 7, "pid": 0})
    t = _trace(tmp_path, data["traceEvents"])
    mine = [s for s in program_spans.overlapping(
        t, program_spans.on_clock(spans(), program_spans.profiler_base_ns()))
        if s.name == "paths.preprocess.level"]
    bench = [s for s in t.spans if s.name == "bench.process_level"]
    assert len(mine) == len(bench) == 10
    for lv, b in zip(mine, sorted(bench, key=lambda s: s.start)):
        assert b.start - 50 <= lv.start <= lv.end <= b.end + 50, (lv, b)
        assert lv.tid == b.tid == t.main_tid


def test_trace_readings_unchanged_by_program_spans_in_the_file(tmp_path):
    spans = [{"ph": "X", "cat": "paths_span", "name": "paths.preprocess.level",
              "ts": 0, "dur": 900, "tid": 1, "pid": 0, "args": {"power": 1.0}},
             {"ph": "X", "cat": "paths_span", "name": "paths.collate",
              "ts": 100, "dur": 300, "tid": 2, "pid": 0, "args": {}}]
    plain = _trace(tmp_path, copy.deepcopy(EVENTS))
    (tmp_path / "b").mkdir()
    withp = _trace(tmp_path / "b", copy.deepcopy(EVENTS) + spans,
                   baseTimeNanoseconds=1790857026000000000)
    assert withp.breakdown() == plain.breakdown()
    assert withp.busy_s() == plain.busy_s()
    assert withp.idle_by_span() == plain.idle_by_span()
    assert [s.name for s in withp.spans] == [s.name for s in plain.spans]
    assert layers.idle_pct(_layer(withp)) == layers.idle_pct(_layer(plain))


# idle gaps of EVENTS' window [0, 1000]: [0, 50], [200, 250], [260, 300],
# [450, 700], [704, 1000]
def _pipeline():
    level = _rec("paths.preprocess.level", 10, 990, power=10.0, patches=40)
    return [level,
            _rec("paths.preprocess.plan", 20, 60, parent=level),
            _rec("paths.preprocess.read_wait", 190, 270, parent=level),
            _rec("paths.preprocess.encode", 300, 400, parent=level),
            _rec("paths.preprocess.drain", 800, 900, parent=level),
            _rec("paths.preprocess.read", 0, 1000, tid=2, patches=8),
            _rec("paths.preprocess.stage", 0, 1000, tid=3, bytes=64)]


def test_idle_attribution_by_the_innermost_main_thread_span(tmp_path, program):
    t = _trace(tmp_path, copy.deepcopy(EVENTS))
    program(_pipeline())
    lay = _layer(t)
    idle = program_spans.idle_by_span(t, program_spans.of(lay))
    assert idle["paths.preprocess.plan"] == pytest.approx(50e-6)      # [0, 50]
    assert idle["paths.preprocess.read_wait"] == pytest.approx(50e-6)
    assert idle["paths.preprocess.level"] == pytest.approx((40 + 250) * 1e-6)
    assert idle["paths.preprocess.drain"] == pytest.approx(296e-6)    # [704, 1000]
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s())
    got = {m: harness.reader(m)(lay) for m in NEW[:3]}
    assert got == pytest.approx({"idle_plan_pct.encode": 5.0,
                                 "idle_read_wait_pct.encode": 5.0,
                                 "idle_drain_pct.encode": 29.6})
    assert sum(got.values()) <= layers.idle_pct(lay)


def test_train_readers(tmp_path, program):
    t = _trace(tmp_path, copy.deepcopy(EVENTS))
    a = _rec("paths.collate", 100, 400, tid=2, slides=32, h2d_bytes=2_000_000)
    b = _rec("paths.collate", 500, 1100, tid=2, slides=32, h2d_bytes=3_000_000)
    program([a, b,
             # a table stacked inside b after the window closed still counts
             _rec("paths.table", 1010, 1050, tid=2, parent=b, h2d_bytes=1_000_000),
             _rec("paths.collate", 1200, 1300, tid=2, h2d_bytes=8_000_000),
             _rec("paths.forward", 300, 340), _rec("paths.forward", 600, 660)])
    lay = _layer(t)
    got = {m: harness.reader(m)(lay) for m in
           ("collate_ms.train", "h2d_mb_per_step.train", "forward_host_ms.train")}
    # b runs past the segment: its bytes count, its duration does not
    assert got == pytest.approx({"collate_ms.train": 0.3,
                                 "h2d_mb_per_step.train": 3.0,
                                 "forward_host_ms.train": 0.05})


def test_predict_readers(tmp_path, program):
    t = _trace(tmp_path, copy.deepcopy(EVENTS))
    r1 = _rec("paths.serve.request", -200, 400, slides=32)
    b1 = _rec("paths.serve.batch", -190, 300, parent=r1, hit=0)
    r2 = _rec("paths.serve.request", 450, 700, slides=32)
    r3 = _rec("paths.serve.request", 1100, 1200, slides=32)
    program([r1, b1,
             _rec("paths.collate", -50, 100, parent=b1, slides=32, h2d_bytes=1_000_000),
             _rec("paths.collate", 120, 200, parent=b1, slides=32, h2d_bytes=500_000),
             _rec("paths.forward", 310, 390, parent=r1),
             r2, _rec("paths.serve.batch", 455, 460, parent=r2, hit=1),
             _rec("paths.forward", 470, 690, parent=r2),
             r3, _rec("paths.serve.batch", 1100, 1110, parent=r3, hit=0)])
    lay = _layer(t)
    got = {m: harness.reader(m)(lay) for m in
           ("collate_ms.predict", "h2d_mb_per_request.predict",
            "batch_cache_hit_pct.predict", "forward_host_ms.predict")}
    assert got == pytest.approx({"collate_ms.predict": 0.08,
                                 "h2d_mb_per_request.predict": 0.75,
                                 "batch_cache_hit_pct.predict": 50.0,
                                 "forward_host_ms.predict": 0.15})


@pytest.mark.parametrize("program_has", ["no spans()", "no records", "no trace"])
def test_new_readers_silent_without_the_recorder(tmp_path, monkeypatch, program_has):
    """The parent commit's program has no `spans()`: every new reader
    returns None (the metric is left out), and none raises."""
    from paths_tpu_torch import profiling

    t = _trace(tmp_path, copy.deepcopy(EVENTS))
    if program_has == "no spans()":
        monkeypatch.delattr(profiling, "spans")
    elif program_has == "no records":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    else:
        t = None
    lay = _layer(t)
    assert {m: harness.reader(m)(lay) for m in NEW} == dict.fromkeys(NEW)


def test_new_metrics_declared_as_read():
    b = harness.read_json(harness.ROOT + "/BENCHMARK.json")
    per = {m["name"]: m for m in b["per_layer"]}
    assert [m["name"] for m in b["per_layer"][-len(NEW):]] == NEW
    for name in NEW:
        assert callable(harness.reader(name))
        assert per[name]["workloads"]


# ------------------------------------------------------------ on the card

@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return "cuda"


@pytest.mark.cuda
def test_traced_uni_run_gives_the_pipeline_idle_shares(card, tmp_path):
    from benchmark.tests.test_harness_cuda import _uni_on_card

    cfg, tr = _uni_on_card()
    b = harness.read_json(harness.ROOT + "/BENCHMARK.json")
    cell = "uni.preprocess"
    out = harness.execute(cell, cfg, tr, 2**31 + 11, 0.5, True,
                          harness.metrics_of(b, cell, "end_to_end"),
                          harness.metrics_of(b, cell, "per_layer"),
                          device=card, cache=str(tmp_path))
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert {m_ for m_ in NEW[:3]} <= set(m)
    assert sum(m[k]["value"] for k in NEW[:3]) <= m["device_idle_pct.encode"]["value"]


@pytest.mark.cuda
def test_levels_inside_their_benchmark_spans_on_the_card(card, tmp_path):
    from benchmark.drivers.preprocess import Driver
    from benchmark.tests.test_harness_cuda import _uni_on_card
    from paths_tpu_torch.profiling import spans

    cfg, tr = _uni_on_card()
    run = Run(cell="uni.preprocess", config=cfg, traffic=tr, seed=2**31 + 13,
              seconds=0.5, device=card, tmp=str(tmp_path), cache=str(tmp_path))
    drv = Driver(run)
    try:
        drv.setup()
        seg: dict = {}
        with harness.traced_segment(run, seg):
            drv.traced(0.5)
    finally:
        drv.close()
    t = seg["trace"]
    mine = [s for s in program_spans.overlapping(
        t, program_spans.on_clock(spans(), program_spans.profiler_base_ns()))
        if s.name == "paths.preprocess.level"]
    bench = sorted((s for s in t.spans if s.name == "bench.process_level"),
                   key=lambda s: s.start)
    assert mine and len(mine) == len(bench)
    for lv, b in zip(mine, bench):
        assert b.start - 50 <= lv.start <= lv.end <= b.end + 50, (lv, b)
