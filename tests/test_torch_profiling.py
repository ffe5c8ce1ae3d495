"""The port's recorder (`paths_tpu_torch.profiling`): spans and counters
recorded only while a profiler session runs, on every thread, on the clock
of the profiler's trace; `trace()` writes them into the file it exports;
and the spans the preprocess pipeline, collation, the training step and
the serving session record, with their attributes, on the CPU."""
import glob
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from paths_tpu_torch import profiling
from paths_tpu_torch.profiling import count, span, spans

CPU = [ProfilerActivity.CPU]


def _since(t0: int, name_prefix: str = "paths."):
    return [s for s in spans() if s.start_ns >= t0
            and s.name.startswith(name_prefix)]


def test_nothing_recorded_and_nothing_allocated_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    n = len(spans())
    with span("paths.test.off", k=1) as s:
        count("bytes", 10)
    assert s is None and len(spans()) == n
    assert span("paths.a") is span("paths.b", k=2)   # one shared no-op
    profiling.record_span("paths.test.off", 0, 1, k=1)
    assert len(spans()) == n

    def sites():
        for _ in range(2000):
            with span("paths.test.off", slides=3):
                count("h2d_bytes", 128)

    sites()                                  # warm the interpreter's caches
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        sites()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # nothing kept, and no per-site growth: 2000 sites stay within a few
    # of the interpreter's own small blocks
    assert after - before <= 256 and peak - before <= 1024, (before, after, peak)
    assert len(spans()) == n


def test_worker_thread_spans_nest_and_count_lands_on_the_innermost():
    t0 = time.time_ns()
    got = {}

    def worker():
        got["tid"] = threading.get_native_id()
        with span("paths.test.outer", k="w"):
            with span("paths.test.inner"):
                count("bytes", 3)
                count("bytes", 4)
            count("rows", 1)
        count("rows", 100)                     # no open span: dropped

    with profile(activities=CPU):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
        with span("paths.test.main"):
            count("rows", 2)
    rec = {s.name: s for s in _since(t0, "paths.test.")}
    outer, inner, main = (rec["paths.test.outer"], rec["paths.test.inner"],
                          rec["paths.test.main"])
    assert outer.tid == inner.tid == got["tid"] != main.tid
    assert main.tid == threading.get_native_id()
    assert inner.parent is outer and outer.parent is None and main.parent is None
    assert inner.attrs == {"bytes": 7}
    assert outer.attrs == {"k": "w", "rows": 1} and main.attrs == {"rows": 2}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_threads_record_concurrently_without_losing_a_span_or_a_count():
    """More threads than cores, switching as often as the interpreter
    lets them: every span is recorded once, with its own thread's parent
    and counts."""
    import sys

    n_threads, n_spans = 4 * (os.cpu_count() or 2), 300
    t0 = time.time_ns()

    def worker(i):
        for j in range(n_spans):
            with span("paths.test.stress.outer", w=i):
                with span("paths.test.stress.inner"):
                    count("n", 1)
                    count("n", j)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=CPU):
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    rec = _since(t0, "paths.test.stress.")
    inner = [s for s in rec if s.name.endswith("inner")]
    assert len(rec) == 2 * n_threads * n_spans
    assert all(s.parent.tid == s.tid and s.parent.name.endswith("outer")
               for s in inner)
    assert sorted(s.attrs["n"] for s in inner) == sorted(
        [1 + j for j in range(n_spans)] * n_threads)
    assert len({(s.parent.attrs["w"], s.tid) for s in inner}) == n_threads


def test_spans_lie_on_the_profiler_trace_clock(tmp_path):
    """A span opened inside a `record_function` annotation starts and ends
    inside the annotation's interval, read as `ts` + the file's
    `baseTimeNanoseconds`."""
    t0 = time.time_ns()
    with profile(activities=CPU) as prof:
        for i in range(20):
            with record_function(f"bracket{i}"):
                with span(f"paths.test.clock{i}"):
                    torch.ones(4).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    ann = {e["name"]: e for e in data["traceEvents"]
           if e.get("name", "").startswith("bracket") and e.get("ph") == "X"}
    rec = {s.name: s for s in _since(t0, "paths.test.clock")}
    assert len(ann) == len(rec) == 20
    for i in range(20):
        a, s = ann[f"bracket{i}"], rec[f"paths.test.clock{i}"]
        start = round(float(a["ts"]) * 1e3) + base
        end = round((float(a["ts"]) + float(a["dur"])) * 1e3) + base
        assert start <= s.start_ns <= s.end_ns <= end, (i, start, s.start_ns,
                                                         s.end_ns, end)
        assert a["tid"] == s.tid


def _span_on_a_thread():
    with span("paths.test.thread"):
        pass


def test_trace_writes_program_spans_into_its_file(tmp_path):
    from paths_tpu_torch.tools.profile_step import device_op_table

    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with span("paths.test.traced", slides=2):
            count("h2d_bytes", 64)
            torch.ones(8).sum()
        th = threading.Thread(target=_span_on_a_thread)
        th.start()
        th.join()
    paths = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        data = json.load(f)
    mine = [e for e in data["traceEvents"] if e.get("cat") == profiling.SPAN_CATEGORY]
    by = {e["name"]: e for e in mine}
    assert set(by) == {"paths.test.traced", "paths.test.thread"}
    e = by["paths.test.traced"]
    assert e["ph"] == "X" and e["pid"] == os.getpid()
    assert e["tid"] == threading.get_native_id()
    assert e["args"] == {"slides": 2, "h2d_bytes": 64} and e["dur"] > 0
    assert by["paths.test.thread"]["tid"] != e["tid"]
    # on the file's clock: the span lies inside the profiled CPU activity
    cpu = [x for x in data["traceEvents"] if x.get("ph") == "X"
           and x.get("cat") == "cpu_op"]
    assert min(x["ts"] for x in cpu) - 1e4 < e["ts"] < max(x["ts"] for x in cpu) + 1e4
    # the operator's device table reads the file as it reads it without them
    kernel = {"ph": "X", "cat": "kernel", "name": "void k<float>(int)",
              "ts": e["ts"], "dur": 5.0, "pid": 0, "tid": 7}
    plain = {"traceEvents": [x for x in data["traceEvents"] if x not in mine]
             + [kernel]}
    data["traceEvents"].append(kernel)
    assert device_op_table(data) == device_op_table(plain)


# ------------------------------------------------- the program's sites

def _fake_slide(rows=512, cols=768):
    """White background with a dark tissue blob in the left half."""
    rng = np.random.default_rng(0)
    img = np.full((rows, cols, 3), 240, np.uint8)
    yy, xx = np.mgrid[0:rows, 0:cols]
    blob = ((yy - rows // 2) ** 2 + (xx - cols // 4) ** 2) < (rows // 3) ** 2
    img[blob] = rng.integers(80, 160, (rows, cols, 3)).astype(np.uint8)[blob]
    return img


def test_process_level_spans():
    from paths_tpu_torch.preprocess import pipeline
    from paths_tpu_torch.preprocess.wsi import ArrayWSI

    def encode(imgs):
        return imgs[:, ::4, ::4, :].reshape(imgs.shape[0], -1)[:, :8].float()

    t0 = time.time_ns()
    with profile(activities=CPU):
        grid = pipeline.process_level(ArrayWSI(_fake_slide(), 10.0), encode, 8,
                                      10.0, patch_size=64, batch_size=8,
                                      threads=2, device="cpu")
    rec = _since(t0, "paths.preprocess.")
    names = [s.name for s in rec]
    (level,) = [s for s in rec if s.name == "paths.preprocess.level"]
    patches = int((grid != 0).any(-1).sum())
    n_batches = -(-patches // 8)
    assert level.attrs == {"power": 10.0, "patches": patches} and patches > 8
    for name, n in (("plan", 1), ("read_wait", n_batches),
                    ("encode", n_batches), ("drain", 1)):
        got = [s for s in rec if s.name == f"paths.preprocess.{name}"]
        assert len(got) == n, (name, names)
        assert all(s.parent is level and s.tid == level.tid for s in got)
    reads = [s for s in rec if s.name == "paths.preprocess.read"]
    stages = [s for s in rec if s.name == "paths.preprocess.stage"]
    assert sorted(s.attrs["patches"] for s in reads) == sorted(
        [8] * (patches // 8) + ([patches % 8] if patches % 8 else []))
    assert len(stages) == n_batches
    assert all(s.attrs["bytes"] == 8 * 64 * 64 * 3 for s in stages)
    assert all(s.tid != level.tid for s in reads + stages)


def test_encode_span_counts_rows_and_padding():
    """Each encode dispatch's span carries its valid patches (`rows`) and
    counts the rows it sends through the encoder (`vit_rows`, the bucket)
    and the bucket's padding among them (`vit_pad_rows`)."""
    from paths_tpu_torch.preprocess import pipeline
    from paths_tpu_torch.preprocess.wsi import ArrayWSI

    sent = []

    def encode(imgs):
        sent.append(imgs.shape[0])
        return imgs[:, ::4, ::4, :].reshape(imgs.shape[0], -1)[:, :8].float()

    t0 = time.time_ns()
    with profile(activities=CPU):
        grid = pipeline.process_level(ArrayWSI(_fake_slide(), 10.0), encode, 8,
                                      10.0, patch_size=64, batch_size=6,
                                      threads=2, device="cpu")
    enc = [s for s in _since(t0, "paths.preprocess.encode")]
    patches = int((grid != 0).any(-1).sum())
    assert patches % 6, "the tail batch must be padded"
    assert [s.attrs["vit_rows"] for s in enc] == sent == [6] * len(enc)
    assert sum(s.attrs["rows"] for s in enc) == patches
    assert [s.attrs["vit_pad_rows"] for s in enc] == \
        [6 - s.attrs["rows"] for s in enc]
    assert sum(s.attrs["vit_pad_rows"] for s in enc) == 6 - patches % 6


def _small_config(tmp):
    from paths_tpu_torch.config import Config, PATHSProcessorConfig
    from paths_tpu_torch.data.synthetic import make_synthetic_store

    cfg = Config(model_config=PATHSProcessorConfig(
        patch_embed_dim=32, trans_dim=16, trans_heads=2, trans_layers=2,
        importance_mlp_hidden_dim=8, hierarchical_ctx_mlp_hidden_dim=8,
        dropout=0.0), num_levels=3, top_k_patches=4, nbins=4, level0_bucket=16)
    cfg.preprocess_dir = str(tmp / "store")
    ids = make_synthetic_store(cfg.preprocess_dir, cfg, num_slides=4,
                               base_hw=(3, 4), seed=3)
    return cfg, ids


def _shipped_bytes(ds, idx, bag, tables) -> int:
    """The host bytes of a collated batch: each slide's own f32 feature
    rows (padding is made on the device), the int32 indices and a bool
    mask."""
    slides = [ds.slides[i] for i in idx]
    n = sum(s.level0[0].nbytes for s in slides)
    n += 4 * bag.locs.numel() + bag.mask.numel()
    for lvl, t in enumerate(tables):
        n += sum(s.tables[lvl]["fts"].nbytes for s in slides)
        n += 4 * (t.locs.numel() + t.count.numel() + t.index.numel()
                  + t.grid_hw.numel())
    return n


def test_collate_and_update_spans(tmp_path):
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import make_optimizer, make_step_fns

    cfg, ids = _small_config(tmp_path)
    ds = SlideDataset(ids, cfg, FeatureStore(cfg.preprocess_dir))
    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0))
    update, _ = make_step_fns(cfg, make_optimizer(cfg, model.parameters()))
    labels = {"survival_bin": torch.arange(3) % cfg.nbins,
              "censored": (torch.arange(3) % 2).int()}
    t0 = time.time_ns()
    with profile(activities=CPU):
        bag, tables = collate_batch(ds, [0, 1, 2],
                                    level0_bucket=cfg.level0_bucket, device="cpu")
        update(model, bag, tables, labels, torch.Generator().manual_seed(1),
               epoch=1)
    rec = _since(t0)
    (col,) = [s for s in rec if s.name == "paths.collate"]
    (fwd,) = [s for s in rec if s.name == "paths.forward"]
    assert col.attrs == {"slides": 3,
                         "h2d_bytes": _shipped_bytes(ds, [0, 1, 2], bag, tables)}
    assert fwd.parent is None and fwd.attrs == {} and col.end_ns <= fwd.start_ns


@pytest.mark.parametrize("cache_batches", [2, 0])
def test_serving_session_spans(tmp_path, cache_batches):
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.serve import ServingSession
    from paths_tpu_torch.train.state import save_state

    cfg, ids = _small_config(tmp_path)
    mdir = str(tmp_path / "model")
    cfg.save(mdir)
    save_state(mdir, RecursiveModel(cfg, generator=torch.Generator().manual_seed(0)))
    sess = ServingSession(mdir, batch_size=4, cache_batches=cache_batches,
                          device="cpu")
    t0 = time.time_ns()
    with profile(activities=CPU):
        first = sess.predict(ids[:2])             # a miss
        assert sess.predict(ids[:2]) == first     # a hit where cached
    rec = _since(t0)
    reqs = [s for s in rec if s.name == "paths.serve.request"]
    batches = [s for s in rec if s.name == "paths.serve.batch"]
    cols = [s for s in rec if s.name == "paths.collate"]
    fwds = [s for s in rec if s.name == "paths.forward"]
    assert [r.attrs["slides"] for r in reqs] == [2, 2]
    assert [f.parent for f in fwds] == reqs
    if cache_batches:
        assert [b.attrs["hit"] for b in batches] == [0, 1]
        assert [b.parent for b in batches] == reqs
        (col,) = cols
        assert col.parent is batches[0] and col.attrs["h2d_bytes"] > 0
    else:                                         # no cache: no batch span
        assert batches == [] and [c.parent for c in cols] == reqs
        assert cols[0].attrs == cols[1].attrs and cols[0].attrs["h2d_bytes"] > 0
