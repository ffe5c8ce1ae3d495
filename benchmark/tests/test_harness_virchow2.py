"""The Virchow2 cell at a tiny size on the CPU, through the whole harness
(set-up, window, check, result line) on the fused route's plain versions,
against `reference/virchow2.py`; the preprocess faults must make `correct`
come out false; the control (the reference's products in fp8) reads above
the program; the operation counts and the cell's program readers."""
from __future__ import annotations

import copy
import dataclasses
import json

import pytest

from benchmark import faults, glu_vit, harness, program_spans, roofline
from benchmark.tests import tiny
from benchmark.tests.test_harness_program_spans import _layer, _rec, _trace
from benchmark.tests.test_harness_trace import EVENTS

CELL = "virchow2.preprocess"


@pytest.fixture()
def v2(monkeypatch):
    """The cell's files cut to a tiny width and depth (224 px, 261 tokens,
    2 heads of 80, branch 24 held as 128), with the port's VIRCHOW2 made
    that spec, as the driver requires."""
    from paths_tpu_torch.encoders import vit

    cfg = copy.deepcopy(tiny._file("configs", "virchow2-vith14"))
    cfg["model"].update(embed_dim=160, depth=1, num_heads=2, mlp_ratio=0.3,
                        glu_width=24, compute_dtype="float32")
    tr = copy.deepcopy(tiny._file("traffic", "slides_10x-virchow2"))
    tr["slides"].update(count=2, height=1024, width=768)
    tr["magnifications"] = [5.0, 10.0]
    tr["pipeline"].update(batch_size=8, threads=2)
    tr["check"]["sample_patches"] = 6
    tr["check"]["limits"]["feature_gap"] = 1e-4
    tr["trace_seconds"] = 0.2
    monkeypatch.setattr(vit, "VIRCHOW2", dataclasses.replace(
        vit.VIRCHOW2, embed_dim=160, depth=1, num_heads=2, mlp_ratio=0.3,
        glu_width=24))
    return cfg, tr


def test_tiny_cell_is_correct(v2, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, tr = v2
    out = tiny.run(CELL, cfg, tr, cache=str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"encode_patches_per_s", "setup_s"}
    assert out["checks"]["plan_mismatches"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(f for d, f in faults.FAULTS
                                         if d == "preprocess"))
def test_fault_makes_run_incorrect(v2, fault, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, tr = v2
    with faults.planted("preprocess", fault):
        out = tiny.run(CELL, cfg, tr, cache=str(tmp_path))
    assert not out["correct"], out["checks"]


def test_a_spec_other_than_the_ports_is_refused(v2, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, tr = v2
    cfg["model"]["num_heads"] = 4
    with pytest.raises(ValueError, match="VIRCHOW2"):
        tiny.run(CELL, cfg, tr, cache=str(tmp_path))


def test_control_reads_above_the_program(v2, tmp_path, monkeypatch):
    from benchmark import control

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cfg, tr = v2
    r = control.readings(CELL, cfg, tr, 3, 0.3, True, device="cpu")
    gap = r["program"]["feature_gap"]
    assert set(r["control"]) == {"fp8 reference"}
    assert r["control"]["fp8 reference"]["feature_gap"] > 100 * gap


def test_counts_at_the_published_widths():
    dims = tiny._file("configs", "virchow2-vith14")["model"]
    assert glu_vit.tokens(dims) == 261
    # 340 GFLOP a patch, 2.76x UNI's 123
    uni = tiny._file("configs", "uni-vitl16")["model"]
    v, u = glu_vit.flops_per_image(dims), roofline.vit_flops_per_image(uni)
    assert abs(v / 1e9 - 340.1) < 0.1 and abs(v / u - 2.76) < 0.01
    ops, nbytes = glu_vit.swiglu_block_counts(64, 261, 1280, 3416, 2)
    assert ops == 6 * 64 * 261 * 1280 * 3416
    assert nbytes == 2 * (2 * 64 * 261 * 1280 + 3 * 1280 * 3416) \
        + 4 * (4 * 1280 + 2 * 3416)


def _with(t):
    lay = _layer(t)
    lay.run.config = {"model": tiny._file("configs", "virchow2-vith14")["model"]}
    lay.run.peaks = roofline.peaks("NVIDIA H100 80GB HBM3")
    return lay


def test_program_readers(tmp_path, monkeypatch):
    t = _trace(tmp_path, copy.deepcopy(EVENTS))
    level = _rec("paths.preprocess.level", 10, 990, power=10.0, patches=104)
    monkeypatch.setattr(program_spans, "profiler_base_ns", lambda: 0)
    monkeypatch.setattr(program_spans, "_program_records", lambda: [
        level,
        _rec("paths.preprocess.encode", 300, 340, parent=level, rows=64,
             vit_rows=64, vit_pad_rows=0),
        _rec("paths.preprocess.encode", 500, 560, parent=level, rows=40,
             vit_rows=64, vit_pad_rows=24)])
    lay = _with(t)
    assert harness.reader("encode_pad_pct.virchow2")(lay) == pytest.approx(
        100 * 24 / 128)
    assert harness.reader("encode_dispatch_ms.virchow2")(lay) == pytest.approx(0.05)
    # a program that counts no rows (the parent's): silent, not zero
    monkeypatch.setattr(program_spans, "_program_records", lambda: [
        level, _rec("paths.preprocess.encode", 300, 340, parent=level)])
    lay = _with(t)
    assert harness.reader("encode_pad_pct.virchow2")(lay) is None
    assert harness.reader("encode_dispatch_ms.virchow2")(lay) == pytest.approx(0.04)


def test_roofline_readers_need_their_kernels(tmp_path):
    """No head-dim-80 attention kernel in the trace: the attention share is
    silent; a traced Virchow2 block pair is read at its published counts."""
    t = _trace(tmp_path, copy.deepcopy(EVENTS))
    assert harness.reader("vit_attn_hd80_block_roofline")(_with(t)) is None
    ev = [e for e in copy.deepcopy(EVENTS) if e.get("cat") not in
          ("kernel", "gpu_memcpy", "gpu_memset")]
    at = 100.0

    def k(name, dur, grid=(1, 1, 1)):
        nonlocal at
        e = {"ph": "X", "cat": "kernel", "name": name, "ts": at, "dur": dur,
             "pid": 0, "tid": 7, "args": {"grid": list(grid)}}
        at += dur
        return e
    ev += [k("vit_ln_kernel<bf16>", 5), k("gemm<EpiBias>", 100),
           k("vit_attn_hd80_bf16_kernel<false>", 50, (3, 16, 64)),
           k("gemm<EpiResidual<bf16>>", 45),
           k("vit_ln_kernel<bf16>", 5), k("gemm<EpiSwiglu>", 300),
           k("gemm<EpiResidual<bf16>>", 150)]
    lay = _with(_trace(tmp_path, ev))
    ops, nbytes = roofline.vit_block_counts("attn", 64, 261, 1280, 0, 2)
    pk = lay.run.peaks
    want = roofline.bound_seconds(ops, nbytes, pk["bfloat16"], pk["bytes_per_s"])
    assert harness.reader("vit_attn_hd80_block_roofline")(lay) == \
        pytest.approx(100 * want / 200e-6)
    ops, nbytes = glu_vit.swiglu_block_counts(64, 261, 1280, 3416, 2)
    want = roofline.bound_seconds(ops, nbytes, pk["bfloat16"], pk["bytes_per_s"])
    assert harness.reader("vit_swiglu_block_roofline")(lay) == \
        pytest.approx(100 * want / 455e-6)


def test_benchmark_lists_the_cell_and_its_metrics():
    b = tiny.bench()
    names = {m["name"] for m in harness.metrics_of(b, CELL, "per_layer")}
    assert names == {"vit_attn_hd80_block_roofline", "vit_swiglu_block_roofline",
                     "mfu.encode", "device_idle_pct.encode",
                     "idle_plan_pct.encode", "idle_read_wait_pct.encode",
                     "idle_drain_pct.encode",
                     "encode_pad_pct.virchow2", "encode_dispatch_ms.virchow2"}
    e2e = {m["name"] for m in harness.metrics_of(b, CELL, "end_to_end")}
    assert e2e == {"encode_patches_per_s", "setup_s"}
    cfg = json.load(open(f"{harness.BENCH}/configs/virchow2-vith14.json"))
    assert cfg["reduced"] == [] and cfg["model"]["glu_width"] == 3416
