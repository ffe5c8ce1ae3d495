"""The trace reduction on a hand-made Kineto trace: busy time is the union
of the device's intervals (two streams at once count once), idle gaps are
named by the open benchmark span, ViT block launches are grouped from the
LayerNorm pre-pass to the residual GEMM, and the flash share divides the
counted launches' least time by the kernels' time."""
from __future__ import annotations

import json

import pytest

from benchmark import layers, roofline
from benchmark.harness import Layer, Run
from benchmark.trace import Trace, op_family


def _x(name, ts, dur, cat="kernel", tid=7, args=None):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid, "pid": 0, "args": args or {}}


EPI = "void tiles::gemm_tma_kernel<__nv_bfloat16, false, __nv_bfloat16, tiles::{}<__nv_bfloat16> >(int)"
EVENTS = [
    _x("bench.window", 0, 1000, "user_annotation", tid=1),
    _x("bench.update", 100, 200, "user_annotation", tid=1),
    _x("bench.next_batch", 400, 200, "user_annotation", tid=1),
    _x("bench.other_thread", 0, 1000, "user_annotation", tid=2),
    _x("aten::mm", 100, 50, "cpu_op", tid=1),
    _x("k1", 50, 100, tid=7),
    _x("k2", 100, 100, tid=8),                       # overlaps k1
    _x("Memcpy HtoD (Pinned -> Device)", 250, 10, "gpu_memcpy"),
    _x("void vit_ln_kernel<__nv_bfloat16>(int)", 300, 10),
    _x(EPI.format("EpiBias"), 310, 30),
    _x("void vit_attn_bf16_kernel<false>(int)", 340, 20, args={"grid": [2, 16, 64]}),
    _x(EPI.format("EpiResidual"), 360, 20),
    _x("void vit_ln_kernel<__nv_bfloat16>(int)", 380, 5),
    _x(EPI.format("EpiGelu<0>"), 385, 35),
    _x(EPI.format("EpiResidual"), 420, 30),
    _x("void flash_fwd_f32_kernel<32>(int)", 700, 4),
    _x("late", 1200, 100),
]


@pytest.fixture()
def trace(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    return Trace.load(str(p))


def test_busy_is_the_union_of_device_intervals(trace):
    assert trace.window_s == pytest.approx(1e-3)
    # [50, 200] + [250, 260] + [300, 450] + [700, 704]
    assert trace.busy_s() == pytest.approx((150 + 10 + 150 + 4) * 1e-6)
    summed = sum(o.end - o.start for o in trace.ops) * 1e-6
    assert summed > trace.busy_s()                  # the sum counts k1/k2 twice


def test_idle_gaps_named_by_the_open_main_thread_span(trace):
    idle = trace.idle_by_span()
    assert idle["bench.update"] == pytest.approx((50 + 40) * 1e-6)
    assert idle["bench.next_batch"] == pytest.approx(250e-6)    # [450, 700]
    assert idle["no bench span"] == pytest.approx((50 + 296) * 1e-6)
    assert sum(idle.values()) == pytest.approx(trace.window_s - trace.busy_s())
    bd = trace.breakdown()
    assert bd["idle_gaps"][0][0] == "no bench span"
    assert "bench.other_thread" not in idle
    assert len(bd["device_ops"]) <= 10


def test_vit_groups(trace):
    groups = layers.vit_groups(trace)
    assert [(g["kind"], g["images"]) for g in groups] == [("attn", 64), ("mlp", 64)]
    assert groups[0]["seconds"] == pytest.approx(80e-6)
    assert groups[1]["seconds"] == pytest.approx(70e-6)


def _layer(trace, driver, config=None):
    run = Run(cell="x", config=config or {}, traffic={}, seed=0, seconds=1,
              device="cuda", peaks=roofline.peaks("NVIDIA H100"))
    return Layer(run=run, driver=driver, trace=trace)


def test_vit_roofline_share(trace):
    dims = {"img_size": 224, "patch_size": 16, "embed_dim": 1024,
            "mlp_ratio": 4.0, "compute_dtype": "bfloat16"}
    share = layers.vit_roofline_pct(_layer(trace, None, {"model": dims}), "attn")
    ops, nbytes = roofline.vit_block_counts("attn", 64, 197, 1024, 4096, 2)
    want = 100 * max(ops / 989e12, nbytes / 3.35e12) / 80e-6
    assert share == pytest.approx(want)


def test_flash_share_and_idle(trace):
    class Flash:
        def host(self):
            return [("fwd", (2, 4, 81, 32), 81, 4, [81, 40])]

    class Driver:
        flash = Flash()
        window_s = 2.0

    lay = _layer(trace, Driver())
    ops, nbytes = roofline.flash_fwd_counts(2, 4, 81, 32, [81, 40], 4)
    want = 100 * max(ops / 67e12, nbytes / 3.35e12) / 4e-6
    assert layers.flash_roofline_pct(lay, "fwd") == pytest.approx(want)
    assert layers.idle_pct(lay) == pytest.approx(100 * (1 - 0.314))
    assert layers.mfu_pct(lay, 67e12, "float32") == pytest.approx(50.0)


@pytest.mark.parametrize("counted", [0, 2])
def test_flash_share_falls_silent_when_launches_go_uncounted(trace, counted):
    """A launch reached by a name the count does not wrap (or a fused
    kernel) leaves the traced kernels and the count apart: no share, rather
    than one read low."""
    class Flash:
        def host(self):
            return [("fwd", (2, 4, 81, 32), 81, 4, [81, 40])] * counted

    class Driver:
        flash = Flash()

    assert layers.flash_roofline_pct(_layer(trace, Driver()), "fwd") is None
    assert layers.flash_roofline_pct(_layer(trace, Driver()), "bwd") is None


def test_trace_without_device_ops_is_refused(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS[:5]}))
    with pytest.raises(ValueError):
        Trace.load(str(p))


@pytest.mark.parametrize("name,family", [
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3>)", "at::native::vectorized_elementwise_kernel<CUDAFunctor_add>"),
    ("gemm_kernel_7", "gemm_kernel"),
])
def test_op_family(name, family):
    assert op_family(name) == family


def test_flash_launches_are_counted_and_the_entries_restored():
    import torch

    from benchmark.drivers.common import FlashLaunches
    from paths_tpu_torch.kernels import flash_attention as fa

    before = {n: getattr(fa, n) for n in FlashLaunches.NAMES}
    q = torch.randn(2, 4, 9, 32, requires_grad=True)
    lengths = torch.tensor([9, 5], dtype=torch.int32)
    rec = FlashLaunches()
    with rec.active():
        out = fa.masked_flash_attention(q, q, q, lengths, 128)
        out.sum().backward()
        fa.flash_attention_fwd(q.detach(), q.detach(), q.detach(), lengths, 128)
    assert [(k, s, nk, item, ln) for k, s, nk, item, ln in rec.host()] == [
        ("fwd", (2, 4, 9, 32), 9, 4, [9, 5]),
        ("bwd", (2, 4, 9, 32), 9, 4, [9, 5]),
        ("fwd", (2, 4, 9, 32), 9, 4, [9, 5])]
    assert {n: getattr(fa, n) for n in FlashLaunches.NAMES} == before
