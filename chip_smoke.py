#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paths_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions,
     and the build of every CUDA kernel from `paths_tpu_torch/csrc`;
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the serving path gives it and at one long bag, with errors,
     times, a PyTorch library call's time as a yardstick, and the least time
     the card could take for the same work;
  3. slice: a synthetic feature store and a randomly initialised model of the
     flagship `brca_paths_0` width are served through `ServingSession`; the
     launch counters show the serving path went through the kernels, the
     hazards are checked, and a session on the plain attention path must
     agree.
The line before the last is a JSON object of per-kernel numbers, and the
last line is `{"ok": true, "device": {...}}`. Any failed check raises, so
the script exits non-zero and prints no result; without a CUDA device it
exits with code 2.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke_work")   # listed in .gitignore

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet): f32 on
# the CUDA cores, since TF32 is disabled here, and device-memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain on the card: both f32, summed in different orders over up
# to 4096 keys.
KERNEL_ATOL = 2e-5
# Hazards through the kernel vs the plain attention path: the per-layer
# differences above pass through 2 decoder layers at each of 5 levels and
# the residual slide context between levels.
PRED_ATOL = 1e-4


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of one call over `iters` back-to-back calls, between CUDA
    events: host overhead shows where a call launches faster than the card
    runs it."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of one call: the summed time of the kernels it
    launched, from the profiler's CUDA trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return kernel_us(prof) / 1e3 / iters


def kernel_us(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA")


def flash_bound(b, h, nq, d, lengths):
    """(flop-limited ms, byte-limited ms) of the masked attention forward on
    these inputs: QK^T and PV over the valid keys only (2 flops per
    multiply-add each), q and out over every row, k and v over the valid
    rows, lse and lengths once."""
    valid = sum(lengths)
    flops = 4.0 * h * nq * d * valid
    nbytes = 4.0 * (2 * b * h * nq * d + 2 * h * valid * d + b * h * nq + b)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def kernel_phase(torch, tfa, gpu):
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(0)
    cases = {}
    for name, b, n in (("level0", 32, 257), ("deeper", 32, 81), ("long", 2, 4096)):
        lengths = torch.randint(1, n + 1, (b,), generator=gen, dtype=torch.int32)
        lengths[0], lengths[-1] = 1, n
        q, k, v = (torch.randn(b, 4, n, 32, generator=gen).cuda() for _ in range(3))
        ln = lengths.cuda()
        out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
        ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln)
        torch.cuda.synchronize()
        err_out = (out - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        if not (err_out <= KERNEL_ATOL and err_lse <= KERNEL_ATOL):
            raise AssertionError(f"flash kernel {name}: out err {err_out:.3g}, "
                                 f"lse err {err_lse:.3g} > {KERNEL_ATOL}")
        mask = (torch.arange(n, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
        iters = 5 if n > 1024 else 50
        calls = {
            "ms": lambda: tfa.masked_flash_attention_fwd(q, k, v, ln),
            "plain_ms": lambda: tfa.flash_attention_reference(q, k, v, ln),
            "library_ms": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask),
        }
        dev = {key: device_ms(fn, iters) for key, fn in calls.items()}
        call = {key: cuda_ms(fn, iters) for key, fn in calls.items()}
        flop_ms, byte_ms = flash_bound(b, 4, n, 32, lengths.tolist())
        cases[name] = dict(err=max(err_out, err_lse), flop_ms=flop_ms,
                           byte_ms=byte_ms, **dev)
        print(f"[kernel] flash_attention_fwd {name}: B={b} H=4 N={n} D=32 f32 "
              f"lengths 1..{n}: max_abs_err out={err_out:.3g} lse={err_lse:.3g} "
              f"(atol {KERNEL_ATOL}); device ms: kernel {dev['ms']:.4f}, plain "
              f"{dev['plain_ms']:.4f}, sdpa {dev['library_ms']:.4f}; per call "
              f"with host overhead: kernel {call['ms']:.4f}, plain "
              f"{call['plain_ms']:.4f}, sdpa {call['library_ms']:.4f}; bound "
              f"{max(flop_ms, byte_ms):.4f} (flops {flop_ms:.4f}, bytes "
              f"{byte_ms:.4f}) | {gpu}", flush=True)
    return cases


def serving_phase(torch, tfa, gpu):
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.synthetic import make_synthetic_store
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.serve import ServingSession
    from paths_tpu_torch.train.state import save_state

    cfg = Config.load(os.path.join(ROOT, "models", "brca_paths_0"), test_mode=True)
    cfg.preprocess_dir = os.path.join(WORK, "store")
    t0 = time.perf_counter()
    ids = make_synthetic_store(cfg.preprocess_dir, cfg, num_slides=32,
                               base_hw=(6, 8), seed=0)
    print(f"[slice] synthetic store: {len(ids)} slides, {cfg.num_levels} levels, "
          f"{cfg.model_config.patch_embed_dim}-d, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0))
    dirs = {}
    for impl in ("pallas", "xla"):
        cfg.attention_impl = impl
        dirs[impl] = os.path.join(WORK, f"model_{impl}")
        cfg.save(dirs[impl])
        save_state(dirs[impl], model)

    t0 = time.perf_counter()
    sess = ServingSession(dirs["pallas"], device="cuda")
    print(f"[slice] ServingSession (attention_impl=pallas) opened in "
          f"{time.perf_counter() - t0:.1f} s; batch_size {sess.batch_size}, "
          f"pads n0={sess._pads['n0']}", flush=True)
    requests = [ids[:1], ids[8:16], ids]

    tfa.masked_flash_attention_fwd.launches = 0
    rows, walls = [], []
    for req in requests + requests:     # a cold and a warm pass
        t0 = time.perf_counter()
        rows.append(sess.predict(req))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = tfa.masked_flash_attention_fwd.launches
    batches = 2 * len(requests)
    # one self-attention per decoder layer per level
    per_forward = cfg.model_config.trans_layers * cfg.num_levels
    if launches != per_forward * batches:
        raise AssertionError(f"flash kernel launched {launches} times for "
                             f"{batches} forward batches, want {per_forward} each")
    for req, wall, got in zip(requests + requests, walls, rows):
        haz = [h for r in got for h in r["hazards"]]
        if len(got) != len(req) or len(haz) != len(req) * cfg.nbins:
            raise AssertionError("prediction rows have the wrong shape")
        if not all(0.0 < h < 1.0 for h in haz):
            raise AssertionError(f"hazards outside (0, 1): {haz[:8]}")
        print(f"[slice] request of {len(req)} slides: {wall:.1f} ms wall | {gpu}",
              flush=True)
    print(f"[slice] flash kernel launches over {batches} forward batches: "
          f"{launches} ({per_forward} per forward)", flush=True)

    plain = ServingSession(dirs["xla"], device="cuda")
    worst = 0.0
    for req, got in zip(requests, rows):
        want = plain.predict(req)
        for a, b in zip(got, want):
            worst = max(worst, max(abs(x - y) for x, y in zip(a["hazards"],
                                                               b["hazards"])))
    if not worst <= PRED_ATOL:
        raise AssertionError(f"kernel path vs plain path: hazards differ by "
                             f"{worst:.3g} > {PRED_ATOL}")
    print(f"[slice] kernel path vs plain attention path: max |hazard diff| "
          f"{worst:.3g} (atol {PRED_ATOL})", flush=True)
    forward_breakdown(torch, sess, gpu)
    return launches


def forward_breakdown(torch, sess, gpu):
    """Collation and device time of one 32-slide forward on collated inputs,
    and the forward's top operations and kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch.data.dataset import collate_batch
    from paths_tpu_torch.serve import serving_forward

    idx = list(range(len(sess.slide_ids)))
    collate_ms = {}
    for device in ("cpu", "cuda"):     # host stacking alone, then with H2D
        t0 = time.perf_counter()
        bag, tables = collate_batch(sess._dataset, idx,
                                    level0_bucket=sess.config.level0_bucket,
                                    pads=sess._pads, device=device)
        torch.cuda.synchronize()
        collate_ms[device] = (time.perf_counter() - t0) * 1e3
    table_mb = sum(t.fts.numel() * t.fts.element_size() for t in tables) / 2**20

    def fwd():
        with torch.inference_mode():
            return serving_forward(sess.model, sess.config, bag, tables)

    ms = cuda_ms(fwd, iters=10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=25)
    busy_us = kernel_us(prof)
    print(f"[slice] 32-slide batch: collate on the host {collate_ms['cpu']:.1f} "
          f"ms, collate + copy to the card {collate_ms['cuda']:.1f} ms "
          f"({table_mb:.0f} MiB of table features); forward "
          f"{ms:.2f} ms between CUDA events; kernel time "
          f"in one profiled forward {busy_us / 1e3:.2f} ms (busy share "
          f"{busy_us / 1e3 / ms:.3f}) | {gpu}", flush=True)
    for line in table.splitlines():
        print(f"[profile] {line}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paths_tpu_torch.kernels import build
    from paths_tpu_torch.kernels import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    print(f"[env] {gpu}", flush=True)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build.build(build.SOURCES)
    print(f"[env] kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[env] {name}: {line.strip()}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    try:
        cases = kernel_phase(torch, tfa, gpu)
        launches = serving_phase(torch, tfa, gpu)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    # one serving forward of 32 slides: 2 launches at level 0, 8 deeper
    weights = {"level0": 2, "deeper": 8}

    def per_forward(key):
        return sum(w * cases[c][key] for c, w in weights.items())

    flop_ms, byte_ms = per_forward("flop_ms"), per_forward("byte_ms")
    kernels = [{
        "name": "masked_flash_attention_fwd",
        "route": "cuda",
        "source": "paths_tpu_torch/csrc/flash_attention.cu",
        "replaces": "paths_tpu/kernels/flash_attention.py:219",
        "launches": launches,
        "max_abs_err": max(cases[c]["err"] for c in cases),
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": per_forward("library_ms"),
    }]
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
