#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`paths_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. environment: the card's name and power limit, torch and CUDA versions,
     the build of every CUDA kernel from `paths_tpu_torch/csrc`, and the g++
     build of the two host libraries of `paths_tpu_torch/native` (the table
     builder, and the JPEG decoder where the host has libjpeg's headers);
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the serving and training paths give it and at one long bag,
     with errors, times, a PyTorch library call's time as a yardstick, and
     the least time the card could take for the same work; the backward
     kernels are also held to autograd through the plain forward; the
     forward also in bf16 at the ViT flash route's shapes (head_dim 64, the
     UNI, Virchow2 and Kaiko-B/8 token counts), where it rounds P as the TPU
     kernel does, with a planted fault (P left unrounded) that the check
     must fail;
  3. slice: a synthetic feature store and a randomly initialised model of the
     flagship `brca_paths_0` width are served through `ServingSession`; the
     launch counters show the serving path went through the forward kernel,
     the hazards are checked, and a session on the plain attention path must
     agree;
  4. train: a 64-slide synthetic signal store, and `brca_paths_0` at full
     width with attention dropout 0, trained for 2 epochs through
     `paths_tpu_torch.cli.train` on the kernel route and again on the plain
     route from the same weights; the launch counters show the training path
     went through all three kernels exactly as often as the code says, the
     two runs and one batch's gradients must agree, one step at the
     published dropout 0.05 must launch no kernel (as in the JAX package),
     and one step's time, memory and profile are printed;
  3b. streaming: the [slice] store served by a session on the streaming
     engine (requests of 1, 8 and 32 slides, cold then warm, no batch cache),
     held to the fused session's hazards, with the forward kernel's launches
     and where a 32-slide request's time goes (level-0 collation, then per
     level the device-to-host sync, the host gather and the copy back, and
     the bytes that crossed against the fused request's); one [train] batch
     through `StreamingEngine.loss_and_grad` against the fused backward (all
     three kernels launch once per decoder layer per level), its step time
     beside the fused step's, and one epoch of `cli.train` on the streaming
     engine held to the fused run's epoch-1 loss;
  3b'. bf16 (after streaming): the flagship in the bf16 configuration
     (`compute_dtype` and `table_dtype` "bfloat16") over the [slice] and
     [train] stores, which it reuses: whether cuBLAS's reduced-precision
     reduction changes the flagship's bf16 products; a 32-slide request on
     the fused and streaming engines, the kernel route's hazards against the
     plain route's, streaming equal to fused to the bit, #1's launches, each
     launch against its plain version, bytes to the card and warm request
     and forward times beside f32's; one [train] step at dropout 0, each
     launch of #1-#3 against its plain version, two planted faults that the
     check must fail, one epoch of `cli.train` on each route (launches,
     epoch loss kernel vs plain), and step time, busy share and peak memory
     beside f32's;
  3c. auto: `resolve_engine` picks fused from the card's memory for the
     [slice] store and streaming below the threshold; lru: a repeated
     32-slide request served from the device batch cache; cli:
     `cli.evaluate` and `cli.predict` on the [train] model directory, held to
     the test metrics `train_loop` logged and to the risk formula, and
     `cli.train --profile` writing a trace that names the flash kernels;
     staging: the 32-slide collation and copy into pageable and into
     page-locked memory, in turns;
  3d. remat: one [train] batch, two steps with `remat` on and off from the
     same weights (kernel route at dropout 0, plain route at the published
     0.05 with one generator, and a level-0 bag of 4096 patches): losses and
     gradients equal to the bit, kernel launches per step, step time and
     peak memory; ckpt: the [slice] and [train] models written as the
     reference's `model.pt` and read back by a `ServingSession` and
     `cli.evaluate` (equal to the bit to the npz route); http:
     `cli.serve.make_server` over the [slice] session, every route, a
     32-slide request against `session.predict`, its latency beside the
     session's own, and four concurrent clients; heatmap: a 24576-px raw
     blob slide through `cli.heatmap` with UNI on the fused encoder route
     (encoded on the fly at every depth, the processor on the flash kernel),
     its launches against what the code predicts, held to the plain
     attention route on the same features; `--slide-id` on the [slice] store
     against the session's forward; the int8 and fused1 encoders once each;
  3e. orbax (after ckpt): the [train] model and its AdamW state through
     `save_state(backend="orbax")` (`train/orbax.py`, no JAX) and back, equal
     to the bit; a session and `cli.evaluate` on directories holding only
     config.json and orbax/, equal to the npz route's; one epoch of
     `cli.train` under checkpoint_backend "orbax" against the npz run's; the
     committed JAX-written checkpoint `tests/fixtures/orbax_jax` (OCDBT,
     zstd) read through the host's libzstd (`native/zstd.py`), or the
     documented error where the host lacks it; export: `cli.export`
     (`paths_tpu_torch/export.py`) of the [slice] model as weights-as-args,
     frozen, symbolic-batch and CUDA + CPU artifacts, the operator
     `paths_torch::flash_attention_fwd` counted in each graph, a 32-slide
     request through `ServingSession(artifact=...)` (#1's launches, hazards
     against the live session, its warm time beside the live one's), the
     poly artifact at 8 and 32 slides, the CPU program against the CUDA one,
     a planted fault (an artifact at a small slide's pads must refuse the
     store), `cli.predict --artifact` and `cli.serve --artifact`;
  3f. dp (after export): data parallelism over two ranks or shards, one per
     card where the host has two, else both on cuda:0 (the ranks over gloo,
     passed explicitly: NCCL refuses two ranks on one card). dp-train: two
     `cli.train` processes (torchrun's environment, `mesh_shape: [2]`) over
     the [train] model directory from its initial weights for one epoch:
     the loss against the one-process run's epoch 1, the ranks' parameters
     equal to the bit, each rank's kernel launches against the code's count,
     step times beside the one-process step; dp-serve: the [slice] model
     behind a two-shard `ServingSession(mesh=...)`: hazards against the
     one-device session's, #1's launches per shard, the fused forward run
     under `torch.cuda.set_sync_debug_mode("error")` (it must not wait for
     the host, or the loop over shards would serialise them), the warm
     request beside the one-device one in turns, and `cli.serve
     --data-parallel 2` with one request;
  3g. seq (after dp-serve): sequence parallelism, `mesh_shape` [1, 2], two
     ranks on cuda:0 over gloo (the ring's exchange through page-locked host
     buffers), at flagship width on level-0 bags of 4096 patches (3 levels).
     seq-attn: both schedules (`parallel/seq_attention.py`) on #1-#3, f32
     and bf16, at B 2, H 4, N 4097 padded to 2 x 2049, D 32 with a valid
     prefix ending inside the second block: outputs and gradients against
     the one-device kernels, bf16 outputs and gradients also against the
     schedule's plain version, launches per rank against the code's count,
     and a planted fault (a ring step folded with the wrong block's length)
     that must be caught; seq-train: one step on each schedule whose
     world-summed gradients must equal one process's, `cli.train` for one
     epoch on each schedule against the one-process run of the same store
     (loss, the ranks' parameters to the bit, launches, step times), and
     one step at the published dropout 0.05 (plain route, no kernel,
     parameters to the bit, peak memory beside one process's); seq-eval:
     `cli.evaluate` under [1, 2] against one process (the c-index exactly,
     the loss to 1e-6);
  5. ViT block kernels: the fused attention, GELU-MLP and packed-SwiGLU-MLP
     block kernels against their plain versions at the UNI and Virchow2
     shapes (64 images), the attention and GELU-MLP blocks also at
     Kaiko-B/8's 785 tokens, one ragged small case and a SwiGLU case whose
     hidden width (160) is no multiple of 64, in f32 and bf16, with planted
     faults (the SwiGLU block's gate and value halves swapped among them)
     that the check must fail, their times, a
     yardstick made of PyTorch library calls, and their bounds; then the
     whole-block kernel and the int8 attention, GELU-MLP and packed-SwiGLU-MLP
     block kernels at the same shapes (the whole block, the int8 attention and
     the int8 GELU MLP also at Kaiko-B/8), the int8 ones with a check that
     allows for codes on the other side of a rounding boundary and three
     planted faults that it must fail (the int8 GELU MLP also bit for bit
     its plain version), and the int8 blocks' device time per piece
     (LN-quant, each GEMM, attention, quantisation) with their share of the
     bound;
  6. preprocess: two synthetic blob-on-white slides go through
     `paths_tpu_torch.cli.preprocess` with UNI at full width and depth in
     bf16 on the fused route and again on the plain route; the grids must
     agree and the launch counters must read what the code predicts. Then
     Virchow2 at full width and depth (fused against plain), one UNI batch on
     the flash route, and one f32 UNI batch with LayerScale 1 (fused against
     plain, with a planted fault), and the encode's time, busy share, memory
     and profile on every route, flash included. The `int8` and `fused1` routes go through the same CLI run
     and the same f32 batch, `fused1` also through the same Virchow2 batches
     (the published 16 heads of 80 with LayerScale 1, which `int8` and `flash`
     refuse), and `int8` through two batches of a Virchow2-sized SwiGLU ViT at
     20 heads of 64 (its #8 and #10 launches, and its cosine against the plain
     route). Last, one batch of
     Kaiko-B/8 (patch 8, 785 tokens) through `from_name` on the four routes;
  7. native (after heatmap): the native table builder equal to the numpy
     path on every (slide, level) of the [slice] store, and a cold 32-slide
     streaming request with each; tiles: the two slides written as JPEG-tiled
     pyramids and run through `cli.preprocess` with UNI on `fused` from a
     `--weights` file with one decode thread and with two decode processes
     (`-w 2`), grids equal to the bit, and host decode per batch with each
     decoder the host has; resnet: ResNet-50 through `cli.preprocess` from a
     random mirror's state dict, one batch's time and profile, ResNet-50 and
     -18 against the mirror on the card; verify: `cli.verify_conversion` for
     UNI at full depth on `fused` in f32 and for ResNet-50, and a planted
     fault in the converted encoder that the check must report;
     dp-preprocess (after tiles): the two slides through `cli.preprocess`
     with UNI from the [tiles] weights on one device and with
     `--data-shards 2` on `fused` and `int8`: grids against the one-device
     run, launches against the code's count, patches/s;
  8. examples (after verify): the port's end-to-end entry points.
     `paths_tpu_torch.examples.run_synthetic_demo` at its defaults (10 raw
     slides through verify_conversion, preprocess with kaiko-vits16, train,
     evaluate, predict, heatmap, export and an HTTP request to the
     artifact), each stage's launches of #1-#5 against `DEMO_STAGES`; then
     `examples.flagship_dress_rehearsal` for 2 epochs on its 48 slides at
     full width (training at the published dropout 0.05 on the plain route,
     every evaluation on #1), #1's launches against the code's count, and
     the trained model's val hazards on the kernel route against the plain
     route on the same weights.
The line before the last is a JSON object of per-kernel numbers, and the
last line is `{"ok": true, "device": {...}}`. Any failed check raises, so
the script exits non-zero and prints no result; without a CUDA device it
exits with code 2.
"""
from __future__ import annotations

import contextlib
import json
import math
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
# The flash forward in bf16 (the ViT flash route) vs plain: both round P to
# bf16 at the same points, so outputs differ only where f32 summation order
# or the kernel's fast exp moves a rounding: within torch's bf16 tolerance,
# and at most this share of the outputs differs at all (a kernel that left P
# unrounded would differ in about a third of them; measured on the CPU, the
# plain version differs from the Pallas kernel in 0.03-0.08%).
FLASH_BF16_CHANGED = 0.01
# A P whose rounding flips moves its row's outputs by a bf16 step of that P
# times |v| / l: each output is held to 2 bf16 ulps of its row's largest
# output (the ViT kernels' bf16 bar, taken per row).
FLASH_BF16_ULPS = 2
# Backward kernels vs plain and vs autograd through the plain forward, all
# f32, held relative to the largest gradient: max |kernel - ref| <= BWD_RTOL
# * max(1, max |ref|). A gradient sums up to N (4096) terms, and the flash
# formulation (P rebuilt from lse, dS = P (dP - rowsum(dO O))) cancels: on
# the CPU against an f64 reference its f32 error is 7e-7 of the largest
# gradient at N = 257 and 2.3e-5 at N = 4096 (autograd through the softmax:
# 4e-7), so 1e-4 leaves room for a second summation order.
BWD_RTOL = 1e-4
# Hazards through the kernel vs the plain attention path: the per-layer
# differences above pass through 2 decoder layers at each of 5 levels and
# the residual slide context between levels.
PRED_ATOL = 1e-4
# One batch's gradients through the kernels vs the plain route, from the
# same weights: each tensor is held to its own largest gradient, max |kernel
# - plain| <= GRAD_RTOL * max |plain|, as the backward kernels are above.
# Key-projection biases are the exception: softmax ignores a shift of a
# row's scores, so their gradient is 0 in exact arithmetic and what either
# route computes there is rounding noise; they are held to the largest
# gradient of the model instead. Planted faults in the backward kernels'
# results (dq scaled by 1 + 1e-3, dk zeroed) must fail this check.
GRAD_RTOL = 1e-4
# Two training runs through the kernels vs the plain route, from the same
# weights on the same batches: losses relative, c-indices absolute. The
# runs differ by summation order only (3e-8 relative on the H100). The loss
# check holds the forward kernel through training; it cannot see a wrong
# backward, since 4 AdamW steps at lr 2e-5 move each weight by about lr
# whatever the gradient's size: the gradient check above holds the
# backward. A c-index moves only when two predictions swap order.
LOSS_RTOL = 1e-5
CINDEX_ATOL = 0.02


# Peak dense bf16 rate of the tensor cores (same data sheet).
PEAK_BF16_FLOPS = 989e12
# Fused ViT block kernels vs their plain versions. f32 (TF32 off): both sum up
# to 6912 f32 terms in different orders into outputs of size up to about 10;
# the JAX tests hold 3e-5 on O(1) activations at widths of 32, and the widths
# here are 30-200 times that. bf16: kernel and plain version round at the same
# places, so they differ where a sum lands on the other side of a rounding
# boundary: 2 bf16 ulps of the largest output (an ulp is 2^-8 of the value).
VIT_F32_ATOL = 1e-4
VIT_BF16_ULPS = 2
# Feature grids of the fused route vs the plain route in bf16, per tissue
# cell, as |fused - plain|_2 / |plain|_2. The two routes round the branch at
# different places (the plain route after every op, the kernels only where
# the TPU kernels do), a bf16 rounding is 2^-8 = 4e-3, and a ViT without
# LayerScale would pass such differences through all its blocks.
FEATURE_RTOL_BF16 = 5e-2
# One f32 UNI batch (TF32 off) with LayerScale 1, fused vs plain route:
# max |diff| over features of size O(1) after 24 blocks, each adding a few
# 1e-6 of summation-order error. A planted fault (every other entry of one
# block's fc2 bias moved by 0.02) must fail it.
FEATURE_ATOL_F32 = 5e-4
# Peak dense int8 rate of the tensor cores (same data sheet).
PEAK_INT8_OPS = 1979e12
# Int8 block kernels vs their plain versions. Integer sums are exact and the
# LayerNorm before a quantisation is evaluated in f64, so the two agree to f32
# summation order (the tight bar: VIT_F32_ATOL, or VIT_BF16_ULPS of the
# largest output) except where a context or hidden value, an f32 sum taken in
# another order, lands on the other side of a rounding boundary: that moves
# one int8 code, and the row's outputs by at most one output quantum (one code
# step of the block's last quantisation times the largest weight and
# LayerScale; about 1e-3). Through the attention it also moves the other rows
# of the image, by about 1/N of that, far inside the tight bar. A value lies
# within an ulp of a boundary about once in 1e5, so of UNI's 12,608 rows about
# a hundred hold such a code: predicted share of rows outside the tight bar
# 0.2% (f32; in bf16 a quantum is below the tight bar), allowed 2%; no row may
# be off by more than 8 quanta (a row with several moved codes). Planted
# faults that must fail: round-half-up in place of half-even (on inputs whose
# LayerNorm output lies on exact ties), the weight scale of one output channel
# dropped, and a whole-row hidden scale where a per-chunk one is due.
# In bf16 an output's ulp (2^-8 of its size, 0.03 at 4) is above a quantum, so
# the two bars above cannot see an error of a few quanta there (the wrong
# hidden scale moves outputs by about 0.01). But kernel and plain version
# round the same f32 values, so nearly every bf16 output is the same to the
# bit, while an error of a third of an ulp rounds a third of them elsewhere:
# in bf16 at most 1% of the output elements may differ at all (predicted:
# under 0.1%).
I8_FLIP_SHARE = 0.02
I8_LOOSE_QUANTA = 8.0
I8_BF16_CHANGED = 0.01
# Feature grids of the int8 route vs the plain route in bf16: the
# quantisation error itself. The JAX package holds it to 5e-2 of the largest
# feature and a cosine above 0.999 for a 12-block random encoder; a 32-block
# encoder without LayerScale would add about 1e-2 a block.
FEATURE_RTOL_INT8 = 1e-1
FEATURE_COS_INT8 = 0.99
# One f32 UNI batch with LayerScale 1 on the int8 route, kernels vs plain
# versions: a moved code changes a row by about 1e-3, after which later
# blocks' codes of that image differ freely, so after 24 blocks the two runs
# are two draws of the same quantisation noise and differ by about as much as
# either differs from the float route (measured on the H100: 0.098 on
# features up to 3.9), not by summation order. The bar is therefore taken
# from the run itself: max |kernels - plain versions| may be at most
# FEATURE_INT8_SELF times max |kernels - float route|, the quantisation noise.
# The [kernel] lines above are the check with power for a single kernel; this
# one holds the route's wiring. A planted fault (the scale of one fc2 output
# channel of block 12 set to 1) must fail it.
FEATURE_INT8_SELF = 2.0


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


def device_ms(fn, iters: int, attempts: int = 3) -> float:
    """Mean device time of one call: the summed time of the kernels it
    launched, from the profiler's CUDA trace. A trace that holds no kernel
    at all is taken again, up to `attempts` times: on the H100 one trace of
    20 calls of a kernel launched through ctypes once came back empty, though
    the kernel ran (its result was checked) and the next case's trace held
    its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = kernel_us(prof)
        if us > 0:
            break
    return us / 1e3 / iters


def kernel_us(prof) -> float:
    """Summed device time of the kernels in a trace. User annotations (such
    as the optimizer's step range) also appear on the device's timeline and
    overlap the kernels they enclose; they are left out, as the profiler's
    own total leaves them out."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.is_user_annotation)


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

    # the ViT flash route's shapes: bf16, head_dim 64, every token valid,
    # JAX's key block min(256, 128 ceil(N / 128)); 64 images of UNI,
    # Virchow2's 261 tokens (at 20 heads of 64: the kernel takes no 80) and
    # Kaiko-B/8
    for name, b, h, n in (("uni", 64, 16, 197), ("virchow2-20x64", 64, 20, 261),
                          ("kaiko-b8", 64, 12, 785)):
        block_k = min(256, 128 * -(-n // 128))
        q, k, v = (torch.randn(b, h, n, 64, generator=gen).cuda().bfloat16()
                   for _ in range(3))
        ln = torch.full((b,), n, dtype=torch.int32, device="cuda")
        out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln, block_k)
        ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln, block_k)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        diff = (out.float() - ref_out.float()).abs()
        row = ref_out.float().abs().amax(-1, keepdim=True)
        ulps = (diff / torch.ldexp(torch.ones_like(row),
                                   torch.frexp(row).exponent - 8)).max().item()
        err = diff.max().item()
        changed = (out != ref_out).float().mean().item()
        # outputs outside torch's elementwise bf16 tolerance (reported)
        outside = int((diff > 1e-5 + 1.6e-2 * ref_out.float().abs()).sum())
        if not ulps <= FLASH_BF16_ULPS:
            raise AssertionError(f"flash kernel {name} bf16: an output differs by "
                                 f"{ulps:.3g} bf16 ulps of its row's largest")
        del diff
        # planted fault: P left unrounded (the port before it rounded P as
        # the TPU kernel does) must fail the share of changed outputs
        unrounded = tfa.flash_attention_reference(
            q.float(), k.float(), v.float(), ln)[0].bfloat16()
        fault = (out != unrounded).float().mean().item()
        if not (changed <= FLASH_BF16_CHANGED < fault):
            raise AssertionError(f"flash kernel {name} bf16: {changed:.4f} of the "
                                 f"outputs differ (allowed {FLASH_BF16_CHANGED}), "
                                 f"unrounded P differs in {fault:.4f}")
        del unrounded, ref_out
        calls = {
            "ms": lambda: tfa.masked_flash_attention_fwd(q, k, v, ln, block_k),
            "plain_ms": lambda: tfa.flash_attention_reference(q, k, v, ln, block_k),
            "library_ms": lambda: F.scaled_dot_product_attention(q, k, v),
        }
        dev = {key: device_ms(fn, 10) for key, fn in calls.items()}
        flop_ms = 4.0 * b * h * n * n * 64 / PEAK_BF16_FLOPS * 1e3
        byte_ms = (2.0 * 4 * b * h * n * 64 + 4.0 * b * h * n + 4 * b) / PEAK_BYTES * 1e3
        print(f"[kernel] flash_attention_fwd vit {name}: B={b} H={h} N={n} D=64 bf16 "
              f"block_k {block_k}: max_abs_err out={err:.3g}, worst {ulps:.3g} bf16 "
              f"ulps of its row's largest output (allowed {FLASH_BF16_ULPS}), "
              f"{outside} of {out.numel()} outputs outside torch's elementwise "
              f"bf16 tolerance, {changed:.5f} of the outputs differ (allowed "
              f"{FLASH_BF16_CHANGED}); planted fault (P unrounded) {fault:.4f}: "
              f"caught; device ms: kernel {dev['ms']:.4f}, plain "
              f"{dev['plain_ms']:.4f}, sdpa {dev['library_ms']:.4f}; bound "
              f"{max(flop_ms, byte_ms):.4f} (flops {flop_ms:.4f}, bytes "
              f"{byte_ms:.4f}), share of the bound "
              f"{max(flop_ms, byte_ms) / dev['ms']:.4f} | {gpu}", flush=True)
    return cases


def flash_bwd_bound(b, h, nq, nk, d, lengths):
    """{"dq": (flop-limited ms, byte-limited ms), "dkv": (...)} of the two
    backward passes on these inputs. Products over the valid keys only, 2
    flops per multiply-add: dq = 3 (S, dP, dS K), dk/dv = 4 (S, dP, P^T dO,
    dS^T Q), so 14 H Nq D sum(len) in all. Bytes (f32): the dq pass reads
    q, O and dO over every row, k and v over the valid rows, lse, and
    writes dq and delta; the dk/dv pass reads q and dO over every row, k
    and v over the valid rows, lse and delta, and writes dk and dv over
    every row."""
    valid = sum(lengths)
    rows_q, rows_k, vec = b * h * nq * d, b * h * nk * d, b * h * nq
    kv = 2 * h * valid * d
    out = {}
    for name, mults, nbytes in (
            ("dq", 3, 4.0 * (4 * rows_q + kv + 2 * vec + b)),
            ("dkv", 4, 4.0 * (2 * rows_q + kv + 2 * vec + 2 * rows_k + b))):
        flops = 2.0 * mults * h * nq * d * valid
        out[name] = (flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)
    return out


def backward_kernel_phase(torch, tfa, gpu):
    """Kernels #2 (dq) and #3 (dk/dv) against their plain versions and
    against autograd through the plain forward, at the training shapes and
    one long bag; device times of each kernel, its plain version and the
    backward of SDPA with a boolean mask."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    cases = {}
    for name, b, n in (("level0", 32, 257), ("deeper", 32, 81), ("long", 2, 4096)):
        lengths = torch.randint(1, n + 1, (b,), generator=gen, dtype=torch.int32)
        lengths[0], lengths[-1] = 1, n
        q, k, v, dout = (torch.randn(b, 4, n, 32, generator=gen).cuda()
                         for _ in range(4))
        ln = lengths.cuda()
        out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
        dq, delta = tfa.masked_flash_attention_bwd_dq(q, k, v, ln, out, lse, dout)
        dk, dv = tfa.masked_flash_attention_bwd_dkv(q, k, v, ln, lse, dout, delta)
        plain_dq, plain_delta = tfa.flash_bwd_dq_reference(q, k, v, ln, out, lse,
                                                           dout)
        plain_dk, plain_dv = tfa.flash_bwd_dkv_reference(q, k, v, ln, lse, dout,
                                                         plain_delta)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(
            tfa.flash_attention_reference(*leaves, ln)[0], leaves, dout)
        torch.cuda.synchronize()
        errs = {}
        for key, got, plain, ag in (("dq", dq, plain_dq, auto[0]),
                                    ("dk", dk, plain_dk, auto[1]),
                                    ("dv", dv, plain_dv, auto[2])):
            for ref_name, ref in (("plain", plain), ("autograd", ag)):
                err = (got - ref).abs().max().item()
                tol = BWD_RTOL * max(1.0, ref.abs().max().item())
                if not err <= tol:
                    raise AssertionError(f"flash backward {name} {key} vs "
                                         f"{ref_name}: err {err:.3g} > {tol:.3g}")
            errs[key] = (got - plain).abs().max().item()
            masked = (torch.arange(n, device="cuda")[None, :] >= ln[:, None])
            if key != "dq" and got.permute(0, 2, 1, 3)[masked].abs().max() != 0:
                raise AssertionError(f"flash backward {name}: masked-key {key} "
                                     "is not exactly 0")
        mask = (torch.arange(n, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
        sq, sk, sv = (t.clone().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
        iters = 3 if n > 1024 else 30
        calls = {
            "dq_ms": lambda: tfa.masked_flash_attention_bwd_dq(
                q, k, v, ln, out, lse, dout),
            "dkv_ms": lambda: tfa.masked_flash_attention_bwd_dkv(
                q, k, v, ln, lse, dout, delta),
            "plain_dq_ms": lambda: tfa.flash_bwd_dq_reference(
                q, k, v, ln, out, lse, dout),
            "plain_dkv_ms": lambda: tfa.flash_bwd_dkv_reference(
                q, k, v, ln, lse, dout, plain_delta),
            "library_ms": lambda: torch.autograd.grad(
                sdpa_out, (sq, sk, sv), dout, retain_graph=True),
        }
        dev = {key: device_ms(fn, iters) for key, fn in calls.items()}
        bound = flash_bwd_bound(b, 4, n, n, 32, lengths.tolist())
        cases[name] = dict(err_dq=errs["dq"], err_dkv=max(errs["dk"], errs["dv"]),
                           bound=bound, **dev)
        print(f"[kernel] flash_attention_bwd {name}: B={b} H=4 N={n} D=32 f32 "
              f"lengths 1..{n}: max_abs_err dq={errs['dq']:.3g} "
              f"dk={errs['dk']:.3g} dv={errs['dv']:.3g} (vs plain and vs "
              f"autograd, rtol {BWD_RTOL} of the largest gradient); device ms: "
              f"dq kernel {dev['dq_ms']:.4f}, dk/dv kernel {dev['dkv_ms']:.4f}, "
              f"plain dq {dev['plain_dq_ms']:.4f}, plain dk/dv "
              f"{dev['plain_dkv_ms']:.4f}, sdpa backward {dev['library_ms']:.4f}; "
              f"bound dq {max(bound['dq']):.4f} (flops {bound['dq'][0]:.4f}, "
              f"bytes {bound['dq'][1]:.4f}), dk/dv {max(bound['dkv']):.4f} "
              f"(flops {bound['dkv'][0]:.4f}, bytes {bound['dkv'][1]:.4f}) "
              f"| {gpu}", flush=True)
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
    # cache_batches=0: the warm pass repeats the cold pass's requests and
    # must measure the path, not the device batch cache ([lru] measures it)
    sess = ServingSession(dirs["pallas"], cache_batches=0, device="cuda")
    print(f"[slice] ServingSession (attention_impl=pallas) opened in "
          f"{time.perf_counter() - t0:.1f} s; batch_size {sess.batch_size}, "
          f"pads n0={sess._pads['n0']}", flush=True)
    requests = [ids[:1], ids[8:16], ids]

    reset_counts(tfa)
    rows, walls = [], []
    for req in requests + requests:     # a cold and a warm pass
        t0 = time.perf_counter()
        rows.append(sess.predict(req))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = tfa.masked_flash_attention_fwd.launches
    if tfa.masked_flash_attention_bwd_dq.launches or \
            tfa.masked_flash_attention_bwd_dkv.launches:
        raise AssertionError(f"serving launched backward kernels: "
                             f"{launch_counts(tfa)}")
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

    plain = ServingSession(dirs["xla"], cache_batches=0, device="cuda")
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
    return {"cfg": cfg, "ids": ids, "dirs": dirs, "sess": sess,
            "requests": requests, "rows": rows, "walls": walls}


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


def launch_counts(tfa):
    return {f.__name__: f.launches for f in (
        tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
        tfa.masked_flash_attention_bwd_dkv)}


def reset_counts(tfa):
    for f in (tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
              tfa.masked_flash_attention_bwd_dkv):
        f.launches = 0


def expected_train_launches(cfg, splits):
    """Kernel launches of one `cli.train` run on the kernel route, from the
    code: every batch is padded to the batch width; each forward launches
    the forward kernel once per decoder layer per level (cross-attention
    runs over an empty memory and launches nothing), each train step the two
    backward kernels as often; val runs every `eval_epochs`, test once."""
    bs = cfg.batch_size[0]
    n_train, n_val, n_test = (len(d) if d is not None else 0 for d in splits)
    steps = math.ceil(n_train / bs) * cfg.num_epochs
    val_passes = cfg.num_epochs // cfg.eval_epochs if n_val else 0
    forwards = steps + val_passes * math.ceil(n_val / bs) + math.ceil(n_test / bs)
    per = cfg.model_config.trans_layers * cfg.num_levels
    return {"masked_flash_attention_fwd": per * forwards,
            "masked_flash_attention_bwd_dq": per * steps,
            "masked_flash_attention_bwd_dkv": per * steps}


def training_phase(torch, tfa, gpu):
    from paths_tpu_torch.cli.train import main as train_main
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import load_splits
    from paths_tpu_torch.data.synthetic import (
        make_signal_metadata,
        make_signal_store,
    )
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.state import save_state

    cfg = Config.load(os.path.join(ROOT, "models", "brca_paths_0"), test_mode=True)
    published_dropout = cfg.model_config.dropout
    cfg.preprocess_dir = os.path.join(WORK, "train_store")
    cfg.csv_path = os.path.join(WORK, "train_meta.csv")
    cfg.hipt_splits = False
    cfg.num_epochs = 2
    cfg.model_config.dropout = 0.0
    t0 = time.perf_counter()
    ids, z = make_signal_store(cfg.preprocess_dir, cfg, num_slides=64,
                               base_hw=(6, 8), seed=0)
    make_signal_metadata(cfg.csv_path, ids, z, seed=0)
    print(f"[train] signal store: {len(ids)} slides, {cfg.num_levels} levels, "
          f"{cfg.model_config.patch_embed_dim}-d, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0))
    dirs = {}
    for impl in ("pallas", "xla"):
        cfg.attention_impl = impl
        dirs[impl] = os.path.join(WORK, f"train_{impl}")
        cfg.save(dirs[impl])
        save_state(dirs[impl], model)
    cfg.attention_impl = "pallas"
    splits = load_splits([0.7, 0.15, 0.15], cfg.seed, cfg)
    want = expected_train_launches(cfg, splits)

    runs, counts = {}, {}
    for impl in ("pallas", "xla"):
        reset_counts(tfa)
        t0 = time.perf_counter()
        runs[impl] = train_main(["-m", dirs[impl], "--no-wandb"])
        torch.cuda.synchronize()
        counts[impl] = launch_counts(tfa)
        print(f"[train] cli.train attention_impl={impl}: {cfg.num_epochs} "
              f"epochs over {len(splits[0])}/{len(splits[1])}/"
              f"{len(splits[2])} train/val/test slides in "
              f"{time.perf_counter() - t0:.1f} s; train_loss "
              f"{runs[impl]['train_loss']}; kernel launches {counts[impl]} "
              f"| {gpu}", flush=True)
    if counts["pallas"] != want:
        raise AssertionError(f"kernel route launched {counts['pallas']}, the "
                             f"code says {want}")
    if any(counts["xla"].values()):
        raise AssertionError(f"plain route launched kernels: {counts['xla']}")

    finals = {}
    for impl, d in dirs.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            finals[impl] = json.loads(f.read().splitlines()[-1])
    worst = {"loss": 0.0, "c-index": 0.0}
    for e in range(1, cfg.num_epochs + 1):
        pairs = [(runs["pallas"]["train_loss"][e], runs["xla"]["train_loss"][e],
                  runs["pallas"]["train_c-index"][e],
                  runs["xla"]["train_c-index"][e])]
        if e in runs["pallas"].get("val_loss", {}):
            pairs.append((runs["pallas"]["val_loss"][e], runs["xla"]["val_loss"][e],
                          runs["pallas"]["val_c-index"][e],
                          runs["xla"]["val_c-index"][e]))
        for lp, lx, cp, cx in pairs:
            worst["loss"] = max(worst["loss"], abs(lp - lx) / abs(lx))
            worst["c-index"] = max(worst["c-index"], abs(cp - cx))
    worst["loss"] = max(worst["loss"], abs(finals["pallas"]["test_loss"]
                                           - finals["xla"]["test_loss"])
                        / abs(finals["xla"]["test_loss"]))
    worst["c-index"] = max(worst["c-index"], abs(finals["pallas"]["test_c-index"]
                                                 - finals["xla"]["test_c-index"]))
    if not (worst["loss"] <= LOSS_RTOL and worst["c-index"] <= CINDEX_ATOL):
        raise AssertionError(f"kernel vs plain training runs differ: {worst}")
    for name, value in finals["pallas"].items():
        if name != "epoch" and not math.isfinite(value):
            raise AssertionError(f"non-finite final metric {name}: {value}")
    print(f"[train] kernel route vs plain route: worst relative loss diff "
          f"{worst['loss']:.3g} (rtol {LOSS_RTOL}), worst c-index diff "
          f"{worst['c-index']:.3g} (atol {CINDEX_ATOL}); final test metrics "
          f"kernel {finals['pallas']}, plain {finals['xla']}", flush=True)

    step_ms = step_checks(torch, tfa, gpu, cfg, dirs, splits, published_dropout)
    return counts["pallas"], {"cfg": cfg, "dirs": dirs, "splits": splits,
                              "model": model, "runs": runs, "step_ms": step_ms,
                              "published_dropout": published_dropout}


@contextlib.contextmanager
def planted_fault(tfa, fault, *modules):
    """While inside, the backward kernels' (dq, dk, dv) pass through
    `fault` on their way to autograd (also where `modules` call them)."""
    bwd = tfa.masked_flash_attention_bwd
    with repointed((tfa, *modules), masked_flash_attention_bwd=(
            lambda *args: fault(*bwd(*args)))):
        yield


def grad_mismatch(got, want):
    """(worst ratio, tensor): over the tensors of `want`, max |got - want|
    over its limit (GRAD_RTOL of the tensor's own largest gradient, or of
    the model's for key-projection biases); above 1 fails."""
    if sorted(got) != sorted(want):
        raise AssertionError("the routes give gradients to different tensors")
    scale = max(g.abs().max().item() for g in want.values())
    worst = (-1.0, "")
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        ref = scale if name.endswith(".k.bias") else w.abs().max().item()
        tol = GRAD_RTOL * ref
        ratio = err / tol if tol > 0 else (0.0 if err == 0 else math.inf)
        worst = max(worst, (ratio, name))
    return worst


def step_checks(torch, tfa, gpu, cfg, dirs, splits, published_dropout):
    """On one training batch, from the same saved weights: the gradients of
    the kernel route and the plain route, and planted faults that the
    comparison must catch; a step at the published dropout (no kernel may
    launch, as in the JAX package); then time, memory and a profile of one
    warm step on the kernel route."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch.data.dataset import collate_batch, labels_on, union_pads
    from paths_tpu_torch.engine.hierarchy import end2end_loss
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import make_optimizer, make_step_fns
    from paths_tpu_torch.train.state import load_model

    train = splits[0]
    idx = list(range(cfg.batch_size[0]))
    pads = union_pads(*(d.global_pads() for d in splits if d is not None))
    bag, tables = collate_batch(train, idx, level0_bucket=cfg.level0_bucket,
                                pads=pads, device="cuda")
    labels = labels_on(train, idx, "cuda")
    init_dir = os.path.join(WORK, "train_init")
    shutil.copytree(dirs["xla"], init_dir)   # trained weights: a mid-run state

    def grads(impl):
        c = copy.deepcopy(cfg)
        c.attention_impl = impl
        model = load_model(init_dir, RecursiveModel(c)).cuda()
        loss, _ = end2end_loss(model, c, bag, tables, labels)
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()
                if p.grad is not None}

    plain = grads("xla")
    ratio, name = grad_mismatch(grads("pallas"), plain)
    if not ratio <= 1.0:
        raise AssertionError(f"one batch's gradients differ between routes: "
                             f"{name} at {ratio:.3g} x its limit")
    print(f"[train] one batch, kernel route vs plain route over {len(plain)} "
          f"tensors: worst |grad diff| {ratio:.3g} x its limit (rtol "
          f"{GRAD_RTOL} of each tensor's largest gradient), at {name}",
          flush=True)
    faults = {"dq scaled by 1.001": lambda dq, dk, dv: (dq * 1.001, dk, dv),
              "dk zeroed": lambda dq, dk, dv: (dq, torch.zeros_like(dk), dv)}
    for label, fault in faults.items():
        with planted_fault(tfa, fault):
            ratio, name = grad_mismatch(grads("pallas"), plain)
        if not ratio > 1.0:
            raise AssertionError(f"the gradient check passes a planted fault "
                                 f"({label}): {ratio:.3g} x its limit")
        print(f"[train] planted fault, {label}: the gradient check fails, "
              f"worst {ratio:.3g} x its limit at {name}", flush=True)

    c = copy.deepcopy(cfg)
    c.model_config.dropout = published_dropout
    model = load_model(init_dir, RecursiveModel(c)).cuda()
    update, _ = make_step_fns(c, make_optimizer(c, model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(1)
    reset_counts(tfa)
    loss, _ = update(model, bag, tables, labels, gen, epoch=1)
    torch.cuda.synchronize()
    if any(launch_counts(tfa).values()) or not math.isfinite(loss.item()):
        raise AssertionError(f"dropout {published_dropout} step: launches "
                             f"{launch_counts(tfa)}, loss {loss.item()}")
    print(f"[train] one step at the published dropout {published_dropout} "
          f"with attention_impl=pallas: loss {loss.item():.4f}, kernel "
          f"launches {launch_counts(tfa)} (the plain route, as in JAX)",
          flush=True)

    model = load_model(init_dir, RecursiveModel(cfg)).cuda()
    update, _ = make_step_fns(cfg, make_optimizer(cfg, model.parameters()))

    def step():
        return update(model, bag, tables, labels, None, epoch=1)

    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    collate_ms = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        collate_batch(train, idx, level0_bucket=cfg.level0_bucket, pads=pads,
                      device=device)
        torch.cuda.synchronize()
        collate_ms[device] = (time.perf_counter() - t0) * 1e3
    step_ms = cuda_ms(step, iters=5, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    busy_us = kernel_us(prof)
    flash_us = {name: sum(e.self_device_time_total for e in prof.key_averages()
                          if e.device_type.name == "CUDA" and name in e.key)
                for name in ("flash_fwd_", "flash_bwd_dq_kernel",
                             "flash_bwd_dkv_kernel")}
    print(f"[train] warm step of {len(idx)} slides (forward + backward + "
          f"AdamW): {min(walls):.1f} ms wall (of {', '.join(f'{w:.1f}' for w in walls)}) "
          f"| {gpu}", flush=True)
    print(f"[train] collate one batch on the host {collate_ms['cpu']:.1f} ms, "
          f"collate + copy to the card {collate_ms['cuda']:.1f} ms | {gpu}",
          flush=True)
    print(f"[train] forward + backward + optimizer {step_ms:.2f} ms between "
          f"CUDA events | {gpu}", flush=True)
    print(f"[train] kernel time of one profiled step {busy_us / 1e3:.2f} ms "
          f"(busy share {busy_us / 1e3 / step_ms:.3f}); flash kernels "
          + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in flash_us.items())
          + f" | {gpu}", flush=True)
    print(f"[train] torch.cuda.max_memory_allocated over one step "
          f"{peak_mib:.0f} MiB | {gpu}", flush=True)
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=25)
    for line in table.splitlines():
        print(f"[train-profile] {line}", flush=True)
    return min(walls)


# Streaming epoch-1 train loss vs the fused run's, relative: JAX's own bar
# for its streaming engine (`tests/test_streaming.py`). The two runs do the
# same operations on the same values; only where a level's children are
# gathered differs.
STREAM_EPOCH_RTOL = 2e-4
# cli.evaluate's test loss and metric vs the test entries `train_loop`
# logged for the same weights: the same forward over the same slides, with
# other padding (the CLI pads to its batch's own widths).
CLI_EVAL_RTOL = 1e-6
# cli.predict's risk vs -sum(cumprod(1 - hazards)) of its own hazards,
# printed to 6 decimals.
RISK_ATOL = 1e-4


def model_dir_copy(src, name, **changes):
    """A copy of model directory `src` under WORK with config fields set."""
    from paths_tpu_torch.config import Config

    dst = os.path.join(WORK, name)
    shutil.copytree(src, dst)
    cfg = Config.load(dst, test_mode=True)
    for key, value in changes.items():
        setattr(cfg, key, value)
    cfg.save(dst)
    return dst


@contextlib.contextmanager
def timed(torch, module, names, log):
    """While inside, each function `names` of `module` appends (name, ms,
    args, result) to `log`, its time taken up to a synchronised card."""
    real = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append((name, (time.perf_counter() - t0) * 1e3, args, out))
            return out
        return inner

    for n, fn in real.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


def shipped_bytes(host: dict, wire_size: int) -> int:
    """Bytes of a dict of host arrays as they cross to the card: features
    at the wire dtype's width, the rest as they are."""
    return sum(v.size * wire_size if k == "fts" else v.nbytes
               for k, v in host.items())


def streaming_serving_phase(torch, tfa, gpu, sl):
    """The [slice] store and weights served by a streaming session next to
    the fused one: the same requests cold then warm, no batch cache; the
    hazards against the fused session's, the forward kernel's launches, and
    where a 32-slide request's time goes."""
    import numpy as np

    from paths_tpu_torch.data.dataset import collate_bag0, collate_batch
    from paths_tpu_torch.engine import streaming
    from paths_tpu_torch.engine.tables import wire_dtype
    from paths_tpu_torch.serve import ServingSession

    cfg, ids, requests = sl["cfg"], sl["ids"], sl["requests"]
    sdir = model_dir_copy(sl["dirs"]["pallas"], "model_streaming",
                          engine="streaming")
    t0 = time.perf_counter()
    sess = ServingSession(sdir, cache_batches=0, device="cuda")
    print(f"[streaming] ServingSession (engine=streaming, attention_impl="
          f"pallas) opened in {time.perf_counter() - t0:.1f} s; level-0 pads "
          f"n0={sess._pads['n0']}", flush=True)

    reset_counts(tfa)
    rows, walls = [], []
    for req in requests + requests:     # a cold and a warm pass
        t0 = time.perf_counter()
        rows.append(sess.predict(req))
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts(tfa)
    per_forward = cfg.model_config.trans_layers * cfg.num_levels
    batches = 2 * len(requests)
    want = {"masked_flash_attention_fwd": per_forward * batches,
            "masked_flash_attention_bwd_dq": 0,
            "masked_flash_attention_bwd_dkv": 0}
    if counts != want:
        raise AssertionError(f"streaming serving launched {counts}, the code "
                             f"says {want}")
    worst = max(abs(x - y) for got, ref in zip(rows, sl["rows"])
                for a, b in zip(got, ref)
                for x, y in zip(a["hazards"], b["hazards"]))
    if not worst <= PRED_ATOL:
        raise AssertionError(f"streaming vs fused session: hazards differ by "
                             f"{worst:.3g} > {PRED_ATOL}")
    for i, (req, wall) in enumerate(zip(requests + requests, walls)):
        print(f"[streaming] request of {len(req)} slides "
              f"({'cold' if i < len(requests) else 'warm'}): {wall:.1f} ms "
              f"wall, fused session {sl['walls'][i]:.1f} ms | {gpu}", flush=True)
    print(f"[streaming] flash kernel launches over {batches} forward batches: "
          f"{counts['masked_flash_attention_fwd']} ({per_forward} per "
          f"forward, no backward); max |hazard diff| vs the fused session "
          f"{worst:.3g} (atol {PRED_ATOL})", flush=True)

    # where one warm 32-slide request's time goes
    idx = list(range(len(ids)))
    ds = sess._dataset
    wire = wire_dtype(np.float32, cfg.table_dtype).itemsize
    t0 = time.perf_counter()
    bag0 = collate_bag0(ds, idx, level0_bucket=cfg.level0_bucket,
                        pads=sess._pads, device="cuda")
    torch.cuda.synchronize()
    l0_ms = (time.perf_counter() - t0) * 1e3
    l0_bytes = bag0.fts.numel() * wire + bag0.locs.numel() * 4 + bag0.mask.numel()
    log = []
    t0 = time.perf_counter()
    with timed(torch, streaming, ("coords_to_host", "lookup_host",
                                  "ship_at_wire_dtype"), log), \
            torch.inference_mode():
        sess._eng.forward(sess.model, bag0, [ds.slides[i].tables for i in idx])
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    by_name = {n: [(ms, args, out) for name, ms, args, out in log if name == n]
               for n in ("coords_to_host", "lookup_host", "ship_at_wire_dtype")}
    stream_bytes = l0_bytes
    for lvl, (sync, gather, ship) in enumerate(zip(*by_name.values()), start=1):
        nbytes = shipped_bytes(gather[2], wire)
        stream_bytes += nbytes
        print(f"[streaming] 32-slide request, level {lvl - 1} -> {lvl}: "
              f"device-to-host sync {sync[0]:.2f} ms, host gather "
              f"{gather[0]:.2f} ms, copy to the card {ship[0]:.2f} ms "
              f"({nbytes / 2**20:.2f} MiB) | {gpu}", flush=True)
    bag, tables = collate_batch(sl["sess"]._dataset, idx,
                                level0_bucket=cfg.level0_bucket,
                                pads=sl["sess"]._pads, device="cpu")
    fused_bytes = fused_request_bytes(bag, tables, wire)
    del bag, tables
    # lookup_host gathers the slides one after another; the JAX package
    # spreads them over a pool of 8 threads: both on the level-1 coordinates
    # of this request, in turns
    from concurrent.futures import ThreadPoolExecutor

    locs, kvalid, level_tables = by_name["lookup_host"][0][1]
    one = [lambda j=j: streaming.lookup_host(locs[j:j + 1], kvalid[j:j + 1],
                                             level_tables[j:j + 1])
           for j in range(len(idx))]
    with ThreadPoolExecutor(8) as pool:
        variants = (("loop", lambda: streaming.lookup_host(locs, kvalid,
                                                           level_tables)),
                    ("pool of 8", lambda: list(pool.map(lambda f: f(), one))))
        gather = {name: [] for name, _ in variants}
        for name, fn in variants + variants[::-1]:
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            gather[name].append((time.perf_counter() - t0) * 100)
    print(f"[streaming] host gather of one level, 32 slides, ms per call in "
          f"turns: " + "; ".join(f"{k} {', '.join(f'{t:.2f}' for t in v)}"
                                 for k, v in gather.items()) + f" | {gpu}",
          flush=True)
    print(f"[streaming] 32-slide request: level-0 collate + copy {l0_ms:.1f} "
          f"ms ({l0_bytes / 2**20:.1f} MiB); forward with the per-level "
          f"gathers {fwd_ms:.1f} ms (timed pieces synchronised); bytes to the "
          f"card {stream_bytes / 2**20:.1f} MiB against the fused request's "
          f"{fused_bytes / 2**20:.1f} MiB | {gpu}", flush=True)
    return sess


def streaming_training_phase(torch, tfa, gpu, tr):
    """One [train] batch through `StreamingEngine.loss_and_grad` against the
    fused backward, its kernel launches and step time beside the fused
    step's; then one epoch of `cli.train` on the streaming engine from the
    [train] run's initial weights, held to the fused run's epoch-1 loss."""
    import copy

    from paths_tpu_torch.cli.train import main as train_main
    from paths_tpu_torch.data.dataset import collate_batch, labels_on, union_pads
    from paths_tpu_torch.engine.hierarchy import end2end_loss
    from paths_tpu_torch.engine.streaming import StreamingEngine
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import (
        make_optimizer,
        make_step_fns,
        optimizer_step,
    )
    from paths_tpu_torch.train.state import load_model, save_state

    cfg, splits, runs = tr["cfg"], tr["splits"], tr["runs"]
    train = splits[0]
    idx = list(range(cfg.batch_size[0]))
    pads = union_pads(*(d.global_pads() for d in splits if d is not None))
    bag, tables = collate_batch(train, idx, level0_bucket=cfg.level0_bucket,
                                pads=pads, device="cuda")
    labels = labels_on(train, idx, "cuda")
    host_tables = [train.slides[i].tables for i in idx]
    init_dir = os.path.join(WORK, "train_init")   # trained weights ([train])

    model = load_model(init_dir, RecursiveModel(cfg)).cuda()
    loss, _ = end2end_loss(model, cfg, bag, tables, labels, training=True)
    loss.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}
    eng = StreamingEngine(cfg, "cuda")
    reset_counts(tfa)
    got_loss, _, got = eng.loss_and_grad(model, bag, host_tables, labels)
    torch.cuda.synchronize()
    counts = launch_counts(tfa)
    per = cfg.model_config.trans_layers * cfg.num_levels
    if counts != dict.fromkeys(counts, per):
        raise AssertionError(f"a streaming train step launched {counts}, the "
                             f"code says {per} of each")
    rel = abs(got_loss.item() - loss.item()) / abs(loss.item())
    ratio, name = grad_mismatch(got, want)
    if not (rel <= LOSS_RTOL and ratio <= 1.0):
        raise AssertionError(f"streaming vs fused step: loss {rel:.3g} "
                             f"relative, gradients {ratio:.3g} x the limit at "
                             f"{name}")
    print(f"[streaming] one 32-slide train batch, streaming vs fused: loss "
          f"{rel:.3g} relative (rtol {LOSS_RTOL}), worst |grad diff| "
          f"{ratio:.3g} x its limit (rtol {GRAD_RTOL}) at {name}; kernel "
          f"launches {counts} (one forward: JAX's streaming step runs two)",
          flush=True)

    opt = make_optimizer(cfg, model.parameters())
    update, _ = make_step_fns(cfg, opt)

    def stream_step():
        eng.loss_and_grad(model, bag, host_tables, labels)
        optimizer_step(cfg, opt)

    def fused_step():
        update(model, bag, tables, labels, None, epoch=1)

    times = {}
    for label, fn in (("fused", fused_step), ("streaming", stream_step),
                      ("streaming ", stream_step), ("fused ", fused_step)):
        times[label] = cuda_ms(fn, iters=5, warmup=1)
    print(f"[streaming] train step of 32 slides between CUDA events, in turns: "
          + ", ".join(f"{k.strip()} {v:.2f} ms" for k, v in times.items())
          + f" | {gpu}", flush=True)
    del bag, tables

    c = copy.deepcopy(cfg)
    c.engine, c.num_epochs = "streaming", 1
    sdir = os.path.join(WORK, "train_streaming")
    c.save(sdir)
    save_state(sdir, tr["model"])
    reset_counts(tfa)
    t0 = time.perf_counter()
    stats = train_main(["-m", sdir, "--no-wandb"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(tfa)
    want = expected_train_launches(c, splits)
    if counts != want:
        raise AssertionError(f"streaming cli.train launched {counts}, the code "
                             f"says {want}")
    fused = runs["pallas"]["train_loss"][1]
    rel = abs(stats["train_loss"][1] - fused) / abs(fused)
    if not rel <= STREAM_EPOCH_RTOL:
        raise AssertionError(f"streaming epoch-1 train loss "
                             f"{stats['train_loss'][1]} vs fused {fused}: "
                             f"{rel:.3g} > {STREAM_EPOCH_RTOL} relative")
    print(f"[streaming] cli.train engine=streaming, 1 epoch: train_loss "
          f"{stats['train_loss'][1]:.6f} vs the fused run's {fused:.6f} "
          f"({rel:.3g} relative, rtol {STREAM_EPOCH_RTOL}); epoch wall "
          f"{stats['epoch_wall_s'][1]} s (fused {runs['pallas']['epoch_wall_s'][1]}"
          f" s), run {wall:.1f} s; kernel launches {counts} | {gpu}", flush=True)

# [bf16]: the flagship in the JAX package's bf16 configuration
# (`compute_dtype` and `table_dtype` "bfloat16") on the [slice] and [train]
# stores. u = 2^-8, bf16's unit roundoff: an ulp of a value is at most 2u of
# it.
# Hazards, kernel route vs plain attention route: the kernels round P
# against each key block's running max, the plain route after the softmax,
# so attention outputs differ by about an ulp; the output projection, the
# LayerNorms and the head carry a change to a logit at a gain of about 1,
# the logits of random flagship weights are below 2 in size, and the
# sigmoid's slope is at most 1/4: one change moves a hazard by at most
# 2u * 2 / 4 = u, and the bar admits four (on the CPU at width 64, the
# plain versions against the plain route: 1.3u). The step's loss: 4u
# relative.
BF16_PRED_ATOL = 4 * 2.0 ** -8
BF16_LOSS_RTOL = 4 * 2.0 ** -8
# Whole-model gradients are no yardstick in bf16: an ulp's change in an
# attention output flips ReLU masks and moves sums that cancel, so on the
# CPU the plain versions against the plain route differ by up to 27 times
# 4u of a tensor's own largest (164 of 247 tensors above it), and one-ulp
# changes planted in 0.5% of the kernels' outputs by up to 21 times. The
# step is held where the kernels are: every launch of the step against its
# plain version on the same inputs, outputs at the flash bf16 bar
# (FLASH_BF16_ULPS, FLASH_BF16_CHANGED) and dq, dk, dv at SEQ_BF16_GRAD_RTOL
# (4u) of their own largest. Planted faults that must fail it: dk zeroed,
# and dq scaled by 1.05 (above the 1.001 of [train], which is below an ulp).
BF16_FAULTS = {"dk zeroed": lambda dq, dk, dv: (dq, dk * 0, dv),
               "dq scaled by 1.05": lambda dq, dk, dv: (dq * 1.05, dk, dv)}


class Recorder:
    """A kernel wrapper that appends (args, results) of each call to `log`.
    The wrappers count their launches through their module names, so the
    count is the wrapped function's: read and written through."""

    def __init__(self, fn, log):
        self.fn, self.log, self.__name__ = fn, log, fn.__name__

    def __call__(self, *args):
        out = self.fn(*args)
        self.log.append((args, out))
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@contextlib.contextmanager
def recorded(tfa, *modules):
    """While inside, every call of the forward wrapper and of the backward
    pair (through the module's names, as the model calls them, and through
    the same names in `modules`: the sequence schedules import them) is
    recorded in the lists of the yielded dict; restored after."""
    log = {"fwd": [], "bwd": []}
    fwd, bwd = tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd
    with repointed((tfa, *modules),
                   masked_flash_attention_fwd=Recorder(fwd, log["fwd"]),
                   masked_flash_attention_bwd=Recorder(bwd, log["bwd"])):
        yield log


@contextlib.contextmanager
def repointed(modules, **names):
    """While inside, each of `names` in each of `modules` is the given
    object; restored after."""
    saved = [(m, n, getattr(m, n)) for m in modules for n in names]
    for m, n, _ in saved:
        setattr(m, n, names[n])
    try:
        yield
    finally:
        for m, n, old in saved:
            setattr(m, n, old)


def launch_agreement(tfa, log):
    """Each recorded launch against its plain version on the same inputs:
    (worst forward ulps of a row's largest output, worst share of changed
    forward outputs, worst backward ratio to SEQ_BF16_GRAD_RTOL of each
    gradient's own largest)."""
    ulps = changed = ratio = 0.0
    for (q, k, v, lengths, block_k), (out, _) in log["fwd"]:
        want = tfa.flash_attention_reference(q, k, v, lengths, block_k)[0]
        u, c = bf16_agreement(out.detach().float().cpu().numpy(),
                              want.float().cpu().numpy())
        ulps, changed = max(ulps, u), max(changed, c)
    for (q, k, v, lengths, out, lse, dout), grads in log["bwd"]:
        dq, delta = tfa.flash_bwd_dq_reference(q, k, v, lengths, out, lse, dout)
        want = (dq, *tfa.flash_bwd_dkv_reference(q, k, v, lengths, lse, dout,
                                                 delta))
        for g, w in zip(grads, want):
            tol = SEQ_BF16_GRAD_RTOL * w.float().abs().max().item()
            err = (g.detach().float() - w.float()).abs().max().item()
            ratio = max(ratio, err / tol if tol > 0 else
                        (0.0 if err == 0 else math.inf))
    return ulps, changed, ratio


def fused_request_bytes(bag, tables, wire: int) -> int:
    """Bytes of a collated fused batch as they cross to the card: features
    at the wire dtype's width, coordinates and index arrays as int32."""
    return (bag.fts.numel() * wire + bag.locs.numel() * 4 + bag.mask.numel()
            + sum(t.fts.numel() * wire + 4 * (t.locs.numel() + t.count.numel()
                  + t.index.numel() + t.grid_hw.numel()) for t in tables))


def cublas_bf16_probe(torch, gpu):
    """Share of bf16 GEMM outputs that differ from the product summed in f32
    and rounded once (JAX's `preferred_element_type=f32`), with cuBLAS's
    reduced-precision reduction allowed (torch's default) and not, at the
    flagship's bf16 products of a 32-slide level 0 (8224 rows): proj_in (K
    1024), the LSTM's packed gates (K 2048) and the feed-forward's second
    layer (K 512)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_bf16_reduced_precision_reduction
    gen = torch.Generator(device="cuda").manual_seed(0)
    shares = {}
    try:
        for m, k, n in ((8224, 1024, 128), (8224, 2048, 1792), (8224, 512, 128)):
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            w = torch.randn(n, k, device="cuda", generator=gen).bfloat16()
            exact = (x.float() @ w.float().t()).bfloat16()
            for allow in (True, False):
                flags.allow_bf16_reduced_precision_reduction = allow
                got = torch.nn.functional.linear(x, w)
                shares[(k, allow)] = (got != exact).float().mean().item()
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
    print("[bf16] cuBLAS bf16 GEMM outputs off the f32-summed product, "
          "reduced-precision reduction allowed / not: "
          + "; ".join(f"K {k}: {shares[(k, True)]:.5f} / {shares[(k, False)]:.5f}"
                      for k in (1024, 2048, 512)) + f" | {gpu}", flush=True)
    return shares


def bf16_phase(torch, tfa, gpu, sl, tr, stream_sess):
    """[bf16] (a): one 32-slide request on the fused and streaming engines,
    kernel route against the plain route, the engines to the bit, #1's
    launches and per-launch agreement, bytes to the card, warm request and
    forward times beside f32's. (b): one [train] step at dropout 0 on the
    kernel and plain routes, each launch of #1-#3 against its plain version,
    the planted faults, launches, and step time, busy share and peak memory
    beside f32's. `stream_sess` is [streaming]'s f32 session. Returns the
    kernel launches of the main-path runs."""
    import copy

    import numpy as np

    from paths_tpu_torch.data.dataset import (
        collate_bag0,
        collate_batch,
        labels_on,
        union_pads,
    )
    from paths_tpu_torch.engine import streaming
    from paths_tpu_torch.engine.hierarchy import end2end_loss
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.serve import ServingSession, serving_forward
    from paths_tpu_torch.train.loop import make_optimizer, make_step_fns
    from paths_tpu_torch.train.state import load_model
    from torch.profiler import ProfilerActivity, profile

    bf16 = dict(compute_dtype="bfloat16", table_dtype="bfloat16")
    cublas_bf16_probe(torch, gpu)
    ids, idx = sl["ids"], list(range(len(sl["ids"])))
    mains = {n: 0 for n in launch_counts(tfa)}

    def count(fn):
        reset_counts(tfa)
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts(tfa)
        for n, c in got.items():
            mains[n] += c
        return out, got

    # ---- (a) one 32-slide request
    pallas = sl["dirs"]["pallas"]
    sess = {"f32 fused": sl["sess"], "f32 streaming": stream_sess}
    for name, src, extra in (("bf16 fused", pallas, {}),
                             ("bf16 streaming", pallas, {"engine": "streaming"}),
                             ("bf16 plain", sl["dirs"]["xla"], {})):
        sess[name] = ServingSession(model_dir_copy(
            src, name.replace(" ", "_"), **bf16, **extra), cache_batches=0,
            device="cuda")
    per_forward = sl["cfg"].model_config.trans_layers * sl["cfg"].num_levels
    rows = {name: s.predict(ids) for name, s in sess.items()}   # cold
    with recorded(tfa) as log:
        rows["bf16 fused"], got = count(lambda: sess["bf16 fused"].predict(ids))
    rows["bf16 streaming"], got_s = count(
        lambda: sess["bf16 streaming"].predict(ids))
    want = {"masked_flash_attention_fwd": per_forward,
            "masked_flash_attention_bwd_dq": 0,
            "masked_flash_attention_bwd_dkv": 0}
    if got != want or got_s != want:
        raise AssertionError(f"a bf16 request launched {got} (fused), "
                             f"{got_s} (streaming); the code says {want}")
    ulps, changed, _ = launch_agreement(tfa, log)
    if not (ulps <= FLASH_BF16_ULPS and changed <= FLASH_BF16_CHANGED):
        raise AssertionError(f"a bf16 request's #1 launch against its plain "
                             f"version: {ulps:.3g} ulps, {changed:.5f} changed")
    hz = {n: np.array([r["hazards"] for r in v]) for n, v in rows.items()}
    worst = np.abs(hz["bf16 fused"] - hz["bf16 plain"]).max()
    if not worst <= BF16_PRED_ATOL:
        raise AssertionError(f"bf16 hazards, kernel vs plain route: {worst:.3g}"
                             f" > {BF16_PRED_ATOL}")
    if not np.array_equal(hz["bf16 fused"], hz["bf16 streaming"]):
        raise AssertionError("bf16 streaming hazards differ from the fused "
                             "engine's")
    if not np.all((hz["bf16 fused"] > 0) & (hz["bf16 fused"] < 1)):
        raise AssertionError("bf16 hazards outside (0, 1)")
    fwd_name = "masked_flash_attention_fwd"
    print(f"[bf16] 32-slide request, kernel route: #1 launched "
          f"{got[fwd_name]} times (fused) and {got_s[fwd_name]} "
          f"(streaming), each launch against its plain version: worst "
          f"{ulps:.3g} ulps of its row's largest (allowed {FLASH_BF16_ULPS}), "
          f"{changed:.5f} of the outputs changed (allowed "
          f"{FLASH_BF16_CHANGED}); hazards vs the plain route max |diff| "
          f"{worst:.3g} (atol {BF16_PRED_ATOL:.4g}); streaming equal to "
          f"fused to the bit; bf16 vs f32 hazards max |diff| "
          f"{np.abs(hz['bf16 fused'] - hz['f32 fused']).max():.3g}", flush=True)

    walls = {n: [] for n in ("f32 fused", "bf16 fused", "f32 streaming",
                             "bf16 streaming")}
    for _ in range(2):
        for name in walls:
            t0 = time.perf_counter()
            count(lambda: sess[name].predict(ids))
            walls[name].append((time.perf_counter() - t0) * 1e3)
    batches = {}
    for name in ("f32 fused", "bf16 fused"):
        s = sess[name]
        batches[name] = collate_batch(s._dataset, idx,
                                      level0_bucket=s.config.level0_bucket,
                                      pads=s._pads, device="cuda")
    nbytes = {}
    for name, wire in (("f32", 4), ("bf16", 2)):
        bag, tables = batches[f"{name} fused"]
        nbytes[f"{name} fused"] = fused_request_bytes(bag, tables, wire)
        s = sess[f"{name} streaming"]
        bag0 = collate_bag0(s._dataset, idx, level0_bucket=s.config.level0_bucket,
                            pads=s._pads, device="cuda")
        log = []
        with timed(torch, streaming, ("lookup_host",), log), \
                torch.inference_mode():
            s._eng.forward(s.model, bag0, [s._dataset.slides[i].tables
                                           for i in idx])
        nbytes[f"{name} streaming"] = (
            bag0.fts.numel() * wire + bag0.locs.numel() * 4
            + bag0.mask.numel() + sum(shipped_bytes(out, wire)
                                      for _, _, _, out in log))
    fwd_ms = {n: [] for n in batches}
    for _ in range(2):
        for name, (bag, tables) in batches.items():
            s = sess[name]

            def fwd():
                with torch.inference_mode():
                    return serving_forward(s.model, s.config, bag, tables)

            fwd_ms[name].append(cuda_ms(fwd, iters=10))
    for name in walls:
        print(f"[bf16] warm 32-slide request, {name}: "
              f"{', '.join(f'{w:.1f}' for w in walls[name])} ms wall in "
              f"turns; bytes to the card {nbytes[name] / 2**20:.1f} MiB"
              + (f"; forward {', '.join(f'{t:.2f}' for t in fwd_ms[name])} "
                 f"ms between CUDA events" if name in fwd_ms else "")
              + f" | {gpu}", flush=True)
    del batches, sess

    # ---- (b) one [train] step at dropout 0
    cfg32 = tr["cfg"]
    cfg16 = copy.deepcopy(cfg32)
    for key, value in bf16.items():
        setattr(cfg16, key, value)
    train = tr["splits"][0]
    sidx = list(range(cfg32.batch_size[0]))
    pads = union_pads(*(d.global_pads() for d in tr["splits"] if d is not None))
    step_batch = {
        name: collate_batch(train, sidx, level0_bucket=cfg32.level0_bucket,
                            pads=pads, device="cuda", dtype=dtype)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    labels = labels_on(train, sidx, "cuda")
    init_dir = os.path.join(WORK, "train_init")   # written by step_checks

    def step_loss(impl):
        c = copy.deepcopy(cfg16)
        c.attention_impl = impl
        model = load_model(init_dir, RecursiveModel(c)).cuda()
        loss, _ = end2end_loss(model, c, *step_batch["bf16"], labels)
        loss.backward()
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError("a bf16 step left a parameter off f32")
        return loss.item()

    with recorded(tfa) as log:
        loss_k, got = count(lambda: step_loss("pallas"))
    per = cfg16.model_config.trans_layers * cfg16.num_levels
    want = {n: per for n in got}
    if got != want:
        raise AssertionError(f"a bf16 step launched {got}; the code says {want}")
    loss_p = step_loss("xla")
    if not abs(loss_k - loss_p) <= BF16_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"bf16 step loss, kernel vs plain route: "
                             f"{loss_k} vs {loss_p}")
    ulps, changed, ratio = launch_agreement(tfa, log)
    if not (ulps <= FLASH_BF16_ULPS and changed <= FLASH_BF16_CHANGED
            and ratio <= 1.0):
        raise AssertionError(f"a bf16 step's launches against their plain "
                             f"versions: forward {ulps:.3g} ulps, {changed:.5f}"
                             f" changed; backward {ratio:.3g} x its limit")
    print(f"[bf16] one step of {len(sidx)} slides, kernel route: launches "
          f"{got}; loss {loss_k:.6f} vs plain route {loss_p:.6f}; each launch "
          f"against its plain version: forward worst {ulps:.3g} ulps, "
          f"{changed:.5f} changed; dq/dk/dv worst {ratio:.3g} x their limit "
          f"({SEQ_BF16_GRAD_RTOL} of each gradient's own largest)", flush=True)
    for label, fault in BF16_FAULTS.items():
        with planted_fault(tfa, fault), recorded(tfa) as log:
            step_loss("pallas")
        ratio = launch_agreement(tfa, log)[2]
        if not ratio > 1.0:
            raise AssertionError(f"the bf16 step check passes a planted fault "
                                 f"({label}): {ratio:.3g} x its limit")
        print(f"[bf16] planted fault, {label}: the check fails, worst "
              f"{ratio:.3g} x its limit", flush=True)
    reset_counts(tfa)

    # one epoch of cli.train on each route from the [train] run's initial
    # weights: the entry point's launches and epoch loss, kernel vs plain
    from paths_tpu_torch.cli.train import main as train_main
    from paths_tpu_torch.train.state import save_state

    epoch, launched = {}, {}
    for impl in ("pallas", "xla"):
        c = copy.deepcopy(cfg16)
        c.attention_impl, c.num_epochs = impl, 1
        d = os.path.join(WORK, f"bf16_train_{impl}")
        c.save(d)
        save_state(d, tr["model"])
        epoch[impl], launched[impl] = count(
            lambda: train_main(["-m", d, "--no-wandb"]))
        want = {n: (k if impl == "pallas" else 0) for n, k in
                expected_train_launches(c, tr["splits"]).items()}
        if launched[impl] != want:
            raise AssertionError(f"bf16 cli.train ({impl}) launched "
                                 f"{launched[impl]}; the code says {want}")
    loss_k, loss_p = (epoch[i]["train_loss"][1] for i in ("pallas", "xla"))
    if not (math.isfinite(loss_k)
            and abs(loss_k - loss_p) <= BF16_LOSS_RTOL * abs(loss_p)):
        raise AssertionError(f"bf16 cli.train epoch-1 loss, kernel vs plain "
                             f"route: {loss_k} vs {loss_p}")
    print(f"[bf16] cli.train, 1 epoch on each route: train_loss {loss_k:.6f} "
          f"(kernel) vs {loss_p:.6f} (plain), {abs(loss_k - loss_p) / abs(loss_p):.3g} "
          f"relative (rtol {BF16_LOSS_RTOL:.4g}); f32's epoch 1 "
          f"{tr['runs']['pallas']['train_loss'][1]:.6f}; kernel route "
          f"launches {launched['pallas']} | {gpu}", flush=True)

    steps = {}
    for name, c in (("f32", cfg32), ("bf16", cfg16)):
        model = load_model(init_dir, RecursiveModel(c)).cuda()
        update, _ = make_step_fns(c, make_optimizer(c, model.parameters()))
        steps[name] = (lambda u=update, m=model, b=step_batch[name]:
                       u(m, *b, labels, None, epoch=1))
        steps[name]()
    ms = {n: [] for n in steps}
    for _ in range(2):
        for name, step in steps.items():
            ms[name].append(cuda_ms(step, iters=5, warmup=1))
    for name, step in steps.items():
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        busy = kernel_us(prof) / 1e3
        flash = [sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type.name == "CUDA" and kernel in e.key) / 1e3
                 for kernel in ("flash_fwd_", "flash_bwd_dq_kernel",
                                "flash_bwd_dkv_kernel")]
        print(f"[bf16] warm step of {len(sidx)} slides ({name}): "
              f"{', '.join(f'{t:.2f}' for t in ms[name])} ms between CUDA "
              f"events in turns; kernel time of one profiled step {busy:.2f} "
              f"ms (busy share {busy / min(ms[name]):.3f}), of which #1 / #2 "
              f"/ #3 {' / '.join(f'{t:.4f}' for t in flash)} ms; peak memory "
              f"{peak:.0f} MiB | {gpu}", flush=True)
    reset_counts(tfa)
    return mains



def auto_phase(sl):
    """`resolve_engine` on the card for the [slice] store: fused from the
    card's own memory, streaming when the memory is set below the batch's
    residency."""
    import copy

    from paths_tpu_torch.engine import auto

    cfg = copy.deepcopy(sl["cfg"])
    cfg.engine = "auto"
    pads = sl["sess"]._pads
    bs = cfg.batch_size[0]
    hbm = auto.hbm_bytes("cuda")
    print(f"[auto] card memory {hbm / 2**30:.2f} GiB; ", end="", flush=True)
    if auto.resolve_engine(cfg, pads, bs, device="cuda") != "fused":
        raise AssertionError("engine=auto did not pick fused on the card")
    need = auto.RESIDENCY_FACTOR * auto.estimate_fused_batch_bytes(cfg, pads, bs)
    low = int((need + auto.PARAM_RESERVE) / auto.HBM_FRACTION) - (1 << 20)
    print("[auto] with the memory set below the residency: ", end="", flush=True)
    if auto.resolve_engine(cfg, pads, bs, hbm=low) != "streaming":
        raise AssertionError("engine=auto did not pick streaming below the "
                             "threshold")


def lru_phase(torch, tfa, gpu, sl):
    """A repeated 32-slide request on a fused session with the device batch
    cache: the hit skips collation and the copy, and still runs the
    forward through the kernel."""
    from paths_tpu_torch.serve import ServingSession

    sess = ServingSession(sl["dirs"]["pallas"], cache_batches=4, device="cuda")
    walls, rows = [], []
    for _ in range(3):
        reset_counts(tfa)
        t0 = time.perf_counter()
        rows.append(sess.predict(sl["ids"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    per = sl["cfg"].model_config.trans_layers * sl["cfg"].num_levels
    if tfa.masked_flash_attention_fwd.launches != per or len(sess._batch_cache) != 1:
        raise AssertionError(f"a cache hit launched {launch_counts(tfa)}; "
                             f"{len(sess._batch_cache)} batches cached")
    if not rows[0] == rows[1] == rows[2]:
        raise AssertionError("a cache hit changed the predictions")
    print(f"[lru] request of 32 slides with cache_batches=4: miss "
          f"{walls[0]:.1f} ms, hits {walls[1]:.1f} / {walls[2]:.1f} ms wall; "
          f"with cache_batches=0 (warm, [slice]) {sl['walls'][-1]:.1f} ms | "
          f"{gpu}", flush=True)


def cli_phase(torch, tfa, gpu, tr):
    """`cli.evaluate` and `cli.predict` on the model directory [train]
    trained on the kernel route, and `cli.train --profile` for one epoch.
    Returns `cli.evaluate`'s metrics."""
    import copy
    import csv
    import glob

    import numpy as np

    from paths_tpu_torch.cli.evaluate import main as eval_main
    from paths_tpu_torch.cli.predict import main as predict_main
    from paths_tpu_torch.cli.train import main as train_main
    from paths_tpu_torch.train.state import save_state

    d = tr["dirs"]["pallas"]
    with open(os.path.join(d, "metrics.jsonl")) as f:
        logged = json.loads(f.read().splitlines()[-1])
    t0 = time.perf_counter()
    out = eval_main(["-m", d, "--split", "test"])
    eval_s = time.perf_counter() - t0
    for key in ("test_loss", "test_c-index"):
        rel = abs(out[key] - logged[key]) / max(abs(logged[key]), 1e-30)
        if not rel <= CLI_EVAL_RTOL:
            raise AssertionError(f"cli.evaluate {key} {out[key]} vs train_loop's "
                                 f"{logged[key]}: {rel:.3g} relative")
    out_csv = os.path.join(WORK, "predictions.csv")
    t0 = time.perf_counter()
    predict_main(["-m", d, "--split", "test", "-o", out_csv])
    predict_s = time.perf_counter() - t0
    with open(out_csv, newline="") as f:
        table = list(csv.reader(f))
    test = tr["splits"][2]
    if [r[0] for r in table[1:]] != test.slide_ids:
        raise AssertionError("cli.predict rows are not the test slides in order")
    worst = 0.0
    for r in table[1:]:
        haz = np.array([float(h) for h in r[2:]])
        worst = max(worst, abs(float(r[1]) + np.cumprod(1 - haz).sum()))
    if not worst <= RISK_ATOL:
        raise AssertionError(f"cli.predict risk vs -sum(cumprod(1 - h)): "
                             f"{worst:.3g} > {RISK_ATOL}")
    print(f"[cli] cli.evaluate --split test in {eval_s:.1f} s: {out} (equal to "
          f"train_loop's logged test entries within {CLI_EVAL_RTOL} relative); "
          f"cli.predict --split test in {predict_s:.1f} s: {len(table) - 1} "
          f"rows, worst |risk + sum cumprod(1 - h)| {worst:.3g} | {gpu}",
          flush=True)

    c = copy.deepcopy(tr["cfg"])
    c.num_epochs = 1
    pdir, prof = os.path.join(WORK, "train_profile"), os.path.join(WORK, "prof")
    c.save(pdir)
    save_state(pdir, tr["model"])
    t0 = time.perf_counter()
    train_main(["-m", pdir, "--no-wandb", "--profile", prof])
    wall = time.perf_counter() - t0
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"cli.train --profile wrote {traces}")
    with open(traces[0]) as f:
        text = f.read()
    names = ("flash_fwd", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
    missing = [n for n in names if n not in text]
    if missing:
        raise AssertionError(f"the profile trace names no {missing}")
    print(f"[cli] cli.train --profile, 1 epoch in {wall:.1f} s: "
          f"{os.path.basename(traces[0])}, {len(text) / 2**20:.1f} MiB, names "
          f"{', '.join(names)} | {gpu}", flush=True)
    return out


def staging_probe(torch, gpu, sl):
    """The 32-slide fused collation and copy to the card, in turns: from
    the session's held tables (copied from pageable memory at a slide's
    first collation, from page-locked copies without blocking after its
    second) and from a dataset that holds none (tables built from the store
    each time, copied from pageable memory); the two batches equal to the
    bit."""
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch

    sess, idx = sl["sess"], list(range(len(sl["ids"])))
    unheld = SlideDataset(sess.slide_ids, sess.config, sess.store,
                          cache_slides=False)
    out = {}

    def collate(ds):
        t0 = time.perf_counter()
        out[ds is unheld] = collate_batch(
            ds, idx, level0_bucket=sess.config.level0_bucket, pads=sess._pads,
            device="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    first = {held: collate(sess._dataset if held else unheld)
             for held in (False, True)}
    turns = {False: [], True: []}
    for held in (False, True, True, False, False, True):
        turns[held].append(collate(sess._dataset if held else unheld))
    (bag_u, tab_u), (bag_h, tab_h) = out[True], out[False]
    if not (torch.equal(bag_u.fts, bag_h.fts) and all(
            torch.equal(getattr(a, k), getattr(b, k)) for a, b in zip(tab_u, tab_h)
            for k in ("fts", "locs", "count", "index", "grid_hw"))):
        raise AssertionError("held and unheld collations differ")
    print(f"[staging] 32-slide collate + copy to the card, in turns: unheld "
          f"(built from the store, pageable) {', '.join(f'{t:.1f}' for t in turns[False])}"
          f" ms (first {first[False]:.1f}); held (page-locked once reused) "
          f"{', '.join(f'{t:.1f}' for t in turns[True])} ms (first "
          f"{first[True]:.1f}); batches equal | {gpu}", flush=True)


# [remat]: one [train] batch with `remat` on and off. The recompute runs the
# same kernels on the same values, so loss and gradients are held equal to
# the bit (no tolerance), at dropout 0 on the kernel route and at the
# published 0.05 on the plain route over two steps from one generator.
# A level-0 bag this wide shows what remat saves when level 0 dominates.
REMAT_WIDE_N0 = 4096


def remat_phase(torch, tfa, gpu, tr):
    """One 32-slide [train] batch, 2 steps each with `remat` on and off from
    the same weights: kernel launches per step, bitwise loss and gradients,
    step time and peak memory; then at the published dropout on the plain
    route, and at a level-0 bag of REMAT_WIDE_N0 patches."""
    import copy

    from paths_tpu_torch.data.dataset import collate_batch, labels_on, union_pads
    from paths_tpu_torch.models.batch import PatchBag
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import make_optimizer, make_step_fns
    from paths_tpu_torch.train.state import load_model

    cfg, splits = tr["cfg"], tr["splits"]
    train = splits[0]
    idx = list(range(cfg.batch_size[0]))
    pads = union_pads(*(d.global_pads() for d in splits if d is not None))
    bag, tables = collate_batch(train, idx, level0_bucket=cfg.level0_bucket,
                                pads=pads, device="cuda")
    labels = labels_on(train, idx, "cuda")
    init_dir = os.path.join(WORK, "train_init")   # written by step_checks

    def steps(c, bag0, seed=None):
        model = load_model(init_dir, RecursiveModel(c)).cuda()
        update, _ = make_step_fns(c, make_optimizer(c, model.parameters()))
        gen = (torch.Generator(device="cuda").manual_seed(seed)
               if seed is not None else None)
        out = []
        for _ in range(2):
            reset_counts(tfa)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _ = update(model, bag0, tables, labels, gen, epoch=1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            out.append({"loss": loss.item(), "launches": launch_counts(tfa),
                        "ms": ms, "peak": peak / 2**20,
                        "step": (peak - base) / 2**20,
                        "grads": {n: p.grad.clone()
                                  for n, p in model.named_parameters()
                                  if p.grad is not None}})
        del model, update
        return out

    def compare(label, c, bag0, seed=None):
        runs = {}
        for remat in (False, True):
            cc = copy.deepcopy(c)
            cc.remat = remat
            runs[remat] = steps(cc, bag0, seed)
        for k, (a, b) in enumerate(zip(runs[False], runs[True])):
            same = [n for n in a["grads"] if torch.equal(a["grads"][n],
                                                         b["grads"][n])]
            if a["loss"] != b["loss"] or len(same) != len(a["grads"]) or \
                    sorted(a["grads"]) != sorted(b["grads"]):
                raise AssertionError(
                    f"[remat] {label} step {k + 1}: loss {a['loss']} vs "
                    f"{b['loss']}, {len(same)} of {len(a['grads'])} gradients "
                    "equal to the bit")
        print(f"[remat] {label}: 2 steps, remat off vs on: losses "
              f"{[r['loss'] for r in runs[False]]} equal to the bit, all "
              f"{len(runs[False][0]['grads'])} gradients equal to the bit in "
              f"both steps; kernel launches per step off "
              f"{runs[False][1]['launches']}, on {runs[True][1]['launches']}; "
              f"step 2 wall {runs[False][1]['ms']:.1f} vs "
              f"{runs[True][1]['ms']:.1f} ms; torch.cuda.max_memory_allocated "
              f"over step 2 {runs[False][1]['peak']:.0f} vs "
              f"{runs[True][1]['peak']:.0f} MiB (above what was allocated "
              f"before the step: {runs[False][1]['step']:.0f} vs "
              f"{runs[True][1]['step']:.0f}) | {gpu}", flush=True)
        for r in runs.values():
            for s in r:
                del s["grads"]
        return runs

    per = cfg.model_config.trans_layers * cfg.num_levels
    runs = compare(f"kernel route, dropout 0, {len(idx)} slides, level-0 bag "
                   f"{bag.fts.shape[1]}", cfg, bag)
    names = ("masked_flash_attention_fwd", "masked_flash_attention_bwd_dq",
             "masked_flash_attention_bwd_dkv")
    for remat, run in runs.items():
        want = dict(zip(names, (per * (1 + remat), per, per)))
        if any(s["launches"] != want for s in run):
            raise AssertionError(f"[remat] remat={remat}: launches "
                                 f"{[s['launches'] for s in run]}, want {want}")

    c = copy.deepcopy(cfg)
    c.model_config.dropout = tr["published_dropout"]
    runs = compare(f"published dropout {c.model_config.dropout} (the plain "
                   "route, as in JAX), one generator", c, bag, seed=1)
    if any(any(s["launches"].values()) for r in runs.values() for s in r):
        raise AssertionError("[remat] a dropout step launched flash kernels")

    b, n, ps = len(idx), REMAT_WIDE_N0, cfg.model_config.patch_size
    ds_dim, dp_dim = cfg.model_config.ctx_dim()
    side = int(math.isqrt(n))
    cells = torch.arange(n, device="cuda")
    locs = torch.stack([cells // side, cells % side], -1) * ps
    wide = PatchBag(
        fts=torch.randn((b, n, cfg.model_config.patch_embed_dim), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0)),
        locs=locs.expand(b, n, 2), mask=torch.ones((b, n), dtype=torch.bool,
                                                  device="cuda"),
        parent_inds=cells.expand(b, n),
        ctx_slide=torch.zeros((b, 0, ds_dim), device="cuda"),
        ctx_patch=torch.zeros((b, n, 0, dp_dim), device="cuda"))
    compare(f"kernel route, dropout 0, a level-0 bag of {n} patches x {b} "
            "slides (the deeper levels from the [train] tables)", cfg, wide)
    del wide


def ckpt_phase(torch, gpu, sl, tr, cli_out):
    """The reference's `model.pt` route: the [slice] and [train] models
    exported with the port's `save_torch_checkpoint` into directories holding
    only config.json and model.pt; a session there against the npz session,
    and `cli.evaluate` against the [cli] phase's numbers, both to the bit."""
    from paths_tpu_torch.cli.evaluate import main as eval_main
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.convert import save_torch_checkpoint
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.serve import ServingSession
    from paths_tpu_torch.train.state import load_model

    def export(src, name):
        dst = os.path.join(WORK, name)
        os.makedirs(dst)
        shutil.copy(os.path.join(src, "config.json"), dst)
        model = load_model(src, RecursiveModel(Config.load(src, test_mode=True)))
        t0 = time.perf_counter()
        save_torch_checkpoint(os.path.join(dst, "model.pt"), model)
        took = time.perf_counter() - t0
        if sorted(os.listdir(dst)) != ["config.json", "model.pt"]:
            raise AssertionError(f"[ckpt] {dst} holds {os.listdir(dst)}")
        return dst, took, os.path.getsize(os.path.join(dst, "model.pt"))

    d, took, size = export(sl["dirs"]["pallas"], "ckpt_slice")
    t0 = time.perf_counter()
    sess = ServingSession(d, cache_batches=0, device="cuda")
    open_s = time.perf_counter() - t0
    got = sess.predict(sl["ids"])
    want = sl["sess"].predict(sl["ids"])
    if [r["hazards"] for r in got] != [r["hazards"] for r in want]:
        raise AssertionError("[ckpt] the model.pt session's hazards differ from "
                             "the npz session's")
    print(f"[ckpt] [slice] model written as model.pt ({size / 2**20:.1f} MiB "
          f"in {took:.2f} s); a ServingSession on config.json + model.pt opened "
          f"in {open_s:.1f} s: hazards of {len(got)} slides equal to the npz "
          f"session's to the bit | {gpu}", flush=True)
    d, _, _ = export(tr["dirs"]["pallas"], "ckpt_train")
    out = eval_main(["-m", d, "--split", "test"])
    if out != cli_out:
        raise AssertionError(f"[ckpt] cli.evaluate on model.pt {out} vs the "
                             f"[cli] phase's {cli_out}")
    print(f"[ckpt] cli.evaluate --split test on config.json + model.pt of the "
          f"[train] model: {out}, equal to the [cli] phase's to the bit | {gpu}",
          flush=True)


# [orbax]: the port's Orbax writer and reader move no bit (the arrays are
# stored as they are), so the round trip, the session's hazards and
# cli.evaluate's metrics are held equal to the bit. One epoch of cli.train
# under checkpoint_backend "orbax" against the npz run's first epoch, from
# the same weights on the same batches: the backend must not change
# training, and the two runs differ only where the card's reductions are not
# deterministic, so they are held to LOSS_RTOL.
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_jax")


def _dir_mib(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs) / 2**20


def orbax_phase(torch, gpu, sl, tr, cli_out):
    """The Orbax backend without JAX: the [train] model and its AdamW state
    through `save_state(backend="orbax")` and back; a session and
    `cli.evaluate` on directories holding only config.json and orbax/; one
    epoch of `cli.train` under checkpoint_backend "orbax"; and the committed
    JAX-written checkpoint read with the host's libzstd (or, without it, the
    documented error)."""
    import copy

    import numpy as np

    from paths_tpu_torch import convert
    from paths_tpu_torch.cli.evaluate import main as eval_main
    from paths_tpu_torch.cli.train import main as train_main
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.native import zstd
    from paths_tpu_torch.serve import ServingSession
    from paths_tpu_torch.train import loop as tloop
    from paths_tpu_torch.train import orbax
    from paths_tpu_torch.train import state as tstate

    def fresh(cfg):
        model = tloop.RecursiveModel(cfg).to("cuda")
        return model, tloop.make_optimizer(cfg, model.parameters())

    def same(got, want, what):
        if sorted(got) != sorted(want) or not all(
                got[k].dtype == want[k].dtype
                and np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"[orbax] {what} differ after the round trip")

    def only_orbax(src, name):
        dst = os.path.join(WORK, name)
        os.makedirs(dst)
        shutil.copy(os.path.join(src, "config.json"), dst)
        return dst

    src = tr["dirs"]["pallas"]
    cfg = Config.load(src, test_mode=True)
    clip = cfg.clip_grad_norm
    model, opt = fresh(cfg)
    tstate.load_state(src, model, opt, clip_grad_norm=clip)
    dst = only_orbax(src, "orbax_train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate.save_state(dst, model, opt, clip_grad_norm=clip, backend="orbax")
    write_ms = (time.perf_counter() - t0) * 1e3
    back, back_opt = fresh(cfg)
    t0 = time.perf_counter()
    tstate.load_state(dst, back, back_opt, clip_grad_norm=clip,
                      checkpoint_backend="orbax")
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - t0) * 1e3
    same(convert.to_jax_flat(back), convert.to_jax_flat(model), "parameters")
    want_opt = tstate.optimizer_to_jax_flat(model, opt, clip)
    same(tstate.optimizer_to_jax_flat(back, back_opt, clip), want_opt,
         "AdamW moments or count")
    # the files alone, without the copies between the card and the host
    flat = convert.to_jax_flat(model)
    t0 = time.perf_counter()
    orbax.write_orbax(os.path.join(WORK, "orbax_files"), flat, want_opt)
    files_write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    orbax.read_orbax(os.path.join(dst, "orbax"))
    files_read_ms = (time.perf_counter() - t0) * 1e3
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[orbax] [train] model ({n_params} parameters) and AdamW state "
          f"(count {int(want_opt['.count'])}): save_state(backend=\"orbax\") "
          f"{write_ms:.1f} ms, {_dir_mib(os.path.join(dst, 'orbax')):.1f} MiB "
          f"on disk; load_state {read_ms:.1f} ms; of which the {len(flat) + len(want_opt)} "
          f"arrays' files: write_orbax {files_write_ms:.1f} ms, read_orbax "
          f"{files_read_ms:.1f} ms; every parameter, both moments and the count "
          f"equal to the bit | {gpu}", flush=True)

    d = only_orbax(sl["dirs"]["pallas"], "orbax_slice")
    tstate.save_state(d, sl["sess"].model, backend="orbax")
    sess = ServingSession(d, cache_batches=0, device="cuda")
    got, want = sess.predict(sl["ids"]), sl["sess"].predict(sl["ids"])
    if [r["hazards"] for r in got] != [r["hazards"] for r in want]:
        raise AssertionError("[orbax] the orbax/ session's hazards differ from "
                             "the npz session's")
    del sess
    out = eval_main(["-m", dst, "--split", "test"])
    if out != cli_out:
        raise AssertionError(f"[orbax] cli.evaluate on orbax/ {out} vs the "
                             f"[cli] phase's {cli_out}")
    print(f"[orbax] on config.json + orbax/ only: a ServingSession's hazards "
          f"of {len(got)} slides equal the npz session's to the bit; "
          f"cli.evaluate --split test {out} equals the [cli] phase's to the "
          f"bit | {gpu}", flush=True)

    c = copy.deepcopy(tr["cfg"])
    c.num_epochs, c.checkpoint_backend = 1, "orbax"
    pdir = os.path.join(WORK, "train_orbax")
    c.save(pdir)
    tstate.save_state(pdir, tr["model"], backend="orbax")
    t0 = time.perf_counter()
    stats = train_main(["-m", pdir, "--no-wandb"])
    wall = time.perf_counter() - t0
    if os.path.exists(os.path.join(pdir, "model.npz")) or not os.path.isdir(
            os.path.join(pdir, "orbax")):
        raise AssertionError(f"[orbax] cli.train wrote {os.listdir(pdir)}")
    npz_loss = tr["runs"]["pallas"]["train_loss"][1]
    rel = abs(stats["train_loss"][1] - npz_loss) / abs(npz_loss)
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"[orbax] epoch-1 train loss {stats['train_loss'][1]}"
                             f" vs the npz run's {npz_loss}: {rel:.3g} relative")
    print(f"[orbax] cli.train checkpoint_backend=orbax, 1 epoch in {wall:.1f} s:"
          f" train_loss {stats['train_loss'][1]!r} vs the npz run's "
          f"{npz_loss!r} ({'equal to the bit' if rel == 0 else f'{rel:.3g} relative'}"
          f", rtol {LOSS_RTOL}); checkpoint in orbax/ only | {gpu}", flush=True)

    name = zstd.find_library()
    fixture = os.path.join(ORBAX_FIXTURE, "orbax")
    if name is None:
        try:
            orbax.read_orbax(fixture)
        except zstd.ZstdUnavailable as e:
            if "libzstd" not in str(e):
                raise AssertionError(f"[orbax] the error names no library: {e}")
            print(f"[orbax] libzstd absent on this host: reading the JAX-written "
                  f"checkpoint raises ZstdUnavailable ({e}) | {gpu}", flush=True)
        else:
            raise AssertionError("[orbax] a zstd store read without libzstd")
        return
    t0 = time.perf_counter()
    params, opt_flat = orbax.read_orbax(fixture)
    read_ms = (time.perf_counter() - t0) * 1e3
    got = {f"params/{k}": v for k, v in params.items()}
    got.update({f"opt/{k}": v for k, v in opt_flat.items()})
    got = {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in got.items()}
    with np.load(os.path.join(ORBAX_FIXTURE, "expected.npz")) as z:
        same(got, dict(z.items()), "the JAX-written checkpoint's arrays")
    print(f"[orbax] libzstd found ({name}): the committed JAX-written "
          f"checkpoint (OCDBT, zstd) read in {read_ms:.1f} ms, {len(got)} "
          f"arrays equal to the state it was written from | {gpu}", flush=True)


# [export]: an artifact runs the live session's op sequence on the same
# kernel (#1 through its operator) at the same shapes, so its hazards are
# expected equal to the live fused session's to the bit, and are held to
# PRED_ATOL otherwise. The two-platform artifact's CPU program runs the
# plain flash version in place of #1: PRED_ATOL, as [slice]'s plain route.
# cli.predict writes 6 decimals: live and artifact CSVs may differ by one
# unit of the last one.
CSV_ATOL = 1e-6


def export_phase(torch, tfa, gpu, sl):
    """`cli.export` of the [slice] model four ways (weights as arguments,
    frozen, a symbolic batch, CUDA and CPU programs); the operator's nodes in
    the CUDA graph; a 32-slide request through `ServingSession(artifact=...)`
    (#1's launches, hazards against the live session); the poly artifact at 8
    and 32 slides; the CPU program against the card's; the planted fault (an
    artifact with a subset's smaller pads must refuse larger slides);
    `cli.predict --artifact` and `cli.serve --artifact`. Returns #1's
    launches of the 32-slide request."""
    import csv
    import http.client
    import threading

    from paths_tpu_torch import export as texport
    from paths_tpu_torch.cli import serve as cserve
    from paths_tpu_torch.cli.export import main as export_main
    from paths_tpu_torch.cli.predict import main as predict_main
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.synthetic import make_synthetic_metadata
    from paths_tpu_torch.serve import ServingSession

    cfg, ids, live = sl["cfg"], sl["ids"], sl["sess"]
    per = cfg.model_config.trans_layers * cfg.num_levels
    meta = os.path.join(WORK, "slice_meta.csv")
    make_synthetic_metadata(meta, ids, seed=0)
    d = model_dir_copy(sl["dirs"]["pallas"], "export_model", csv_path=meta,
                       hipt_splits=False)

    def worst_diff(got, want):
        return max(abs(x - y) for a, b in zip(got, want)
                   for x, y in zip(a["hazards"], b["hazards"]))

    def held(got, want, what):
        if [r["slide_id"] for r in got] != [r["slide_id"] for r in want]:
            raise AssertionError(f"[export] {what}: rows of other slides")
        worst = worst_diff(got, want)
        if not worst <= PRED_ATOL:
            raise AssertionError(f"[export] {what}: hazards differ by "
                                 f"{worst:.3g} > {PRED_ATOL}")
        return "equal to the bit" if worst == 0 else f"max |diff| {worst:.3g}"

    arts = {}
    for name, flags in (("args", []), ("frozen", ["--freeze"]),
                        ("poly", ["--poly-batch"]),
                        ("two", ["--platforms", "cuda", "cpu"])):
        path = os.path.join(WORK, f"{name}.pt2z")
        t0 = time.perf_counter()
        export_main(["-m", d, "-o", path, "--batch-size", "32"] + flags)
        took = time.perf_counter() - t0
        with open(path, "rb") as f:
            blob = f.read()
        t0 = time.perf_counter()
        exp = texport.load_serving(blob)
        load_s = time.perf_counter() - t0
        nodes = {p: sum("paths_torch.flash_attention_fwd" in str(n.target)
                        for n in exp.program(p).graph.nodes)
                 for p in exp.platforms}
        if nodes.get("cuda") != per or any(n != per for n in nodes.values()):
            raise AssertionError(f"[export] {name}: the operator appears "
                                 f"{nodes} times, want {per} per program")
        arts[name] = path
        print(f"[export] cli.export {name} {' '.join(flags)}: {took:.1f} s, "
              f"{len(blob) / 2**20:.2f} MiB, programs {exp.platforms}, "
              f"signature {texport.artifact_signature(exp)[:2]}; loaded in "
              f"{load_s:.1f} s; paths_torch::flash_attention_fwd nodes per "
              f"program {nodes} | {gpu}", flush=True)
        del exp

    sess = ServingSession(d, artifact=arts["args"], cache_batches=0,
                          device="cuda")
    want = live.predict(ids)
    reset_counts(tfa)
    got = sess.predict(ids)
    torch.cuda.synchronize()
    launches = tfa.masked_flash_attention_fwd.launches
    if launches != per or tfa.masked_flash_attention_bwd_dq.launches:
        raise AssertionError(f"[export] a 32-slide artifact request launched "
                             f"{launch_counts(tfa)}, want #1 {per} times")
    how = held(got, want, "artifact vs live session")
    reason = ("" if how == "equal to the bit" else
              " (the artifact's graph runs the same ops on the same shapes; a "
              "difference means an op chose another algorithm)")
    print(f"[export] ServingSession(artifact=weights-as-args), {len(ids)} "
          f"slides: #1 launched {launches} times; hazards vs the live fused "
          f"session {how}{reason} | {gpu}", flush=True)
    art_ms, live_ms = [], []
    for _ in range(2):
        for s_, log in ((sess, art_ms), (live, live_ms)):
            t0 = time.perf_counter()
            s_.predict(ids)
            log.append((time.perf_counter() - t0) * 1e3)
    print(f"[export] warm {len(ids)}-slide request in turns: artifact "
          f"{', '.join(f'{t:.1f}' for t in art_ms)} ms, live "
          f"{', '.join(f'{t:.1f}' for t in live_ms)} ms | {gpu}", flush=True)
    del sess

    results = {}
    for name, device, reqs in (("frozen", "cuda", [ids]),
                               ("poly", "cuda", [ids[:8], ids]),
                               ("two", "cuda", [ids]), ("two", "cpu", [ids])):
        s_ = ServingSession(d, artifact=arts[name], cache_batches=0,
                            device=device)
        for req in reqs:
            results[(name, device, len(req))] = s_.predict(req)
        del s_
    lines = [f"frozen {held(results[('frozen', 'cuda', 32)], want, 'frozen')}",
             f"poly at 8 {held(results[('poly', 'cuda', 8)], live.predict(ids[:8]), 'poly 8')}",
             f"poly at 32 {held(results[('poly', 'cuda', 32)], want, 'poly 32')}",
             f"cuda program of the two-platform artifact "
             f"{held(results[('two', 'cuda', 32)], want, 'two cuda')}",
             f"its cpu program vs its cuda program "
             f"{held(results[('two', 'cpu', 32)], results[('two', 'cuda', 32)], 'two cpu')}"]
    print(f"[export] hazards vs the live session: {'; '.join(lines)} (atol "
          f"{PRED_ATOL}) | {gpu}", flush=True)

    # the planted fault: an artifact exported at the pads of the slide with
    # the smallest level-0 bag must refuse the store's larger slides
    small = min(live.slide_ids, key=lambda s_: live._dataset.slides[
        live._index[s_]].level0[2])
    ds_small = SlideDataset([small], cfg, live.store)
    pads_small = ds_small.global_pads()
    if not pads_small["n0"] < live._pads["n0"]:
        raise AssertionError("[export] no slide has a smaller level-0 bag: the "
                             "planted fault would not be planted")
    bag, tables = collate_batch(ds_small, [0] * 32, level0_bucket=1,
                                row_bucket=1, grid_bucket=1, pads=pads_small,
                                device="cuda")
    path = os.path.join(WORK, "small.pt2z")
    with open(path, "wb") as f:
        f.write(texport.export_serving(cfg, live.model, bag, tables))
    del bag, tables
    s_ = ServingSession(d, artifact=path, cache_batches=0, device="cuda")
    try:
        s_.predict(ids)
    except ValueError as e:
        if "Re-export" not in str(e):
            raise
        refused = str(e)[:120]
    else:
        raise AssertionError("[export] an artifact with smaller pads served "
                             "larger slides")
    if len(s_.predict([small])) != 1:
        raise AssertionError("[export] the small artifact refused its own slide")
    del s_
    print(f"[export] planted fault: an artifact at {small}'s pads (n0 "
          f"{pads_small['n0']} < {live._pads['n0']}) refuses the store's "
          f"slides: ValueError '{refused}...' | {gpu}", flush=True)

    csvs = {}
    for name, extra in (("live", []), ("artifact", ["--artifact", arts["args"]])):
        path = os.path.join(WORK, f"predict_{name}.csv")
        t0 = time.perf_counter()
        predict_main(["-m", d, "--split", "all", "-o", path] + extra)
        with open(path, newline="") as f:
            csvs[name] = (list(csv.reader(f)), time.perf_counter() - t0)
    (a, a_s), (b, b_s) = csvs["live"], csvs["artifact"]
    if a[0] != b[0] or [r[0] for r in a] != [r[0] for r in b]:
        raise AssertionError("[export] cli.predict --artifact wrote other rows")
    csv_worst = max(abs(float(x) - float(y)) for ra, rb in zip(a[1:], b[1:])
                    for x, y in zip(ra[1:], rb[1:]))
    if not csv_worst <= CSV_ATOL:
        raise AssertionError(f"[export] cli.predict CSVs differ by {csv_worst}")

    servers, real = [], cserve.make_server

    def capture(*args, **kwargs):
        servers.append(real(*args, **kwargs))
        return servers[-1]

    cserve.make_server = capture
    th = threading.Thread(target=cserve.main, args=(
        ["-m", d, "--artifact", arts["args"], "--port", "0",
         "--cache-batches", "0"],), daemon=True)
    th.start()
    try:
        for _ in range(1200):
            if servers:
                break
            th.join(0.1)
        if not servers:
            raise AssertionError("[export] cli.serve --artifact did not start")
        conn = http.client.HTTPConnection(*servers[0].server_address[:2],
                                          timeout=300)
        conn.request("POST", "/predict", body=json.dumps({"slide_ids": ids}))
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.close()
        if r.status != 200 or body["predictions"] != got:
            raise AssertionError(f"[export] cli.serve --artifact: {r.status}, "
                                 "rows differ from session.predict's")
    finally:
        cserve.make_server = real
        for srv in servers:
            srv.shutdown()
        th.join(60)
    print(f"[export] cli.predict --split all: live {a_s:.1f} s and --artifact "
          f"{b_s:.1f} s write {'the same CSV' if a == b else f'CSVs within {csv_worst:.1g}'}"
          f" ({len(a) - 1} rows); cli.serve --artifact: POST /predict of "
          f"{len(ids)} slides equals session.predict to the bit | {gpu}",
          flush=True)
    return launches


# [dp]: data parallelism. Two training ranks or two serving / preprocessing
# shards: one per card where the host has two, else both on cuda:0 (NCCL
# refuses two ranks on one card, so those ranks join over gloo, whose
# all-reduce and broadcast take CUDA tensors). Every child has a timeout and
# is killed past it; a collective waits at most DP_GROUP_TIMEOUT_S.
DP_GROUP_TIMEOUT_S = 120
DP_CHILD_TIMEOUT_S = 300
# A two-shard session's hazards: each shard is a one-device batch of half the
# rows, so they must equal to the bit those of a one-device session whose
# batch is a shard's; against the live one-device session (32 rows a batch)
# they differ where cuBLAS sums a 16-row GEMM in another order than a 32-row
# one (1.04e-6 relative on the H100): held to 1e-6 absolute.
DP_HAZARD_ATOL = 1e-6

DP_TRAIN_CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from paths_tpu_torch.runtime import maybe_init_distributed
from paths_tpu_torch.kernels import flash_attention as tfa
from paths_tpu_torch.train import loop
backend, device, model_dir, timeout = sys.argv[2:6]
maybe_init_distributed(backend, device, timeout=float(timeout))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
seen, steps = {}, []
real = loop.make_step_fns

def spy(config, optimizer, mesh=None):
    seen["opt"] = optimizer
    update, evaluate = real(config, optimizer, mesh)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*args, **kwargs)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed, evaluate

loop.make_step_fns = spy
from paths_tpu_torch.cli.train import main
stats = main(["-m", model_dir, "--no-wandb", "--device", device])
digest = hashlib.sha256()
for group in seen["opt"].param_groups:
    for p in group["params"]:
        digest.update(p.detach().cpu().numpy().tobytes())
counts = {f.__name__: f.launches for f in (
    tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
    tfa.masked_flash_attention_bwd_dkv)}
print("DP_RANK " + json.dumps({
    "rank": torch.distributed.get_rank(),
    "backend": torch.distributed.get_backend(),
    "device": str(torch.cuda.current_device()),
    "loss": stats["train_loss"][1], "epoch_s": stats["epoch_wall_s"][1],
    "steps_ms": steps, "counts": counts, "params": digest.hexdigest()}),
    flush=True)
"""


def dp_layout(torch, n: int = 2):
    """(backend, device per rank or shard, words for the lines)."""
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{i}" for i in range(n)], "one per card (NCCL)"
    return "gloo", ["cuda:0"] * n, ("all on cuda:0 over gloo, this host "
                                    "having one card")


def run_ranks(code: str, args_per_rank, timeout: float) -> list:
    """Start one `python -c code` per rank with the environment torchrun
    sets; returns each rank's DP_RANK JSON. A rank past `timeout` is killed
    with all the others, and any failure raises with the ranks' output."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    world = len(args_per_rank)
    procs = []
    for rank, args in enumerate(args_per_rank):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, ROOT, *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            logs.append((out, err + f"\nkilled after {timeout:.0f} s"))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n---\n".join(
            f"rank {r} rc={p.returncode}:\n{o[-3000:]}\n{e[-6000:]}"
            for r, (p, (o, e)) in enumerate(zip(procs, logs))))
    results = []
    for rank, (out, _) in enumerate(logs):
        lines = [ln for ln in out.splitlines() if ln.startswith("DP_RANK ")]
        if len(lines) != 1:
            raise AssertionError(f"rank {rank} printed no result:\n{out[-3000:]}")
        results.append(json.loads(lines[0][len("DP_RANK "):]))
    return results


def dp_train_phase(torch, tfa, gpu, tr):
    """[dp-train]: two ranks of `cli.train` over the [train] model directory
    from its initial weights, one epoch with `mesh_shape: [2]`: the epoch's
    loss against the one-process run's epoch 1, the ranks' parameters equal
    to the bit, and each rank's kernel launches against the code's count."""
    import copy

    from paths_tpu_torch.parallel.mesh import ProcessMesh
    from paths_tpu_torch.train.loop import rank_batch
    from paths_tpu_torch.train.state import save_state

    cfg = copy.deepcopy(tr["cfg"])
    cfg.num_epochs, cfg.mesh_shape, cfg.attention_impl = 1, [2], "pallas"
    d = os.path.join(WORK, "dp_train")
    cfg.save(d)
    save_state(d, tr["model"])
    backend, devices, layout = dp_layout(torch)
    rank_device = {"nccl": "cuda", "gloo": "cuda:0"}[backend]
    t0 = time.perf_counter()
    ranks = run_ranks(DP_TRAIN_CHILD, [[backend, rank_device, d,
                                        str(DP_GROUP_TIMEOUT_S)]] * 2,
                      DP_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    want_loss = tr["runs"]["pallas"]["train_loss"][1]
    want_counts = expected_train_launches(cfg, tr["splits"])
    for r in ranks:
        rel = abs(r["loss"] - want_loss) / abs(want_loss)
        if not rel <= LOSS_RTOL:
            raise AssertionError(f"[dp-train] rank {r['rank']}: epoch-1 loss "
                                 f"{r['loss']} vs one process {want_loss} "
                                 f"({rel:.3g} > {LOSS_RTOL})")
        if r["counts"] != want_counts:
            raise AssertionError(f"[dp-train] rank {r['rank']} launched "
                                 f"{r['counts']}, the code says {want_counts}")
        if r["backend"] != backend:
            raise AssertionError(f"[dp-train] rank {r['rank']} ran over "
                                 f"{r['backend']}, not {backend}")
    if ranks[0]["params"] != ranks[1]["params"]:
        raise AssertionError("[dp-train] the ranks' parameters differ after "
                             "the epoch")
    rel = max(abs(r["loss"] - want_loss) / abs(want_loss) for r in ranks)
    print(f"[dp-train] 2 ranks of cli.train, mesh_shape [2], {layout} "
          f"(backend {backend} passed explicitly): one epoch of "
          f"{len(tr['splits'][0])} train slides, {len(ranks[0]['steps_ms'])} "
          f"steps of {rank_batch(cfg.batch_size[0], ProcessMesh(0, 2))} rows a "
          f"rank; epoch-1 loss {ranks[0]['loss']:.9f} vs "
          f"one process {want_loss:.9f} (rel {rel:.3g}, rtol {LOSS_RTOL}); "
          f"parameters equal to the bit on both ranks (sha256 "
          f"{ranks[0]['params'][:12]}); launches per rank {ranks[0]['counts']}"
          f" as the code says; {wall:.1f} s for both processes | {gpu}",
          flush=True)
    for r in ranks:
        print(f"[dp-train] rank {r['rank']}: steps "
              f"{', '.join(f'{t:.1f}' for t in r['steps_ms'])} ms wall "
              f"(synchronised, the gradient all-reduce included), epoch "
              f"{r['epoch_s']:.2f} s, against one process's warm "
              f"{cfg.batch_size[0]}-row step "
              f"{tr['step_ms']:.1f} ms and epoch "
              f"{tr['runs']['pallas']['epoch_wall_s'][1]:.2f} s | {gpu}",
              flush=True)


def dp_serve_phase(torch, tfa, gpu, sl):
    """[dp-serve]: the [slice] model behind a two-shard `ServingSession`
    (no batch cache): hazards of a 32-slide request against the one-device
    session's, #1's launches per shard, whether the fused forward waits for
    the host, the warm request's wall beside the one-device request's in
    turns; then `cli.serve --data-parallel 2` with one request."""
    import http.client
    import threading

    from paths_tpu_torch.cli import serve as cserve
    from paths_tpu_torch.data.dataset import collate_batch
    from paths_tpu_torch.parallel.mesh import make_mesh
    from paths_tpu_torch.serve import ServingSession, serving_forward

    cfg, ids, one = sl["cfg"], sl["ids"], sl["sess"]
    per = cfg.model_config.trans_layers * cfg.num_levels
    backend, devices, layout = dp_layout(torch)
    t0 = time.perf_counter()
    two = ServingSession(sl["dirs"]["pallas"], cache_batches=0,
                         mesh=make_mesh(devices=devices))
    open_s = time.perf_counter() - t0
    reset_counts(tfa)
    got = two.predict(ids)
    torch.cuda.synchronize()
    launches = tfa.masked_flash_attention_fwd.launches
    if launches != 2 * per:
        raise AssertionError(f"[dp-serve] a {len(ids)}-slide request launched #1 "
                             f"{launches} times, want {per} per shard")
    if [r["slide_id"] for r in got] != ids:
        raise AssertionError("[dp-serve] rows out of order")
    halves = ServingSession(sl["dirs"]["pallas"], cache_batches=0,
                            batch_size=len(ids) // 2, device=devices[0])
    if halves.predict(ids) != got:
        raise AssertionError("[dp-serve] two shards differ from one device "
                             "serving the same halves")
    pairs = [(x, y) for a, b in zip(got, one.predict(ids))
             for x, y in zip(a["hazards"], b["hazards"])]
    diff = max(abs(x - y) for x, y in pairs)
    rel = max(abs(x - y) / abs(y) for x, y in pairs)
    if not diff <= DP_HAZARD_ATOL:
        raise AssertionError(f"[dp-serve] hazards differ from the one-device "
                             f"session's by {diff:.3g} (rel {rel:.3g})")

    # does the fused forward wait for the host anywhere? a sync raises here
    share = len(ids) // 2
    bag, tables = collate_batch(two._dataset, list(range(share)),
                                level0_bucket=cfg.level0_bucket,
                                pads=two._pads, device=devices[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            serving_forward(two.model, cfg, bag, tables)
        syncs = "none: the shards' forwards queue from one thread"
    except RuntimeError as e:
        import traceback

        where = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                 for f in traceback.extract_tb(e.__traceback__)
                 if "paths_tpu_torch" in f.filename]
        syncs = f"yes, at {where[-1] if where else '?'} ({str(e)[:120]})"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if syncs.startswith("yes"):
        raise AssertionError(f"[dp-serve] the fused forward syncs the host: "
                             f"{syncs}; the session's loop over shards "
                             "would serialise them")

    walls = {"one": [], "two": []}
    for name in ("one", "two", "two", "one", "one", "two"):
        sess = one if name == "one" else two
        t0 = time.perf_counter()
        sess.predict(ids)
        walls[name].append((time.perf_counter() - t0) * 1e3)
    print(f"[dp-serve] ServingSession(mesh=make_mesh(devices={devices})), "
          f"2 shards {layout}: opened in {open_s:.1f} s; a {len(ids)}-slide request "
          f"launches #1 {launches} times ({per} per shard); hazards equal to "
          f"the bit to a one-device session at batch {len(ids) // 2}, and "
          f"{'equal to the bit' if diff == 0 else f'within {diff:.3g} (rel {rel:.3g})'} "
          f"of the one-device session's at {one.batch_size} (atol "
          f"{DP_HAZARD_ATOL}); host syncs "
          f"in the fused forward (torch.cuda.set_sync_debug_mode): {syncs} "
          f"| {gpu}", flush=True)
    print(f"[dp-serve] warm {len(ids)}-slide request in turns: two shards "
          f"{', '.join(f'{t:.1f}' for t in walls['two'])} ms, one device "
          f"{', '.join(f'{t:.1f}' for t in walls['one'])} ms | {gpu}",
          flush=True)

    servers, real = [], cserve.make_server

    def capture(*args, **kwargs):
        servers.append(real(*args, **kwargs))
        return servers[-1]

    argv = ["-m", sl["dirs"]["pallas"], "--port", "0", "--cache-batches", "0",
            "--data-parallel", "2"]
    if backend == "gloo":
        argv += ["--device", "cuda:0"]
    cserve.make_server = capture
    th = threading.Thread(target=cserve.main, args=(argv,), daemon=True)
    th.start()
    try:
        for _ in range(1200):
            if servers:
                break
            th.join(0.1)
        if not servers:
            raise AssertionError("[dp-serve] cli.serve --data-parallel did "
                                 "not start")
        conn = http.client.HTTPConnection(*servers[0].server_address[:2],
                                          timeout=300)
        reset_counts(tfa)
        conn.request("POST", "/predict", body=json.dumps({"slide_ids": ids}))
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.close()
        if r.status != 200 or body["predictions"] != got:
            raise AssertionError(f"[dp-serve] cli.serve --data-parallel 2: "
                                 f"{r.status}, rows differ from the two-shard "
                                 "session's")
        if tfa.masked_flash_attention_fwd.launches != 2 * per:
            raise AssertionError(f"[dp-serve] the HTTP request launched "
                                 f"{launch_counts(tfa)}")
    finally:
        cserve.make_server = real
        for srv in servers:
            srv.shutdown()
        th.join(60)
    print(f"[dp-serve] cli.serve --data-parallel 2{' --device cuda:0' if backend == 'gloo' else ''}: "
          f"POST /predict of {len(ids)} slides equals the two-shard session's "
          f"rows to the bit, #1 {2 * per} launches | {gpu}", flush=True)


# [seq]: sequence parallelism (`mesh_shape` [dp, sp > 1]): two ranks of one
# sequence group, both on cuda:0 over gloo (the script needs one card when
# run with no arguments; NCCL refuses two ranks on one card). gloo takes
# CUDA tensors in its collectives but aborts the process on one in
# `batch_isend_irecv`, so the ring's exchange crosses through page-locked
# host buffers (`SeqSharding.transport`) while #1-#3 run on the card. One
# launch of two ranks runs every job: the attention checks, the gradient
# steps, the training runs, the dropout step and `cli.evaluate`.
SEQ_GROUP_TIMEOUT_S = 120
SEQ_CHILD_TIMEOUT_S = 420
# The slice's shape at flagship width: 2 slides a batch, level-0 bags of
# 4096 patches (a 64 x 64 grid of 1024-d features, every cell tissue), 3
# levels (cut from 5: the deepest table is then a 256 x 256 grid, 256 MiB a
# slide in f32, where 5 levels would need 1024 x 1024, 4 GiB a slide).
SEQ_GRID = 64
SEQ_LEVELS = 3
SEQ_SLIDES = 6
# [seq-attn] at the level-0 shape: B 2, H 4, N = 4097 rows (the special
# token and 4096 patches) padded to 2 x 2049, D 32; batch 1's valid keys end
# inside rank 1's block, so the ring folds a partly masked block.
SEQ_ATTN_LENGTHS = (4097, 3001)
# Schedules vs the one-device kernel on the whole sequence, f32: the
# gathered schedule runs #1-#3 on the same rows and keys (only the
# reduce-scatter adds a sum of 2 terms: the bit, or an ulp); the ring folds
# two partials with `_combine` and sums dq over 2 steps, in f64 and rounded
# once (the partials differ from the one-device kernel's by a few f32 ulps):
# KERNEL_ATOL on outputs, BWD_RTOL of each gradient's own largest value.
# bf16: the ring rounds P against each block's own running max, so it is
# JAX's ring to the bit, not the one-device kernel: 5e-2 (JAX's
# `test_ring_bfloat16` bar) against the one-device result, on outputs and
# on each gradient relative to its own largest value (the gradients are
# about 1e-2 here, so a bar of max(1, largest) would be absolute and loose).
# Against its own plain version (the same schedule on the CPU through the
# same group) the bf16 flash bar on outputs (FLASH_BF16_ULPS,
# FLASH_BF16_CHANGED), and on gradients SEQ_BF16_GRAD_RTOL (torch's bf16
# rtol) of each gradient's own largest value: each rank's partial is within
# the kernels' bf16 bar of its plain version, and the sum over the ranks
# (the reduce-scatter, the ring's rotating accumulators) adds one more bf16
# rounding, so the two differ by a few bf16 ulps (2^-8) of the largest
# partial. Element by element, an element whose partials cancel keeps their
# absolute error, which a relative bar cannot hold.
SEQ_BF16_ATOL = 5e-2
SEQ_BF16_GRAD_RTOL = 1.6e-2
# [seq-bf16]: the bf16 configuration (`compute_dtype` and `table_dtype`
# "bfloat16") under [1, 2] at the flagship's five levels and full width: 2
# slides of 64 x 64 level-0 patches, so the deepest grid is 1024 x 1024 and
# a slide holds 1,396,736 cells over the five levels (2.66 GiB at 1024-d in
# 16 bits; written as f16, cast to bf16 at collation). Each rank holds the
# batch's fused tables (about 5.3 GiB) on cuda:0. Bars as [bf16]'s: whole-
# model gradients are no yardstick in bf16, so each step is held where the
# kernels are (every launch against its plain version, BF16_FAULTS planted
# in the schedule's backward must fail it), its loss against one process's
# bf16 step at BF16_LOSS_RTOL, and each gradient tensor's distance from one
# process's at SEQ_BF16_STEP_NORM of its `grad_norm_scale` (JAX's
# `test_ring_bfloat16` bar, on whole tensors: an ulp's change of an
# attention output moves an element behind a ReLU or a cancelling sum by
# many ulps, a tensor's norm by the few the schedules' sums add); hazards,
# kernel route vs plain route under the same schedule, at BF16_PRED_ATOL.
# The bf16 `cli.train` runs take the 3-level [seq-train] store (its f32
# features cast at collation).
SEQ_BF16_LEVELS = 5
SEQ_BF16_SLIDES = 2
SEQ_BF16_STEP_NORM = 5e-2
# [seq-train] one step's world-summed gradients (each rank's loss scaled by
# 1 / sp, then one all-reduce) against one process's on the same batch from
# the same weights: `grad_mismatch` (GRAD_RTOL of each tensor's own largest
# gradient), since the two differ by summation order only; a factor-of-sp
# error would move them by half or more.
# [seq-train] against one process on the same store from the same weights:
# the ranks' loss differs by summation order only (LOSS_RTOL); [seq-eval]:
# the c-index exactly, the loss within CLI_EVAL_RTOL.

SEQ_CHILD = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from paths_tpu_torch.runtime import maybe_init_distributed
from paths_tpu_torch.kernels import flash_attention as tfa
from paths_tpu_torch.parallel import seq_attention as sa
from paths_tpu_torch.train import loop
spec_path, out_dir = sys.argv[2:4]
with open(spec_path) as f:
    spec = json.load(f)
maybe_init_distributed("gloo", "cuda:0", timeout=float(spec["timeout"]))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rank = dist.get_rank()
KERNELS = (tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
           tfa.masked_flash_attention_bwd_dkv)


def reset():
    torch.cuda.synchronize()
    for f in KERNELS:
        f.launches = 0


def counts():
    torch.cuda.synchronize()
    return [f.launches for f in KERNELS]


def digest(params):
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def attn(job):
    with np.load(job["inputs"]) as f:
        inp = dict(f)
    res, arrays = {}, {}
    for impl in ("gathered", "ring"):
        sh = sa.SeqSharding(None, impl)
        res["transport"] = sh.transport("cuda:0")
        m = inp["q"].shape[2] // sh.size
        rows = slice(sh.index * m, (sh.index + 1) * m)
        lengths = torch.from_numpy(inp["lengths"]).cuda()
        for dt, dtype, block_k in (("f32", torch.float32, 128),
                                   ("bf16", torch.bfloat16, 512)):
            host = [torch.from_numpy(inp[n][:, :, rows].copy()).to(dtype)
                    for n in ("q", "k", "v", "dout")]
            q, k, v = (t.cuda().requires_grad_() for t in host[:3])
            dout = host[3].cuda()
            reset()
            out = sh.attend(q, k, v, lengths, block_k)
            out.backward(dout)
            c = counts()
            arrays[f"{impl}_{dt}_out"] = out.detach().float().cpu().numpy()
            for n, t in zip("qkv", (q, k, v)):
                arrays[f"{impl}_{dt}_d{n}"] = t.grad.float().cpu().numpy()
            # the warm forward + backward, synchronised (gloo through host
            # memory, and the other rank on the same card)
            walls = []
            for _ in range(3):
                for t in (q, k, v):
                    t.grad = None
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sh.attend(q, k, v, lengths, block_k).backward(dout)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            res[f"{impl}_{dt}"] = {"launches": c, "ms": walls}
            if dt == "bf16":
                # the same schedule on CPU tensors: the kernels' plain versions
                pqkv = [t.detach().requires_grad_() for t in host[:3]]
                plain = sh.attend(*pqkv, lengths.cpu(), block_k)
                plain.backward(host[3])
                arrays[f"{impl}_bf16_plain_out"] = plain.detach().float().numpy()
                for n, t in zip("qkv", pqkv):
                    arrays[f"{impl}_bf16_plain_d{n}"] = t.grad.float().numpy()
    # planted fault: the ring's second step folded with the block length of
    # the wrong source rank
    sh = sa.SeqSharding(None, "ring")
    m = inp["q"].shape[2] // sh.size
    rows = slice(sh.index * m, (sh.index + 1) * m)
    qkv = [torch.from_numpy(inp[n][:, :, rows].copy()).cuda() for n in "qkv"]
    real, calls = sa._block_lengths, []

    def wrong(lengths, src, m):
        calls.append(src)
        return real(lengths, (src + 1) % sh.size if len(calls) == 2 else src, m)

    sa._block_lengths = wrong
    try:
        with torch.no_grad():
            bad = sh.attend(*qkv, torch.from_numpy(inp["lengths"]).cuda(), 128)
    finally:
        sa._block_lengths = real
    arrays["ring_fault_out"] = bad.cpu().numpy()
    np.savez(os.path.join(out_dir, f"attn_rank{rank}.npz"), **arrays)
    return res


def train(job):
    seen, steps = {}, []
    real = loop.make_step_fns

    def spy(config, optimizer, mesh=None):
        seen["opt"] = optimizer
        update, evaluate = real(config, optimizer, mesh)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = update(*args, **kwargs)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed, evaluate

    loop.make_step_fns = spy
    try:
        from paths_tpu_torch.cli.train import main
        reset()
        stats = main(["-m", job["dir"], "--no-wandb", "--device", "cuda:0"])
        c = counts()
    finally:
        loop.make_step_fns = real
    params = [p for g in seen["opt"].param_groups for p in g["params"]]
    return {"loss": stats["train_loss"][1], "epoch_s": stats["epoch_wall_s"][1],
            "steps_ms": steps, "launches": c, "params": digest(params)}


def first_step(job):
    import chip_smoke
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.parallel.mesh import mesh_from_config
    mesh = mesh_from_config(Config.load(job["dir"]))
    grads = job.get("grads") and os.path.join(
        out_dir, f"{job['name']}_grads_rank{rank}.npz")
    reset()
    res = chip_smoke.seq_first_step(torch, job["dir"], mesh, grads)
    return {**res, "launches": counts()}


def bf16_step(job):
    import chip_smoke
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.parallel.mesh import mesh_from_config
    mesh = mesh_from_config(Config.load(job["dir"]))
    return chip_smoke.seq_bf16_step(torch, tfa, job, mesh, os.path.join(
        out_dir, f"{job['name']}_{{}}_grads_rank{rank}.npz"))


def evaluate(job):
    from paths_tpu_torch.cli.evaluate import main
    reset()
    metrics = main(["-m", job["dir"], "--split", "test", "--device", "cuda:0"])
    return {"metrics": metrics, "launches": counts()}


results = {"rank": rank, "backend": str(dist.get_backend())}
for job in spec["jobs"]:
    t0 = time.perf_counter()
    results[job["name"]] = {**globals()[job["kind"]](job),
                            "wall_s": time.perf_counter() - t0}
print("DP_RANK " + json.dumps(results), flush=True)   # what run_ranks reads
"""


def expected_seq_launches(cfg, splits, sp):
    """#1-#3 launches of one rank's `cli.train` run under [1, sp], from the
    code: as `expected_train_launches`, but level 0's decoder layers run the
    group's schedule: one launch each under "gathered", sp under "ring"."""
    bs = cfg.batch_size[0]
    n_train, n_val, n_test = (len(d) if d is not None else 0 for d in splits)
    steps = math.ceil(n_train / bs) * cfg.num_epochs
    val_passes = cfg.num_epochs // cfg.eval_epochs if n_val else 0
    forwards = steps + val_passes * math.ceil(n_val / bs) + math.ceil(n_test / bs)
    layers = cfg.model_config.trans_layers
    level0 = sp if cfg.seq_attention == "ring" else 1
    per = layers * (cfg.num_levels - 1) + layers * level0
    return [per * forwards, per * steps, per * steps]


def bf16_agreement(got, want):
    """(worst difference in bf16 ulps of its row's largest output, share of
    outputs that differ at all) of two bf16 results held as f32 arrays."""
    import numpy as np

    diff = np.abs(got - want)
    row = np.abs(want).max(-1, keepdims=True)
    ulp = np.ldexp(np.ones_like(row), np.frexp(row)[1] - 8)
    return float((diff / ulp).max()), float((got != want).mean())


def copy_config(cfg, **changes):
    """A copy of a port `Config` with `changes` set."""
    from paths_tpu_torch.config import Config

    c = Config(**cfg.to_dict())
    for k, v in changes.items():
        setattr(c, k, v)
    return c


def seq_first_step(torch, model_dir, mesh=None, grads_to=None):
    """One `train_loop` update on the first 2 training slides of
    `model_dir`'s store from its saved weights, on cuda:0: under `mesh` (a
    rank of a sequence group) this rank's level-0 block, else the whole
    bags. Returns the loss, the parameters' digest and the step's peak
    device memory above what was allocated before it (MiB); `grads_to`, an
    npz path, gets the gradients the step applied (summed over the world:
    the config clips none)."""
    import hashlib

    import numpy as np

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train import loop
    from paths_tpu_torch.train.state import load_state

    cfg = Config.load(model_dir)
    if cfg.clip_grad_norm:
        raise AssertionError("[seq-train] the step's config clips gradients")
    model = RecursiveModel(cfg).to("cuda:0")
    opt = loop.make_optimizer(cfg, model.parameters())
    model, opt, _ = load_state(model_dir, model, opt)
    train, _, _ = tdata.load_splits([0.7, 0.15, 0.15], cfg.seed, cfg)
    idx = list(range(cfg.batch_size[0]))
    bag, tables = tdata.collate_batch(train, idx,
                                      level0_bucket=cfg.level0_bucket,
                                      pads=train.global_pads(), device="cuda:0",
                                      seq=loop.seq_block(mesh))
    labels = tdata.labels_on(train, idx, "cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(
        loop.dropout_seed(cfg, mesh))
    update, _ = loop.make_step_fns(cfg, opt, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = update(model, bag, tables, labels, gen, epoch=1)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    if grads_to:
        np.savez(grads_to, **{n: p.grad.cpu().numpy()
                              for n, p in model.named_parameters()
                              if p.grad is not None})
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return {"loss": float(loss), "params": h.hexdigest(), "peak_mib": peak}


def bulk_signal_store(root, cfg, num_slides, grid, seed=0):
    """A signal store (`data.synthetic.make_signal_store`'s layout: every
    cell tissue, slide i's rows shifted by z_i along one direction) made in
    bulk at full size: level 0's rows are drawn afresh (no two alike, so its
    top-K sees no exact tie), the deeper levels' are gathered from a pool of
    65536 such rows. Returns (ids, z)."""
    import numpy as np

    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import signal_direction_z

    store = FeatureStore(root, create=True)
    rng = np.random.default_rng(seed)
    d = cfg.model_config.patch_embed_dim
    direction, z = signal_direction_z(rng, d, num_slides)
    pool = rng.standard_normal((1 << 16, d), dtype=np.float32)
    ids = []
    for i in range(num_slides):
        sid = f"SYN-{i:04d}-01Z-00"
        ids.append(sid)
        shift = (z[i] * direction).astype(np.float32)
        shifted = (pool + shift).astype(np.float16)
        for lvl, power in enumerate(cfg.power_levels()):
            h = w = grid * 2 ** lvl
            if lvl == 0:
                rows = (rng.standard_normal((h * w, d), dtype=np.float32)
                        + shift).astype(np.float16)
            else:
                rows = shifted[rng.integers(0, len(pool), h * w)]
            store.save(sid, power, rows.reshape(h, w, d))
    return ids, z


def seq_bf16_store(torch, seq_cfg):
    """The [seq-bf16] store and model directories at five levels (one
    process, [1, 2] on each schedule), and the bf16 `cli.train` directories
    on the 3-level [seq-train] store `seq_cfg`'s; all from JAX's seed-0
    initial weights (`fresh_model`)."""
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.synthetic import make_signal_metadata
    from paths_tpu_torch.models.jax_init import fresh_model
    from paths_tpu_torch.train.state import save_state

    bf16 = {"compute_dtype": "bfloat16", "table_dtype": "bfloat16"}
    cfg = Config.load(os.path.join(ROOT, "models", "brca_paths_0"),
                      test_mode=True)
    if cfg.num_levels != SEQ_BF16_LEVELS:
        raise AssertionError(f"[seq-bf16] brca_paths_0 has {cfg.num_levels} "
                             f"levels, not {SEQ_BF16_LEVELS}")
    cfg = copy_config(cfg, preprocess_dir=os.path.join(WORK, "seq_bf16_store"),
                      csv_path=os.path.join(WORK, "seq_bf16_meta.csv"),
                      hipt_splits=False, batch_size=[2] * SEQ_BF16_LEVELS,
                      num_epochs=1, attention_impl="pallas", **bf16)
    cfg.model_config.dropout = 0.0
    t0 = time.perf_counter()
    ids, z = bulk_signal_store(cfg.preprocess_dir, cfg, SEQ_BF16_SLIDES,
                               SEQ_GRID)
    make_signal_metadata(cfg.csv_path, ids, z, seed=0)
    cells = sum((SEQ_GRID * 2 ** lvl) ** 2 for lvl in range(SEQ_BF16_LEVELS))
    gib = cells * cfg.model_config.patch_embed_dim * 2 / 2 ** 30
    written = time.perf_counter() - t0
    model = fresh_model(cfg, 0)
    dirs = {}
    for name, changes in (("one", {}),
                          ("gathered", {"mesh_shape": [1, 2]}),
                          ("ring", {"mesh_shape": [1, 2],
                                    "seq_attention": "ring"})):
        dirs[name] = os.path.join(WORK, f"seq_bf16_{name}")
        copy_config(cfg, **changes).save(dirs[name])
        save_state(dirs[name], model)
    model3 = fresh_model(seq_cfg, 0)
    for name, changes in (("train_one", {}),
                          ("train_gathered", {"mesh_shape": [1, 2]}),
                          ("train_ring", {"mesh_shape": [1, 2],
                                          "seq_attention": "ring"})):
        dirs[name] = os.path.join(WORK, f"seq_bf16_{name}")
        copy_config(seq_cfg, **bf16, **changes).save(dirs[name])
        save_state(dirs[name], model3)
    print(f"[seq-bf16] store: {len(ids)} slides of {SEQ_GRID} x {SEQ_GRID} "
          f"level-0 patches, {SEQ_BF16_LEVELS} levels (deepest grid "
          f"{SEQ_GRID * 2 ** (SEQ_BF16_LEVELS - 1)} x "
          f"{SEQ_GRID * 2 ** (SEQ_BF16_LEVELS - 1)}), {cells} cells a slide, "
          f"{gib:.2f} GiB a slide in 16 bits, written in {written:.1f} s",
          flush=True)
    return cfg, ids, dirs


def seq_bf16_step(torch, tfa, job, mesh=None, grads_to=None):
    """[seq-bf16]'s checks on one process or one rank of `mesh`: the 2-slide
    batch of `job["dir"]`'s store collated once (this rank's level-0 block),
    then for each schedule of `job` one bf16 AdamW step from the saved
    weights with every #1-#3 launch recorded and held against its plain
    version, its loss, launches and parameters' digest (and the gradients
    into `grads_to.format(schedule)`); under a mesh also the BF16_FAULTS
    planted in the schedule's backward, and the hazards of a no-grad
    forward on the kernel and the plain route."""
    import hashlib

    import numpy as np

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.engine.hierarchy import end2end_loss
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.parallel import seq_attention as sa
    from paths_tpu_torch.train import loop
    from paths_tpu_torch.train.state import load_state

    cfg = Config.load(job["dir"])
    t0 = time.perf_counter()
    ds = SlideDataset(job["ids"], cfg, FeatureStore(cfg.preprocess_dir))
    bag, tables = collate_batch(ds, [0, 1], level0_bucket=cfg.level0_bucket,
                                device="cuda:0", seq=loop.seq_block(mesh))
    torch.cuda.synchronize()
    collate_s = time.perf_counter() - t0
    table_gib = sum(t.fts.numel() * t.fts.element_size()
                    for t in tables) / 2 ** 30
    labels = {"survival_bin": torch.tensor([1, 2], device="cuda:0"),
              "censored": torch.tensor([0, 1], device="cuda:0"),
              "weight": torch.ones(2, device="cuda:0")}

    def model_and_step(c):
        model = RecursiveModel(c).to("cuda:0")
        opt = loop.make_optimizer(c, model.parameters())
        model, opt, _ = load_state(job["dir"], model, opt)
        return model, loop.make_step_fns(c, opt, mesh)[0]

    res = {"collate_s": collate_s, "table_gib": table_gib}
    for schedule in job["schedules"]:
        c = copy_config(cfg, seq_attention=schedule)
        model, update = model_and_step(c)
        for f in (tfa.masked_flash_attention_fwd,
                  tfa.masked_flash_attention_bwd_dq,
                  tfa.masked_flash_attention_bwd_dkv):
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded(tfa, sa) as log:
            loss, _ = update(model, bag, tables, labels, epoch=1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launched = [f.launches for f in (
                tfa.masked_flash_attention_fwd,
                tfa.masked_flash_attention_bwd_dq,
                tfa.masked_flash_attention_bwd_dkv)]
            agreement = launch_agreement(tfa, log)
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError("[seq-bf16] a step left a parameter off f32")
        np.savez(grads_to.format(schedule),
                 **{n: p.grad.float().cpu().numpy()
                    for n, p in model.named_parameters() if p.grad is not None})
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        out = {"loss": float(loss), "launches": launched, "step_ms": wall,
               "agreement": agreement, "params": h.hexdigest()}
        if mesh is not None:
            out["faults"] = {}
            for label, fault in BF16_FAULTS.items():
                model, update = model_and_step(c)
                with planted_fault(tfa, fault, sa), recorded(tfa, sa) as log:
                    update(model, bag, tables, labels, epoch=1)
                    out["faults"][label] = launch_agreement(tfa, log)[2]
            model, _ = model_and_step(c)
            seq = sa.SeqSharding.from_mesh(mesh, schedule)
            hazards = {}
            with torch.no_grad():
                for impl in ("pallas", "xla"):
                    _, aux = end2end_loss(
                        model, copy_config(c, attention_impl=impl), bag,
                        tables, labels, seq_mesh=seq)
                    hazards[impl] = aux["pred"].float().cpu().numpy()
            out["hazard_diff"] = float(np.abs(hazards["pallas"]
                                              - hazards["xla"]).max())
            out["hazards"] = hazards["pallas"].tolist()
        out["warm"] = warm_steps(torch, c, model_and_step, bag, tables, labels)
        res[schedule] = out
        del model
    return res


def warm_steps(torch, cfg, model_and_step, bag, tables, labels):
    """A warm step's wall between CUDA events, its kernels' device time and
    busy share, in bf16 and in f32 on the same batch (the tables widened on
    the card): {"bf16" | "f32": {"ms", "kernel_ms", "busy"}}."""
    import dataclasses

    f32 = copy_config(cfg, compute_dtype="float32", table_dtype="float32")
    wide = (dataclasses.replace(
        bag, fts=bag.fts.float(), ctx_slide=bag.ctx_slide.float(),
        ctx_patch=bag.ctx_patch.float()),
        [dataclasses.replace(t, fts=t.fts.float()) for t in tables])
    out = {}
    for name, c, (b, t) in (("bf16", cfg, (bag, tables)), ("f32", f32, wide)):
        model, update = model_and_step(c)

        def step():
            update(model, b, t, labels, epoch=1)

        step()
        ms = cuda_ms(step, iters=2, warmup=0)
        kernel = device_ms(step, iters=1, attempts=1)
        out[name] = {"ms": ms, "kernel_ms": kernel, "busy": kernel / ms}
        del model
    return out


def seq_store(torch, gpu):
    """The [seq] store and model directories: one process (no mesh), [1, 2]
    on each schedule, and one process and [1, 2] at the published
    dropout."""
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.synthetic import (
        make_signal_metadata,
        make_signal_store,
    )
    from paths_tpu_torch.models.jax_init import fresh_model
    from paths_tpu_torch.train.state import save_state

    cfg = Config.load(os.path.join(ROOT, "models", "brca_paths_0"),
                      test_mode=True)
    published = cfg.model_config.dropout
    cfg.preprocess_dir = os.path.join(WORK, "seq_store")
    cfg.csv_path = os.path.join(WORK, "seq_meta.csv")
    cfg.hipt_splits = False
    cfg.num_levels, cfg.top_k_patches = SEQ_LEVELS, cfg.top_k_patches[:SEQ_LEVELS - 1]
    cfg.batch_size = [2] * SEQ_LEVELS
    cfg.num_epochs, cfg.attention_impl = 1, "pallas"
    cfg.model_config.dropout = 0.0
    t0 = time.perf_counter()
    ids, z = make_signal_store(cfg.preprocess_dir, cfg, num_slides=SEQ_SLIDES,
                               base_hw=(SEQ_GRID, SEQ_GRID), seed=0,
                               tissue_fraction=1.0, size_jitter=1)
    make_signal_metadata(cfg.csv_path, ids, z, seed=0)
    print(f"[seq-train] store: {len(ids)} slides of {SEQ_GRID} x {SEQ_GRID} "
          f"level-0 patches, {SEQ_LEVELS} levels (deepest grid "
          f"{SEQ_GRID * 4} x {SEQ_GRID * 4}), "
          f"{cfg.model_config.patch_embed_dim}-d f32, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # JAX's seed-0 initial weights, what a new run trains from
    model = fresh_model(cfg, 0)
    dirs = {}
    for name, changes in (("one", {}),
                          ("gathered", {"mesh_shape": [1, 2]}),
                          ("ring", {"mesh_shape": [1, 2],
                                    "seq_attention": "ring"}),
                          ("one_dropout", {}),
                          ("dropout", {"mesh_shape": [1, 2]})):
        c = copy_config(cfg, **changes)
        if name.endswith("dropout"):
            c.model_config.dropout = published
        dirs[name] = os.path.join(WORK, f"seq_{name}")
        c.save(dirs[name])
        save_state(dirs[name], model)
    return cfg, dirs


def seq_phases(torch, tfa, gpu):
    """[seq-attn], [seq-train], [seq-eval]: see the [seq] note above.
    Returns rank 0's #1-#3 launches of the two training runs, for the
    kernels line."""
    import numpy as np

    from paths_tpu_torch.cli.evaluate import main as evaluate_main
    from paths_tpu_torch.cli.train import main as train_main
    from paths_tpu_torch.data.dataset import load_splits
    from paths_tpu_torch.models.batch import seq_block_width
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.state import load_model, save_state

    cfg, dirs = seq_store(torch, gpu)
    splits = load_splits([0.7, 0.15, 0.15], cfg.seed, cfg)
    cfg16, ids16, dirs16 = seq_bf16_store(torch, cfg)
    one16_grads = os.path.join(WORK, "seq_bf16_one_{}_grads.npz")
    one16 = seq_bf16_step(torch, tfa, {"dir": dirs16["one"], "ids": ids16,
                                       "schedules": ["gathered"]},
                          None, one16_grads)
    torch.cuda.empty_cache()
    reset_counts(tfa)
    one16_run = train_main(["-m", dirs16["train_one"], "--no-wandb"])

    # one process's first step (its gradients; at the published dropout its
    # peak memory), then its run of the same store, from the same weights
    one_grads = os.path.join(WORK, "seq_one_grads.npz")
    one_step = seq_first_step(torch, dirs["one"], None, one_grads)
    one_drop = seq_first_step(torch, dirs["one_dropout"])
    reset_counts(tfa)
    t0 = time.perf_counter()
    one = train_main(["-m", dirs["one"], "--no-wandb"])
    torch.cuda.synchronize()
    one_s, one_counts = time.perf_counter() - t0, launch_counts(tfa)

    # [seq-attn] inputs and the one-device kernels on the whole sequence
    n = 2 * seq_block_width(SEQ_GRID * SEQ_GRID, 2)
    gen = torch.Generator().manual_seed(0)
    inp = {name: torch.randn(2, cfg.model_config.trans_heads, n,
                             cfg.model_config.trans_dim
                             // cfg.model_config.trans_heads, generator=gen)
           for name in ("q", "k", "v", "dout")}
    inp["lengths"] = torch.tensor(SEQ_ATTN_LENGTHS, dtype=torch.int32)
    inputs = os.path.join(WORK, "seq_attn_inputs.npz")
    np.savez(inputs, **{k: v.numpy() for k, v in inp.items()})
    want = {}
    for dt, dtype, block_k in (("f32", torch.float32, 128),
                               ("bf16", torch.bfloat16, 512)):
        q, k, v = (inp[x].cuda().to(dtype).detach().requires_grad_()
                   for x in "qkv")
        lengths = inp["lengths"].cuda()
        out = tfa.masked_flash_attention(q, k, v, lengths, block_k)
        out.backward(inp["dout"].cuda().to(dtype))
        want[dt] = {"out": out.detach().float().cpu().numpy(),
                    **{f"d{x}": t.grad.float().cpu().numpy()
                       for x, t in zip("qkv", (q, k, v))}}
        # the one-device call's time, for the [seq-attn] line
        want[dt]["ms"] = cuda_ms(lambda: tfa.masked_flash_attention(
            q, k, v, lengths, block_k).backward(inp["dout"].cuda().to(dtype)),
            3, warmup=1)
    del q, k, v, out

    spec = os.path.join(WORK, "seq_jobs.json")
    out_dir = os.path.join(WORK, "seq_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(spec, "w") as f:
        json.dump({"timeout": SEQ_GROUP_TIMEOUT_S, "jobs": [
            {"kind": "attn", "name": "attn", "inputs": inputs},
            # the steps before the runs: these write the trained weights
            {"kind": "first_step", "name": "step_gathered", "grads": True,
             "dir": dirs["gathered"]},
            {"kind": "first_step", "name": "step_ring", "grads": True,
             "dir": dirs["ring"]},
            {"kind": "train", "name": "gathered", "dir": dirs["gathered"]},
            {"kind": "train", "name": "ring", "dir": dirs["ring"]},
            {"kind": "first_step", "name": "dropout", "dir": dirs["dropout"]},
            {"kind": "evaluate", "name": "evaluate", "dir": dirs["gathered"]},
            {"kind": "bf16_step", "name": "bf16", "dir": dirs16["gathered"],
             "ids": ids16, "schedules": ["gathered", "ring"]},
            {"kind": "train", "name": "bf16_train_gathered",
             "dir": dirs16["train_gathered"]},
            {"kind": "train", "name": "bf16_train_ring",
             "dir": dirs16["train_ring"]}]}, f)
    t0 = time.perf_counter()
    ranks = run_ranks(SEQ_CHILD, [[spec, out_dir]] * 2, SEQ_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"[seq] rank {r['rank']} ran over "
                                 f"{r['backend']}, not gloo")

    # ------------------------------------------------------------ seq-attn
    blocks = []
    for r in range(2):
        with np.load(os.path.join(out_dir, f"attn_rank{r}.npz")) as f:
            blocks.append(dict(f))
    got = {key: np.concatenate([b[key] for b in blocks], axis=2)
           for key in blocks[0]}
    lines, failed = [], []
    for impl in ("gathered", "ring"):
        per = 1 if impl == "gathered" else 2
        for dt in ("f32", "bf16"):
            w = want[dt]
            err = float(np.abs(got[f"{impl}_{dt}_out"] - w["out"]).max())
            gerr = max(float(np.abs(got[f"{impl}_{dt}_d{x}"] - w[f"d{x}"]).max())
                       / float(np.abs(w[f"d{x}"]).max()) for x in "qkv")
            out_bar, grad_bar = ((KERNEL_ATOL, BWD_RTOL) if dt == "f32"
                                 else (SEQ_BF16_ATOL, SEQ_BF16_ATOL))
            if not (err <= out_bar and gerr <= grad_bar):
                failed.append(f"{impl} {dt} against the one-device kernels")
            launched = [r["attn"][f"{impl}_{dt}"]["launches"] for r in ranks]
            if launched != [[per] * 3] * 2:
                failed.append(f"{impl} {dt} launched #1-#3 {launched} on the "
                              f"two ranks, the code says {[per] * 3}")
            extra = ""
            if dt == "bf16":
                ulps, changed = bf16_agreement(got[f"{impl}_bf16_out"],
                                               got[f"{impl}_bf16_plain_out"])
                gplain = max(
                    float(np.abs(got[f"{impl}_bf16_d{x}"]
                                 - got[f"{impl}_bf16_plain_d{x}"]).max())
                    / float(np.abs(got[f"{impl}_bf16_plain_d{x}"]).max())
                    for x in "qkv")
                if not (ulps <= FLASH_BF16_ULPS and changed <= FLASH_BF16_CHANGED
                        and gplain <= SEQ_BF16_GRAD_RTOL):
                    failed.append(f"{impl} bf16 against its plain version")
                extra = (f"; against its plain version (the same schedule on "
                         f"the CPU) {ulps:.3g} bf16 ulps of a row's largest "
                         f"(allowed {FLASH_BF16_ULPS}), {changed:.5f} of the "
                         f"outputs changed (allowed {FLASH_BF16_CHANGED}), "
                         f"dq/dk/dv {gplain:.3g} of their own largest (bar "
                         f"{SEQ_BF16_GRAD_RTOL})")
            ms = [f"{t:.1f}" for t in ranks[0]["attn"][f"{impl}_{dt}"]["ms"]]
            lines.append(
                f"[seq-attn] {impl} {dt} (B 2, H 4, N {n} = 2 x {n // 2}, "
                f"D 32, lengths {list(SEQ_ATTN_LENGTHS)}): out {err:.3g} (bar "
                f"{out_bar}), dq/dk/dv {gerr:.3g} of their own largest (bar "
                f"{grad_bar}) against the one-device kernels{extra}; #1-#3 "
                f"launches per rank {launched[0]} (the code says {[per] * 3}); "
                f"forward + backward {', '.join(ms)} ms wall a rank "
                f"(synchronised; the one-device kernels {w['ms']:.2f} ms) | "
                f"{gpu}")
    fault = float(np.abs(got["ring_fault_out"] - want["f32"]["out"]).max())
    if not fault > 100 * KERNEL_ATOL:
        failed.append(f"the planted fault (ring step 2 folded with the wrong "
                      f"block length) was not caught: {fault:.3g}")
    for line in lines:
        print(line, flush=True)
    if failed:
        raise AssertionError("[seq-attn] " + "; ".join(failed))
    print(f"[seq-attn] 2 ranks on cuda:0, transport "
          f"{ranks[0]['attn']['transport']}; planted fault (the ring's second "
          f"step folded with the other block's length) differs by {fault:.3g}:"
          f" caught | {gpu}", flush=True)

    # ----------------------------------------------------------- seq-train
    want_g = {k: torch.from_numpy(v) for k, v in np.load(one_grads).items()}
    for name in ("gathered", "ring"):
        job = f"step_{name}"
        g = [dict(np.load(os.path.join(out_dir, f"{job}_grads_rank{r}.npz")))
             for r in range(2)]
        for k, v in g[0].items():
            if not np.array_equal(g[1][k], v):
                raise AssertionError(f"[seq-train] {job}: the ranks' summed "
                                     f"gradients of {k} differ")
        ratio, worst = grad_mismatch(
            {k: torch.from_numpy(v) for k, v in g[0].items()}, want_g)
        rel = max(abs(r[job]["loss"] - one_step["loss"]) / abs(one_step["loss"])
                  for r in ranks)
        if not (ratio <= 1.0 and rel <= LOSS_RTOL):
            raise AssertionError(
                f"[seq-train] {job}: gradients at {ratio:.3g} of the limit "
                f"({worst}), loss rel {rel:.3g}, against one process")
        # one forward and backward: each decoder layer launches once a
        # level, level 0's sp times under the ring
        layers = cfg.model_config.trans_layers
        per = layers * (cfg.num_levels - 1) + layers * (
            2 if name == "ring" else 1)
        for r in ranks:
            if r[job]["launches"] != [per] * 3:
                raise AssertionError(f"[seq-train] {job} rank {r['rank']} "
                                     f"launched {r[job]['launches']}, the "
                                     f"code says {[per] * 3}")
        print(f"[seq-train] one step, seq_attention {name}: the world-summed "
              f"gradients (loss / 2 on each rank, one all-reduce) equal on "
              f"both ranks and against one process's at {ratio:.3g} of the "
              f"limit (GRAD_RTOL {GRAD_RTOL} of each tensor's largest; worst "
              f"{worst}); loss rel {rel:.3g}; #1-#3 launches per rank "
              f"{ranks[0][job]['launches']} as the code says | {gpu}",
              flush=True)
    want_loss = one["train_loss"][1]
    train_launches = [0, 0, 0]
    for name in ("gathered", "ring"):
        c = copy_config(cfg, mesh_shape=[1, 2], seq_attention=name)
        expect = expected_seq_launches(c, splits, 2)
        for r in ranks:
            res = r[name]
            rel = abs(res["loss"] - want_loss) / abs(want_loss)
            if not rel <= LOSS_RTOL:
                raise AssertionError(f"[seq-train] {name} rank {r['rank']}: "
                                     f"epoch-1 loss {res['loss']} vs one "
                                     f"process {want_loss} ({rel:.3g})")
            if res["launches"] != expect:
                raise AssertionError(f"[seq-train] {name} rank {r['rank']} "
                                     f"launched {res['launches']}, the code "
                                     f"says {expect}")
        if ranks[0][name]["params"] != ranks[1][name]["params"]:
            raise AssertionError(f"[seq-train] {name}: the ranks' parameters "
                                 "differ after the epoch")
        train_launches = [a + b for a, b in
                          zip(train_launches, ranks[0][name]["launches"])]
        rel = max(abs(r[name]["loss"] - want_loss) / abs(want_loss)
                  for r in ranks)
        print(f"[seq-train] cli.train mesh_shape [1, 2] seq_attention {name}, "
              f"2 ranks on cuda:0 over gloo: {len(splits[0])} train slides, "
              f"{len(ranks[0][name]['steps_ms'])} steps of 2 slides of "
              f"{SEQ_GRID * SEQ_GRID} patches ({n // 2} level-0 rows a rank); "
              f"epoch-1 loss {ranks[0][name]['loss']:.9f} vs one process "
              f"{want_loss:.9f} (rel {rel:.3g}, rtol {LOSS_RTOL}); parameters "
              f"equal to the bit on both ranks (sha256 "
              f"{ranks[0][name]['params'][:12]}); #1-#3 launches per rank "
              f"{ranks[0][name]['launches']} as the code says (one process: "
              f"{list(one_counts.values())}); steps "
              f"{', '.join(f'{t:.1f}' for t in ranks[0][name]['steps_ms'])} "
              f"ms, epoch {ranks[0][name]['epoch_s']:.2f} s a rank, against "
              f"one process's epoch {one['epoch_wall_s'][1]:.2f} s | {gpu}",
              flush=True)
    drop = [r["dropout"] for r in ranks]
    if drop[0]["params"] != drop[1]["params"]:
        raise AssertionError("[seq-train] dropout 0.05: the ranks' parameters "
                             "differ after one step")
    if any(d["launches"] != [0, 0, 0] for d in drop):
        raise AssertionError(f"[seq-train] dropout 0.05 launched kernels: "
                             f"{[d['launches'] for d in drop]}")
    if not math.isfinite(drop[0]["loss"]):
        raise AssertionError(f"[seq-train] dropout step loss {drop[0]['loss']}")
    print(f"[seq-train] one step at the published dropout 0.05 (the plain "
          f"route, K/V gathered over the group): loss {drop[0]['loss']:.6f}, "
          f"parameters equal to the bit on both ranks (sha256 "
          f"{drop[0]['params'][:12]}), no kernel launched; peak device memory "
          f"of the step above its inputs {drop[0]['peak_mib']:.1f} / "
          f"{drop[1]['peak_mib']:.1f} MiB a rank, one process "
          f"{one_drop['peak_mib']:.1f} MiB (kernel route at dropout 0: "
          f"{ranks[0]['step_gathered']['peak_mib']:.1f} a rank, one process "
          f"{one_step['peak_mib']:.1f}); the launch of both ranks took "
          f"{wall:.1f} s, the one-process run {one_s:.1f} s | {gpu}",
          flush=True)

    # ------------------------------------------------------------ seq-eval
    d = os.path.join(WORK, "seq_eval_one")
    c = copy_config(cfg)
    c.save(d)
    save_state(d, load_model(dirs["gathered"], RecursiveModel(c)))
    reset_counts(tfa)
    want_eval = evaluate_main(["-m", d, "--split", "test"])
    got_eval = [r["evaluate"]["metrics"] for r in ranks]
    if got_eval[0] != got_eval[1]:
        raise AssertionError(f"[seq-eval] the ranks differ: {got_eval}")
    key = "test_c-index"
    rel = abs(got_eval[0]["test_loss"] - want_eval["test_loss"]) / abs(
        want_eval["test_loss"])
    if got_eval[0][key] != want_eval[key] or not rel <= CLI_EVAL_RTOL:
        raise AssertionError(f"[seq-eval] {got_eval[0]} vs one process "
                             f"{want_eval}")
    print(f"[seq-eval] cli.evaluate mesh_shape [1, 2] (gathered) on the "
          f"trained checkpoint: {got_eval[0]} against one process's "
          f"{want_eval} (c-index equal, loss rel {rel:.3g}, rtol "
          f"{CLI_EVAL_RTOL}); #1-#3 launches per rank "
          f"{ranks[0]['evaluate']['launches']}; {ranks[0]['evaluate']['wall_s']:.1f}"
          f" s a rank | {gpu}", flush=True)
    seq_bf16_checks(torch, gpu, cfg16, dirs16, one16, one16_grads, one16_run,
                    splits, ranks, out_dir)
    for name in ("bf16_train_gathered", "bf16_train_ring"):
        train_launches = [a + b for a, b in
                          zip(train_launches, ranks[0][name]["launches"])]
    return train_launches


def grad_norm_scale(grads, name):
    """What a gradient tensor's distance from one process's is a share of
    (numpy arrays by parameter name): its norm; a key bias's, the model's
    largest gradient norm (its gradient is rounding noise); a query or key
    projection's, its attention block's largest (their cotangents pass
    through the softmax's centring, dS = P (dP - delta), so they are small
    beside v's and out's while their rounding is the block's)."""
    import numpy as np

    if name.endswith(".k.bias"):
        return max(np.linalg.norm(g) for g in grads.values())
    block, proj, _ = name.rsplit(".", 2)
    if proj in ("q", "k") and block.endswith("attn"):
        return max(np.linalg.norm(g) for n, g in grads.items()
                   if n.startswith(block + "."))
    return np.linalg.norm(grads[name])


def seq_bf16_checks(torch, gpu, cfg, dirs, one, one_grads, one_run, splits,
                    ranks, out_dir):
    """[seq-bf16]: see the note above SEQ_BF16_LEVELS. `one` is one
    process's `seq_bf16_step` (gradients in `one_grads`), `one_run` its bf16
    `cli.train` run on the 3-level store whose `splits` the ranks' runs
    share."""
    import numpy as np

    from paths_tpu_torch.config import Config

    want = dict(np.load(one_grads.format("gathered")))
    batch, one = one, one["gathered"]
    rank_batch = ranks[0]["bf16"]
    layers = cfg.model_config.trans_layers
    for schedule in ("gathered", "ring"):
        res = [r["bf16"][schedule] for r in ranks]
        failed = []
        per = layers * (cfg.num_levels - 1) + layers * (
            2 if schedule == "ring" else 1)
        if any(r["launches"] != [per] * 3 for r in res):
            failed.append(f"launches {[r['launches'] for r in res]}, the code "
                          f"says {[per] * 3}")
        if res[0]["params"] != res[1]["params"]:
            failed.append("the ranks' parameters differ after the step")
        rel = abs(res[0]["loss"] - one["loss"]) / abs(one["loss"])
        if not rel <= BF16_LOSS_RTOL:
            failed.append(f"loss {res[0]['loss']} vs one process "
                          f"{one['loss']} ({rel:.3g})")
        grads = [dict(np.load(os.path.join(
            out_dir, f"bf16_{schedule}_grads_rank{r}.npz"))) for r in (0, 1)]
        if any(not np.array_equal(grads[1][k], v) for k, v in grads[0].items()):
            failed.append("the ranks' summed gradients differ")
        if sorted(grads[0]) != sorted(want):
            failed.append("gradients reach other tensors than one process's")
        norm = max((float(np.linalg.norm(grads[0][k] - w)
                          / max(grad_norm_scale(want, k), 1e-30)), k)
                   for k, w in want.items() if k in grads[0])
        if not norm[0] <= SEQ_BF16_STEP_NORM:
            failed.append(f"gradient {norm[1]} at {norm[0]:.3g} of its norm "
                          f"from one process's")
        ulps = max(r["agreement"][0] for r in res)
        changed = max(r["agreement"][1] for r in res)
        ratio = max(r["agreement"][2] for r in res)
        if not (ulps <= FLASH_BF16_ULPS and changed <= FLASH_BF16_CHANGED
                and ratio <= 1.0):
            failed.append(f"launches against their plain versions: forward "
                          f"{ulps:.3g} ulps, {changed:.5f} changed; backward "
                          f"{ratio:.3g} x its limit")
        faults = {label: min(r["faults"][label] for r in res)
                  for label in BF16_FAULTS}
        for label, worst in faults.items():
            if not worst > 1.0:
                failed.append(f"planted fault ({label}) passes: {worst:.3g} x "
                              "its limit")
        hz = max(r["hazard_diff"] for r in res)
        if not hz <= BF16_PRED_ATOL:
            failed.append(f"hazards kernel vs plain route {hz:.3g}")
        if failed:
            raise AssertionError(f"[seq-bf16] {schedule}: " + "; ".join(failed))
        print(f"[seq-bf16] one bf16 AdamW step under [1, 2], seq_attention "
              f"{schedule}, {cfg.num_levels} levels at full width, 2 ranks on "
              f"cuda:0: loss {res[0]['loss']:.6f} vs one process "
              f"{one['loss']:.6f} (rel {rel:.3g}, rtol {BF16_LOSS_RTOL:.4g}); "
              f"gradients equal on both ranks, worst tensor {norm[0]:.3g} of "
              f"its norm from one process's ({norm[1]}; bar "
              f"{SEQ_BF16_STEP_NORM}); parameters equal to the bit (sha256 "
              f"{res[0]['params'][:12]}); #1-#3 launches per rank "
              f"{res[0]['launches']} as the code says; each launch against "
              f"its plain version: forward {ulps:.3g} ulps, {changed:.5f} "
              f"changed, dq/dk/dv {ratio:.3g} x their limit; planted faults "
              f"caught ({', '.join(f'{k} {v:.3g} x' for k, v in faults.items())}"
              f"); hazards kernel vs plain route {hz:.3g} (atol "
              f"{BF16_PRED_ATOL:.4g}); collate {rank_batch['collate_s']:.1f} s "
              f"({rank_batch['table_gib']:.2f} GiB of tables a rank), first "
              f"step {res[0]['step_ms']:.1f} ms a rank (one process "
              f"{one['step_ms']:.1f} ms, collate {batch['collate_s']:.1f} s, "
              f"{batch['table_gib']:.2f} GiB) | {gpu}", flush=True)
        print(f"[seq-bf16] warm step, seq_attention {schedule}, rank 0 / one "
              f"process, wall between CUDA events (kernels, busy share): "
              + "; ".join(
                  f"{dt} {res[0]['warm'][dt]['ms']:.1f} ms "
                  f"({res[0]['warm'][dt]['kernel_ms']:.2f} ms, "
                  f"{res[0]['warm'][dt]['busy']:.3f}) / "
                  f"{one['warm'][dt]['ms']:.1f} ms "
                  f"({one['warm'][dt]['kernel_ms']:.2f} ms, "
                  f"{one['warm'][dt]['busy']:.3f})" for dt in ("bf16", "f32"))
              + f" | {gpu}", flush=True)
    want_loss = one_run["train_loss"][1]
    for schedule in ("gathered", "ring"):
        name = f"bf16_train_{schedule}"
        c = Config.load(dirs[f"train_{schedule}"])
        expect = expected_seq_launches(c, splits, 2)
        rel = max(abs(r[name]["loss"] - want_loss) / abs(want_loss)
                  for r in ranks)
        failed = []
        if any(r[name]["launches"] != expect for r in ranks):
            failed.append(f"launches {[r[name]['launches'] for r in ranks]}, "
                          f"the code says {expect}")
        if ranks[0][name]["params"] != ranks[1][name]["params"]:
            failed.append("the ranks' parameters differ after the epoch")
        if not rel <= BF16_LOSS_RTOL:
            failed.append(f"epoch-1 loss rel {rel:.3g} to one process's")
        if failed:
            raise AssertionError(f"[seq-bf16] {name}: " + "; ".join(failed))
        print(f"[seq-bf16] cli.train bf16 mesh_shape [1, 2] seq_attention "
              f"{schedule} on the 3-level [seq-train] store: epoch-1 loss "
              f"{ranks[0][name]['loss']:.6f} vs one process {want_loss:.6f} "
              f"(rel {rel:.3g}, rtol {BF16_LOSS_RTOL:.4g}); parameters equal "
              f"to the bit on both ranks (sha256 "
              f"{ranks[0][name]['params'][:12]}); #1-#3 launches per rank "
              f"{ranks[0][name]['launches']} as the code says; steps "
              f"{', '.join(f'{t:.1f}' for t in ranks[0][name]['steps_ms'])} ms"
              f" a rank, epoch {ranks[0][name]['epoch_s']:.2f} s (one process "
              f"{one_run['epoch_wall_s'][1]:.2f} s) | {gpu}", flush=True)


def http_phase(torch, tfa, gpu, sl):
    """`cli.serve.make_server` over the [slice] session on 127.0.0.1, serving
    in a thread: every route, a 32-slide request against `session.predict`,
    its latency beside the session's own in turns, and four concurrent
    clients."""
    import http.client
    import threading

    from paths_tpu_torch.cli.serve import make_server

    sess, ids = sl["sess"], sl["ids"]
    server = make_server(sess, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection(host, port, timeout=300)
        try:
            conn.request(method, path,
                         body=None if body is None else json.dumps(body))
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    try:
        status, health = call("GET", "/healthz")
        if status != 200 or not health["ok"] or health["device"] != "cuda":
            raise AssertionError(f"[http] /healthz: {status} {health}")
        status, listing = call("GET", "/slides")
        if status != 200 or listing["slide_ids"] != sess.slide_ids:
            raise AssertionError(f"[http] /slides: {status}")
        want = sess.predict(ids)
        reset_counts(tfa)
        status, out = call("POST", "/predict", {"slide_ids": ids})
        per = sl["cfg"].model_config.trans_layers * sl["cfg"].num_levels
        if status != 200 or out["predictions"] != want:
            raise AssertionError(f"[http] POST /predict of {len(ids)} slides: "
                                 f"{status}, rows differ from session.predict's")
        if tfa.masked_flash_attention_fwd.launches != per:
            raise AssertionError(f"[http] a request launched {launch_counts(tfa)}")
        http_ms, sess_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            call("POST", "/predict", {"slide_ids": ids})
            http_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            sess.predict(ids)
            sess_ms.append((time.perf_counter() - t0) * 1e3)

        results, errors = {}, []

        def worker(wid):
            try:
                req = [ids[(wid * 3 + k) % len(ids)] for k in range(3)]
                results[wid] = (req, call("POST", "/predict",
                                          {"slide_ids": req}))
            except Exception as e:        # noqa: BLE001 — reported below
                errors.append((wid, e))

        threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if errors or len(results) != 4:
            raise AssertionError(f"[http] concurrent clients: {errors}")
        for req, (status, out) in results.values():
            if status != 200 or out["predictions"] != sess.predict(req):
                raise AssertionError("[http] a concurrent request got other "
                                     "rows than session.predict's")
        status, m = call("GET", "/metrics")
        if (m["requests"], m["errors"], m["slides_predicted"]) != \
                (10, 0, 4 * len(ids) + 12):    # the /metrics call not counted
            raise AssertionError(f"[http] /metrics: {m}")
    finally:
        server.shutdown()
        server.server_close()
    print(f"[http] make_server on {host}:{port}: /healthz, /slides, /metrics "
          f"answer; POST /predict of {len(ids)} slides equals session.predict "
          f"to the bit and launches #1 {per} times; 4 concurrent clients get "
          f"their rows; metrics {m} | {gpu}", flush=True)
    print(f"[http] {len(ids)}-slide request in turns: HTTP "
          f"{', '.join(f'{t:.1f}' for t in http_ms)} ms, session.predict "
          f"{', '.join(f'{t:.1f}' for t in sess_ms)} ms (the difference is "
          f"the HTTP and JSON cost) | {gpu}", flush=True)


# [heatmap]: the kernel route's per-depth importances and final logits vs
# the plain attention route's on the same encoder features: the serving
# path's hazard bar (the flash kernel's per-layer differences, 2e-5, through
# 2 decoder layers a level). The kept children must be equal unless the gap
# between the K-th and (K+1)-th importance is under the same bar.
HEATMAP_ATOL = 1e-4
# heatmap_from_store vs the fused session's forward on the same slide: the
# same kernels on the same values, padded to other widths (the session pads
# to the store's maxima), which may change the f32 GEMMs' summation order.
STORE_IMP_ATOL = 1e-5
# A blob slide this wide at objective power 10: level 0 (0.625x) is a 6 x 6
# grid of 256-px patches, of which the disc covers 24 or more.
HEATMAP_SIDE = 24576
# Level-0 features of the int8 and fused1 routes vs fused's, per patch, as
# |x_route - x_fused|_2 / |x_fused|_2: each route is held to the plain route
# within FEATURE_RTOL_BF16 (fused, fused1) or FEATURE_RTOL_INT8 (int8) in
# [preprocess], so two routes differ by at most the sum of their bars. Their
# level-0 importances: importance_p depends on patch p's features alone
# (LSTM, then MLP, then sigmoid), so |imp_route - imp_fused| is bounded to
# first order by |grad_x imp_p| |x_route - x_fused|; the check allows
# IMP_TAYLOR times that (the second-order term: sigmoid's curvature and the
# MLP's kinks), measured on the run's own features and gradients.
HEATMAP_FEATURE_RTOL = {"fused1": 2 * FEATURE_RTOL_BF16,
                        "int8": FEATURE_RTOL_BF16 + FEATURE_RTOL_INT8}
IMP_TAYLOR = 2.0


def write_uni_weights(torch, path):
    """UNI's `vit_init(0)` with LayerScale 1, saved as a timm state dict for
    `--weights`: the init's LayerScale of 1e-5 leaves every patch nearly the
    class token's feature, so importances would tie and the recursion would
    keep the lowest indices; at 1 the random blocks tell patches apart."""
    from paths_tpu_torch.encoders import vit

    m = vit.vit_init(0, vit.UNI)
    p, d = m.spec.patch_size, m.spec.embed_dim
    sd = {"patch_embed.proj.weight":
          m.patch_embed.weight.reshape(d, p, p, 3).permute(0, 3, 1, 2),
          "patch_embed.proj.bias": m.patch_embed.bias,
          "cls_token": m.cls_token.reshape(1, 1, d),
          "pos_embed": m.pos_embed[None],
          "norm.weight": m.norm.weight, "norm.bias": m.norm.bias}
    for i, blk in enumerate(m.blocks):
        for mod, key in ((blk.norm1, "norm1"), (blk.qkv, "attn.qkv"),
                         (blk.proj, "attn.proj"), (blk.norm2, "norm2"),
                         (blk.fc1, "mlp.fc1"), (blk.fc2, "mlp.fc2")):
            sd[f"blocks.{i}.{key}.weight"] = mod.weight
            sd[f"blocks.{i}.{key}.bias"] = mod.bias
        sd[f"blocks.{i}.ls1.gamma"] = sd[f"blocks.{i}.ls2.gamma"] = torch.ones(d)
    torch.save({k: v.detach().contiguous() for k, v in sd.items()}, path)


def heatmap_phase(torch, tfa, tvf, gpu, sl):
    """A raw blob slide through `cli.heatmap` with UNI on `--block-impl
    fused` (on-the-fly encoding at each depth, then the processor on the
    kernel route), held to the plain attention route on the same features;
    `--slide-id` on the [slice] store against the session's forward; the
    `int8` and `fused1` encoders once each."""
    import copy

    import numpy as np

    from paths_tpu_torch.cli.heatmap import main as heatmap_main
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import collate_batch
    from paths_tpu_torch.encoders import registry, vit
    from paths_tpu_torch.engine.hierarchy import end2end_forward
    from paths_tpu_torch.models.batch import PatchBag
    from paths_tpu_torch.models.recursive import RecursiveModel, recursive_apply
    from paths_tpu_torch.train.state import load_model
    from paths_tpu_torch.viz import heatmap as hm

    try:
        import matplotlib  # noqa: F401 — only whether the host can draw
        draw = True
    except ImportError as e:
        draw, why = False, str(e)
    mdir = sl["dirs"]["pallas"]
    cfg = Config.load(mdir, test_mode=True)
    slide = os.path.join(WORK, "heatmap_slide.npy")
    t0 = time.perf_counter()
    make_blob_slide(slide, HEATMAP_SIDE, seed=0)
    weights = os.path.join(WORK, "uni_ls1.pt")
    write_uni_weights(torch, weights)
    print(f"[heatmap] blob slide of {HEATMAP_SIDE} x {HEATMAP_SIDE} px at "
          f"objective power 10 ({os.path.getsize(slide) / 2**30:.2f} GiB) and "
          "UNI weights (vit_init(0), LayerScale 1) written in "
          f"{time.perf_counter() - t0:.1f} s | {gpu}", flush=True)

    def recorded(encode, calls):
        def rec(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = encode(x)
            torch.cuda.synchronize()
            calls.append((x, y, (time.perf_counter() - t0) * 1e3))
            return y
        return rec

    calls, encoders, init_s = [], [], []
    real_from_name = registry.from_name

    def from_name(*args, **kwargs):
        t0 = time.perf_counter()
        encode, dim, tspec = real_from_name(*args, **kwargs)
        init_s.append(time.perf_counter() - t0)
        encoders.append(encode)
        return recorded(encode, calls), dim, tspec

    def predicted(slides, **kernels):
        """Launch counts the code gives: #1 once per decoder layer per
        depth; each named ViT kernel once per block per encoded batch."""
        batches = sum(math.ceil(len(s.locs) / 256) for s in slides)
        per = cfg.model_config.trans_layers * cfg.num_levels
        return {"masked_flash_attention_fwd": per,
                "masked_flash_attention_bwd_dq": 0,
                "masked_flash_attention_bwd_dkv": 0,
                **vit_expect(tvf, **{k: vit.UNI.depth * batches
                                     for k in kernels})}

    pdf = os.path.join(WORK, "heatmap.pdf")
    log = []
    reset_counts(tfa)
    reset_vit_counts(tvf)
    torch.cuda.reset_peak_memory_stats()
    registry.from_name = from_name
    t0 = time.perf_counter()
    try:
        # without matplotlib the CLI runs the recursion and draws nothing
        with timed(torch, hm, ["run_recursion", "heatmap_slide"], log):
            heatmap_main(["-m", mdir, "-s", slide, "-o", pdf,
                          "--weights", weights, "--block-impl", "fused",
                          "--no-camelyon", "--default-power", "10"])
    finally:
        registry.from_name = real_from_name
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**launch_counts(tfa), **vit_counts(tvf)}
    peak = torch.cuda.max_memory_allocated() / 2**20
    rec_ms, (slides, imps, logits) = log[0][1], log[0][3]
    sizes = [len(s.locs) for s in slides]
    want = predicted(slides, fused_attn_block=1, fused_mlp_block=1)
    if counts != want:
        raise AssertionError(f"[heatmap] launches {counts}, the code says {want}")
    big = slides[0].view_at_power(cfg.base_power)
    canvas = hm.folded_importance(slides, imps, cfg.model_config.patch_size,
                                  big.shape[:2])
    if not (sizes[0] >= 24 and all(np.isfinite(i).all() and (i >= 0).all()
                                   and (i <= 1).all() for i in imps)
            and np.isfinite(logits).all() and logits.shape == (1, cfg.nbins)
            and np.isfinite(canvas).all() and (canvas > 0).any()):
        raise AssertionError(f"[heatmap] bags {sizes}, logits {logits}")
    if draw and not os.path.getsize(pdf) > 1000:
        raise AssertionError(f"[heatmap] {pdf} was not written")
    enc_ms = sum(c[2] for c in calls)
    print(f"[heatmap] per-depth bag sizes {sizes}; launches #1 "
          f"{counts['masked_flash_attention_fwd']}, #4 "
          f"{counts['fused_attn_block']}, #5 {counts['fused_mlp_block']} (the "
          f"code says {want['masked_flash_attention_fwd']}, "
          f"{want['fused_attn_block']}, {want['fused_mlp_block']}); logits "
          f"{logits[0].round(4).tolist()}", flush=True)
    render = (f"render {log[1][1] - rec_ms:.0f} ms ({os.path.getsize(pdf) / 1024:.0f}"
              " KiB PDF)" if draw else "no figure")
    print(f"[heatmap] cli.heatmap UNI --block-impl fused: {wall:.1f} s wall "
          f"(encoder load {init_s[0]:.1f} s); recursion {rec_ms:.0f} ms, of "
          f"which encode {enc_ms:.0f} ms in {len(calls)} batches; {render}; "
          f"torch.cuda.max_memory_allocated {peak:.0f} MiB | {gpu}", flush=True)
    if not draw:
        print(f"[heatmap] figure not drawn: {why} on this host; that is host "
              "rendering (matplotlib), not the device path, which ran in full",
              flush=True)

    # the plain attention route on the same encoder features
    model = load_model(mdir, RecursiveModel(cfg)).cuda().eval()
    fused_calls, step = list(calls), [0]

    def replay(x):
        k = step[0]
        step[0] += 1
        if k < len(fused_calls) and torch.equal(x, fused_calls[k][0]):
            return fused_calls[k][1]
        return encoders[0](x)

    plain = copy.deepcopy(cfg)
    plain.attention_impl = "xla"
    reset_counts(tfa)
    xs, xi, xl = hm.run_recursion(plain, model, replay, slide, camelyon=False,
                                  default_power=10.0, verbose=False)
    if any(launch_counts(tfa).values()):
        raise AssertionError(f"[heatmap] the plain route launched {launch_counts(tfa)}")
    worst, gaps = [], []
    for d in range(cfg.num_levels):
        if d:
            top = np.sort(imps[d - 1])[::-1]
            k = cfg.top_k_patches[d - 1]
            gaps.append(float(top[k - 1] - top[k]) if len(top) > k else None)
        if not np.array_equal(slides[d].locs, xs[d].locs):
            if gaps[-1] is None or gaps[-1] >= HEATMAP_ATOL:
                raise AssertionError(f"[heatmap] depth {d}: the routes keep "
                                     f"other children (top-K gap {gaps[-1]})")
            print(f"[heatmap] depth {d}: the routes keep other children, the "
                  f"top-K gap {gaps[-1]:.3g} is under {HEATMAP_ATOL}", flush=True)
            break
        worst.append(float(np.abs(imps[d] - xi[d]).max()))
    # importances come from the LSTM and MLP of each patch and do not see
    # the attention; the logits do (through the slide context of every level)
    logit_diff = (float(np.abs(logits - xl).max())
                  if len(worst) == cfg.num_levels else None)
    if max(worst) > HEATMAP_ATOL or (logit_diff or 0.0) > HEATMAP_ATOL:
        raise AssertionError(f"[heatmap] kernel vs plain importances {worst}, "
                             f"logits {logit_diff}")
    print(f"[heatmap] kernel route vs plain attention on the same features: "
          f"max |importance diff| per depth {[f'{w:.3g}' for w in worst]}, "
          f"final logits {logit_diff if logit_diff is None else f'{logit_diff:.3g}'}"
          f" (atol {HEATMAP_ATOL}); gap between the K-th and (K+1)-th "
          f"importance per depth "
          f"{[f'{g:.3g}' if g is not None else '-' for g in gaps]}", flush=True)

    # --slide-id: the [slice] store against the fused session's forward
    sess, sid = sl["sess"], sl["ids"][0]
    log = []
    reset_counts(tfa)
    t0 = time.perf_counter()
    with timed(torch, hm, ["recursion_from_store"], log):
        heatmap_main(["-m", mdir, "--slide-id", sid, "-o",
                      os.path.join(WORK, "heatmap_store.pdf")])
    store_s = time.perf_counter() - t0
    per = cfg.model_config.trans_layers * cfg.num_levels
    if tfa.masked_flash_attention_fwd.launches != per:
        raise AssertionError(f"[heatmap] --slide-id launched {launch_counts(tfa)}")
    s_slides, s_imps = log[0][3]
    bag, tables = collate_batch(sess._dataset, [sess._index[sid]],
                                level0_bucket=sess.config.level0_bucket,
                                pads=sess._pads, device="cuda")
    with torch.inference_mode():
        outs = end2end_forward(sess.model, sess.config, bag, tables)
    diff = 0.0
    for s_, i_, o in zip(s_slides, s_imps, outs):
        valid = o["bag"].mask[0].cpu().numpy()
        if not np.array_equal(s_.locs, o["bag"].locs[0].cpu().numpy()[valid]):
            raise AssertionError("[heatmap] --slide-id visits other patches "
                                 "than the session's forward")
        diff = max(diff, float(np.abs(i_ - o["importance"][0].float().cpu()
                                      .numpy()[valid]).max()))
    if diff > STORE_IMP_ATOL:
        raise AssertionError(f"[heatmap] --slide-id importances vs the session's "
                             f"forward: {diff:.3g}")
    print(f"[heatmap] cli.heatmap --slide-id {sid} ([slice] store) in "
          f"{store_s:.1f} s: bag sizes {[len(s_.locs) for s_ in s_slides]}, "
          f"per-depth importances vs the fused session's forward on that slide "
          f"{diff:.3g} (atol {STORE_IMP_ATOL}) | {gpu}", flush=True)

    # the int8 and fused1 encoders: level-0 features and importances vs fused
    n0 = sizes[0]
    x_fused = fused_calls[0][1][:n0].float()
    ds_dim, dp_dim = cfg.model_config.ctx_dim()
    x = x_fused.clone().requires_grad_(True)
    lv0 = PatchBag(fts=x[None], mask=torch.ones((1, n0), dtype=torch.bool,
                                               device="cuda"),
                   locs=torch.from_numpy(slides[0].locs)[None].cuda(),
                   parent_inds=torch.arange(n0, device="cuda")[None],
                   ctx_slide=torch.zeros((1, 0, ds_dim), device="cuda"),
                   ctx_patch=torch.zeros((1, n0, 0, dp_dim), device="cuda"))
    recursive_apply(model, plain, 0, lv0)["importance"].sum().backward()
    grad = x.grad.norm(dim=-1).cpu().numpy()
    del x, lv0
    for impl, kernels in (("int8", dict(fused_attn_block_i8=1,
                                        fused_mlp_block_i8=1)),
                          ("fused1", dict(fused_block=1))):
        encode, _, _ = registry.from_name("UNI", weights_path=weights,
                                          block_impl=impl)
        rc = []
        reset_counts(tfa)
        reset_vit_counts(tvf)
        t0 = time.perf_counter()
        r_slides, r_imps, _ = hm.run_recursion(cfg, model, recorded(encode, rc),
                                               slide, camelyon=False,
                                               default_power=10.0, verbose=False)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        counts = {**launch_counts(tfa), **vit_counts(tvf)}
        want = predicted(r_slides, **kernels)
        if counts != want:
            raise AssertionError(f"[heatmap] {impl}: launches {counts}, the "
                                 f"code says {want}")
        dx = (rc[0][1][:n0].float() - x_fused).norm(dim=-1).cpu().numpy()
        feat = float((dx / x_fused.norm(dim=-1).cpu().numpy()).max())
        imp_diff = np.abs(r_imps[0] - imps[0])
        ratio = float((imp_diff / (IMP_TAYLOR * grad * dx + 1e-7)).max())
        if feat > HEATMAP_FEATURE_RTOL[impl] or ratio > 1.0:
            raise AssertionError(f"[heatmap] {impl}: level-0 features {feat:.3g}"
                                 f" of their norm from fused's, importances at "
                                 f"{ratio:.3g} x their bar")
        print(f"[heatmap] --block-impl {impl}: recursion {rec_s:.1f} s, bag "
              f"sizes {[len(s_.locs) for s_ in r_slides]}, launches "
              + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
              + f" (the code says the same); level 0 vs fused: features "
              f"{feat:.3g} of their norm (bar {HEATMAP_FEATURE_RTOL[impl]:.3g}), "
              f"max |importance diff| {imp_diff.max():.3g}, at {ratio:.3g} x "
              f"its bar ({IMP_TAYLOR} |grad imp| |dx|) | {gpu}", flush=True)
        del encode, rc
    del calls, fused_calls, encoders
    os.remove(slide)
    return weights


def vit_wrappers(tvf):
    from paths_tpu_torch.kernels import vit_int8 as tvi

    return (tvf.fused_attn_block, tvf.fused_mlp_block, tvf.fused_swiglu_mlp_block,
            tvf.fused_block, tvi.fused_attn_block_i8, tvi.fused_mlp_block_i8,
            tvi.fused_swiglu_mlp_block_i8)


def vit_counts(tvf):
    return {f.__name__: f.launches for f in vit_wrappers(tvf)}


def reset_vit_counts(tvf):
    for f in vit_wrappers(tvf):
        f.launches = 0


def vit_expect(tvf, **launched):
    """Launch counts by wrapper name: those given, 0 for every other."""
    want = dict.fromkeys(vit_counts(tvf), 0)
    assert set(launched) <= set(want), launched
    return {**want, **launched}


def vit_bound(kind, b, n, d, hidden, dtype_bytes):
    """(operation-limited ms, byte-limited ms) of one fused block kernel on x
    (b, n, d): 2 operations per multiply-add of every product in the kernel's
    body, at the bf16 tensor-core rate for bf16 and the f32 CUDA-core rate for
    f32; bytes = x read once, out written once, every weight read once (in the
    compute dtype) and the small f32 vectors."""
    rows = b * n
    if kind == "attn":
        flops = 2.0 * rows * d * 3 * d + 2.0 * rows * d * d + 4.0 * b * n * n * d
        weights, vectors = 4 * d * d, 7 * d
    elif kind == "mlp":
        flops = 4.0 * rows * d * hidden
        weights, vectors = 2 * d * hidden, 4 * d + hidden
    else:   # packed SwiGLU: fc1 is (2 hidden, d)
        flops = 6.0 * rows * d * hidden
        weights, vectors = 3 * d * hidden, 4 * d + 2 * hidden
    nbytes = dtype_bytes * (2 * rows * d + weights) + 4.0 * vectors
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def vit_kernel_phase(torch, tvf, gpu):
    """Kernels #4-#6 against their plain versions, with planted faults, at
    the main path's shapes and one ragged small case; returns the bf16 case
    of each kernel at its main-path shape."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, scale=1.0, base=0.0):
        return (base + scale * torch.randn(*shape, generator=gen)).cuda()

    def library_attn(x, ns, nb, wq, bq, wp, bp, ls, heads):
        b, n, d = x.shape
        y = F.layer_norm(x, (d,), ns.to(x.dtype), nb.to(x.dtype), 1e-6)
        qkv = F.linear(y, wq, bq.to(x.dtype)).view(b, n, 3, heads, d // heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        return x + F.linear(o, wp, bp.to(x.dtype)) * ls.to(x.dtype)

    def library_mlp(x, ns, nb, w1, b1, w2, b2, ls, swiglu):
        d = x.shape[-1]
        y = F.layer_norm(x, (d,), ns.to(x.dtype), nb.to(x.dtype), 1e-6)
        h = F.linear(y, w1, b1.to(x.dtype))
        if swiglu:
            gate, val = h.chunk(2, dim=-1)
            h = F.silu(gate) * val
        else:
            h = F.gelu(h)
        return x + F.linear(h, w2, b2.to(x.dtype)) * ls.to(x.dtype)

    main_rows = {}
    # "ragged-h160": a hidden width that is no multiple of the gated fc1
    # tile's 64 units
    shapes = (("ragged", 3, 50, 128, 2, 512, ("attn", "mlp", "swiglu")),
              ("ragged-h160", 3, 131, 128, 2, 160, ("swiglu",)),
              ("uni", 64, 197, 1024, 16, 4096, ("attn", "mlp")),
              ("virchow2", 64, 261, 1280, 16, 3456, ("attn", "swiglu")),
              ("kaiko-b8", 64, 785, 768, 12, 3072, ("attn", "mlp")))
    for case, b, n, d, heads, hidden, kinds in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = rnd(b, n, d).to(dtype)
            # realistic scale: O(1) activations after every product, and
            # LayerScale about 1 so that an error in the branch shows
            ns, nb, ls = rnd(d, scale=0.1, base=1.0), rnd(d, scale=0.1), \
                rnd(d, scale=0.1, base=1.0)
            for kind in kinds:
                if kind == "attn":
                    wq, bq = rnd(3 * d, d, scale=d ** -0.5).to(dtype), rnd(3 * d, scale=0.1)
                    wp, bp = rnd(d, d, scale=d ** -0.5).to(dtype), rnd(d, scale=0.1)
                    args = (x, ns, nb, wq, bq, wp, bp, ls)
                    kernel = lambda a=args: tvf.fused_attn_block(*a, num_heads=heads)
                    plain = lambda a=args: tvf.fused_attn_block_reference(
                        *a, num_heads=heads)
                    library = lambda a=args: library_attn(*a, heads)
                    faulty_w = wp.clone()
                    faulty_w[:, 64:128] = 0       # head 1's context dropped
                    faults = [("one head's context zeroed",
                               lambda a=args, w=faulty_w: tvf.fused_attn_block_reference(
                                   *a[:5], w, *a[6:], num_heads=heads))]
                else:
                    packed = 2 if kind == "swiglu" else 1
                    w1 = rnd(packed * hidden, d, scale=d ** -0.5).to(dtype)
                    b1 = rnd(packed * hidden, scale=0.1)
                    w2, b2 = rnd(d, hidden, scale=hidden ** -0.5).to(dtype), rnd(d, scale=0.1)
                    args = (x, ns, nb, w1, b1, w2, b2, ls)
                    if kind == "swiglu":
                        kernel = lambda a=args: tvf.fused_swiglu_mlp_block(*a)
                        plain = lambda a=args: tvf.fused_swiglu_mlp_block_reference(*a)
                        faulty_w = w1.clone()     # value half shifted by one column
                        faulty_w[hidden:] = torch.roll(w1[hidden:], 1, dims=0)
                        # gate and value halves swapped: silu(value) gate, what
                        # a pairing error in the gated epilogue would give
                        swapped_w = torch.cat([w1[hidden:], w1[:hidden]])
                        swapped_b = torch.cat([b1[hidden:], b1[:hidden]])
                        faults = [
                            ("value half shifted by one column",
                             lambda a=args, w=faulty_w:
                             tvf.fused_swiglu_mlp_block_reference(*a[:3], w, *a[4:])),
                            ("gate and value halves swapped",
                             lambda a=args, w=swapped_w, bb=swapped_b:
                             tvf.fused_swiglu_mlp_block_reference(*a[:3], w, bb, *a[5:]))]
                    else:
                        kernel = lambda a=args: tvf.fused_mlp_block(*a)
                        plain = lambda a=args: tvf.fused_mlp_block_reference(*a)
                        faulty_w = w2.clone()     # the last hidden chunk dropped
                        faulty_w[:, -256:] = 0
                        faults = [("last 256 hidden columns dropped",
                                   lambda a=args, w=faulty_w:
                                   tvf.fused_mlp_block_reference(*a[:5], w, *a[6:]))]
                    library = lambda a=args: library_mlp(*a, kind == "swiglu")
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"vit {kind} {case} {dtype}: non-finite output")
                peak = want.float().abs().max().item()
                tol = VIT_F32_ATOL if dtype == torch.float32 else \
                    VIT_BF16_ULPS * 2.0 ** -8 * peak
                err = (got.float() - want.float()).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"vit {kind} {case} {dtype}: err "
                                         f"{err:.3g} > {tol:.3g}")
                if not torch.equal(got, kernel()):
                    raise AssertionError(f"vit {kind} {case} {dtype}: two calls differ")
                caught = []
                for fault, faulty in faults:
                    fault_err = (got.float() - faulty().float()).abs().max().item()
                    if not fault_err > tol:
                        raise AssertionError(f"vit {kind} {case} {dtype}: the check "
                                             f"passes a planted fault ({fault}): "
                                             f"{fault_err:.3g} <= {tol:.3g}")
                    caught.append(f"planted fault ({fault}) err {fault_err:.3g}: caught")
                del want
                # device time from the profiler's trace for the small case;
                # the 64-image cases run for milliseconds, where the time
                # between CUDA events is the device's
                timer = (lambda fn: cuda_ms(fn, 3, warmup=1)) if b > 8 else \
                    (lambda fn: device_ms(fn, 20))
                dev = {key: timer(fn) for key, fn in (
                    ("ms", kernel), ("plain_ms", plain), ("library_ms", library))}
                if not all(v > 0 for v in dev.values()):
                    raise AssertionError(f"vit {kind} {case}: a time was not "
                                         f"measured: {dev}")
                flop_ms, byte_ms = vit_bound(kind, b, n, d, hidden, x.element_size())
                tname = "f32" if dtype == torch.float32 else "bf16"
                print(f"[kernel] vit_{kind} {case}: B={b} N={n} D={d} heads={heads} "
                      f"H={hidden} {tname}: max_abs_err {err:.3g} (tol {tol:.3g}, "
                      f"max |out| {peak:.3g}); {'; '.join(caught)}; device ms: "
                      f"kernel {dev['ms']:.4f}, "
                      f"plain {dev['plain_ms']:.4f}, library calls "
                      f"{dev['library_ms']:.4f}; bound {max(flop_ms, byte_ms):.4f} "
                      f"(operations {flop_ms:.4f}, bytes {byte_ms:.4f}) | {gpu}",
                      flush=True)
                main_case = "virchow2" if kind == "swiglu" else "uni"
                if case == main_case and dtype == torch.bfloat16:
                    main_rows[kind] = dict(err=err, flop_ms=flop_ms,
                                           byte_ms=byte_ms, **dev)
    return main_rows


def i8_mismatch(got, want, tight):
    """(share of rows whose largest |got - want| is over `tight`, the largest
    |got - want| of any row, the share of elements that differ at all)."""
    diff = (got.float() - want.float()).abs()
    rows = diff.flatten(0, -2).amax(-1)
    return ((rows > tight).float().mean().item(), rows.max().item(),
            (diff > 0).float().mean().item())


def i8_passes(share, worst, changed, tight, quantum, bf16):
    return share <= I8_FLIP_SHARE and \
        worst <= max(tight, I8_LOOSE_QUANTA * quantum) and \
        (not bf16 or changed <= I8_BF16_CHANGED)


@contextlib.contextmanager
def rounding_half_up(tvi):
    """While inside, the plain versions quantise with round-half-up."""
    import torch

    rne = tvi._round
    tvi._round = lambda t: torch.floor(t + 0.5)
    try:
        yield
    finally:
        tvi._round = rne


# The pieces of the staged int8 kernels by a fragment of their kernel's
# name, in launch order: the first fragment that a kernel's name holds names
# its piece (any other kernel's time counts as "other"). Launches per call:
# one each, but #9's and #10's fc1 and quantiser run once per row slab
# ("slab").
I8_PIECES = {
    "attn_i8": (("ln_quant_rows", "LN-quant", 1), ("EpiQkvI8", "qkv GEMM", 1),
                ("attn_i8_", "attention", 1), ("quant_rows", "quantise", 1),
                ("EpiResidualI8", "proj GEMM", 1)),
    "mlp_i8": (("ln_quant_rows", "LN-quant", 1), ("EpiGeluI8", "fc1 GEMM", "slab"),
               ("quant_rows", "quantise", "slab"), ("EpiResidualI8", "fc2 GEMM", 1)),
    "swiglu_i8": (("ln_quant_rows", "LN-quant", 1), ("EpiSwigluI8", "fc1 GEMM", "slab"),
                  ("quant_rows", "quantise", "slab"), ("EpiResidualI8", "fc2 GEMM", 1)),
}


def piece_ms(fn, pieces, slabs: int, iters: int = 3):
    """(device ms of one call per piece, share of the call's launches the
    trace recorded). Each kernel goes to the first piece whose fragment its
    name holds; a piece's time is the mean of its recorded launches times its
    launches per call. The profiler's trace of a few back-to-back calls can
    lack some of their launches (the share it held is returned), so the mean
    per launch is what it gives."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_call = {label: slabs if n == "slab" else n for _, label, n in pieces}
    total, count = dict.fromkeys(per_call, 0.0), dict.fromkeys(per_call, 0)
    other = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.is_user_annotation:
            continue
        label = next((lb for key, lb, _ in pieces if key in e.key), None)
        if label is None:
            other += e.self_device_time_total / 1e3 / iters
            continue
        total[label] += e.self_device_time_total
        count[label] += e.count
    ms = {label: total[label] / count[label] / 1e3 * per_call[label]
          if count[label] else float("nan") for label in per_call}
    ms["other"] = other
    return ms, sum(count.values()) / (iters * sum(per_call.values()))


def vit_new_bound(kind, b, n, d, hidden, dtype_bytes):
    """(operation-limited ms, byte-limited ms) of kernels #7-#10 on x
    (b, n, d). Int8 projections at the int8 tensor-core rate, the attention's
    two products and every product of the whole-block kernel at the compute
    dtype's rate; bytes = x in, out, every weight once (int8 weights one byte
    an element plus an f32 scale per output channel)."""
    rows = b * n
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    attn_core = 4.0 * b * n * n * d
    if kind == "block":
        flops = 8.0 * rows * d * d + attn_core + 4.0 * rows * d * hidden
        nbytes = dtype_bytes * (2 * rows * d + 4 * d * d + 2 * d * hidden) + \
            4.0 * (11 * d + hidden)
        return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    if kind == "attn_i8":
        ops_ms = 8.0 * rows * d * d / PEAK_INT8_OPS + attn_core / peak
        weights, vectors = 4 * d * d, 11 * d
    elif kind == "mlp_i8":
        ops_ms = 4.0 * rows * d * hidden / PEAK_INT8_OPS
        weights, vectors = 2 * d * hidden, 5 * d + 2 * hidden
    else:   # packed SwiGLU
        ops_ms = 6.0 * rows * d * hidden / PEAK_INT8_OPS
        weights, vectors = 3 * d * hidden, 5 * d + 4 * hidden
    nbytes = dtype_bytes * 2 * rows * d + weights + 4.0 * vectors
    return ops_ms * 1e3, nbytes / PEAK_BYTES * 1e3


def vit_new_kernel_phase(torch, tvf, tvi, gpu):
    """Kernels #7 (whole block, one call) and #8-#10 (int8 blocks) against
    their plain versions at the main path's shapes, f32 and bf16, with
    planted faults; returns the bf16 case of each kernel at its main-path
    shape."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0, base=0.0):
        return (base + scale * torch.randn(*shape, generator=gen)).cuda()

    def quantized(w):
        return tvi.quantize_weight(w.float())

    def lib_linear_i8(y, wq):
        """One int8 product as library calls: quantise rows, `torch._int_mm`,
        rescale."""
        s = y.abs().amax(-1, keepdim=True) * (1.0 / 127.0)
        s = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)
        acc = torch._int_mm(q.reshape(-1, q.shape[-1]), wq["q"].t())
        return acc.view(*y.shape[:-1], -1).float() * s * wq["s"]

    def library_attn_i8(x, ns, nb, wqkv, wproj, bq, bp, ls, heads):
        b, n, d = x.shape
        y = F.layer_norm(x.float(), (d,), ns, nb, 1e-6)
        qkv = (lib_linear_i8(y, wqkv) + bq).to(x.dtype).view(b, n, 3, heads, d // heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        return (x.float() + (lib_linear_i8(o.float(), wproj) + bp) * ls).to(x.dtype)

    def library_mlp_i8(x, ns, nb, w1, b1, w2, b2, ls, swiglu):
        d = x.shape[-1]
        y = F.layer_norm(x.float(), (d,), ns, nb, 1e-6)
        h = lib_linear_i8(y, w1) + b1
        if swiglu:
            gate, val = h.chunk(2, dim=-1)
            h = F.silu(gate) * val
        else:
            h = F.gelu(h)
        return (x.float() + (lib_linear_i8(h, w2) + b2) * ls).to(x.dtype)

    def library_block(x, t, heads):
        d = x.shape[-1]
        cd = x.dtype
        at, ml = t["attn"], t["mlp"]
        y = F.layer_norm(x, (d,), t["norm1"]["scale"].to(cd), t["norm1"]["bias"].to(cd), 1e-6)
        b, n, _ = x.shape
        qkv = F.linear(y, at["qkv_w"], at["qkv_b"].to(cd)).view(b, n, 3, heads, d // heads)
        q, k, v = (u.transpose(1, 2) for u in qkv.unbind(2))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + F.linear(o, at["proj_w"], at["proj_b"].to(cd)) * t["ls1"].to(cd)
        y = F.layer_norm(x, (d,), t["norm2"]["scale"].to(cd), t["norm2"]["bias"].to(cd), 1e-6)
        h = F.gelu(F.linear(y, ml["fc1_w"], ml["fc1_b"].to(cd)))
        return x + F.linear(h, ml["fc2_w"], ml["fc2_b"].to(cd)) * t["ls2"].to(cd)

    def time_all(case, kind, calls):
        dev = {}
        for key, fn in calls.items():
            try:
                dev[key] = cuda_ms(fn, 3, warmup=1)
            except RuntimeError as err:
                if key != "library_ms":
                    raise
                # the yardstick only: this PyTorch's `_int_mm` may not take
                # the shape
                print(f"[kernel] vit_{kind} {case}: no library time "
                      f"({str(err).splitlines()[0][:120]})", flush=True)
                dev[key] = None
        if not all(v is None or v > 0 for v in dev.values()):
            raise AssertionError(f"vit {kind} {case}: a time was not measured: {dev}")
        return dev

    main_rows = {}
    shapes = (("uni", 64, 197, 1024, 16, 4096, ("block", "attn_i8", "mlp_i8")),
              # #8 takes head_dim 64 only: the shape before Virchow2's
              # published 16 heads of 80 and 2 x 3416
              ("virchow2-20x64", 64, 261, 1280, 20, 6912, ("attn_i8", "swiglu_i8")),
              ("kaiko-b8", 64, 785, 768, 12, 3072, ("block", "attn_i8", "mlp_i8")))
    for case, b, n, d, heads, hidden, kinds in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tname = "f32" if dtype == torch.float32 else "bf16"
            x = rnd(b, n, d).to(dtype)
            vec = lambda: (rnd(d, scale=0.1, base=1.0), rnd(d, scale=0.1),
                           rnd(d, scale=0.1, base=1.0))
            ns, nb, ls = vec()
            # LayerNorm output on exact ties of the quantiser: scale 0, bias
            # (m + 1/2) / 32 for integer m, its largest entry 127 / 32, so
            # that the row scale is exactly 1 / 32
            tie_ns = torch.zeros_like(ns)
            tie_nb = ((torch.arange(d, device="cuda") % 254) - 126.5) / 32.0
            tie_nb[0] = 127.0 / 32.0
            for kind in kinds:
                if kind == "block":
                    ns2, nb2, ls2 = vec()
                    tree = {
                        "norm1": {"scale": ns, "bias": nb},
                        "attn": {"qkv_w": rnd(3 * d, d, scale=d ** -0.5).to(dtype),
                                 "qkv_b": rnd(3 * d, scale=0.1),
                                 "proj_w": rnd(d, d, scale=d ** -0.5).to(dtype),
                                 "proj_b": rnd(d, scale=0.1)},
                        "norm2": {"scale": ns2, "bias": nb2},
                        "mlp": {"fc1_w": rnd(hidden, d, scale=d ** -0.5).to(dtype),
                                "fc1_b": rnd(hidden, scale=0.1),
                                "fc2_w": rnd(d, hidden, scale=hidden ** -0.5).to(dtype),
                                "fc2_b": rnd(d, scale=0.1)},
                        "ls1": ls, "ls2": ls2}
                    kernel = lambda t=tree: tvf.fused_block(x, t, num_heads=heads)
                    plain = lambda t=tree: tvf.fused_block_reference(x, t, num_heads=heads)
                    library = lambda t=tree: library_block(x, t, heads)
                    before = vit_counts(tvf)
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    after = vit_counts(tvf)
                    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                    if moved != {"fused_block": 1}:
                        raise AssertionError(f"vit block {case}: one call moved "
                                             f"the counters by {moved}")
                    peak = want.float().abs().max().item()
                    tol = VIT_F32_ATOL if dtype == torch.float32 else \
                        VIT_BF16_ULPS * 2.0 ** -8 * peak
                    err = (got.float() - want.float()).abs().max().item()
                    if not (torch.isfinite(got.float()).all() and err <= tol):
                        raise AssertionError(f"vit block {case} {tname}: err "
                                             f"{err:.3g} > {tol:.3g}")
                    if not torch.equal(got, kernel()):
                        raise AssertionError(f"vit block {case} {tname}: two calls differ")
                    faulty_tree = dict(tree, attn=dict(tree["attn"]))
                    faulty_w = tree["attn"]["proj_w"].clone()
                    faulty_w[:, 64:128] = 0       # head 1's context dropped
                    faulty_tree["attn"]["proj_w"] = faulty_w
                    fault_err = (got.float() - tvf.fused_block_reference(
                        x, faulty_tree, num_heads=heads).float()).abs().max().item()
                    if not fault_err > tol:
                        raise AssertionError(f"vit block {case} {tname}: the check "
                                             f"passes a planted fault: {fault_err:.3g}")
                    del want
                    dev = time_all(case, kind, {"ms": kernel, "plain_ms": plain,
                                                "library_ms": library})
                    flop_ms, byte_ms = vit_new_bound(kind, b, n, d, hidden,
                                                     x.element_size())
                    print(f"[kernel] vit_block {case}: B={b} N={n} D={d} heads={heads} "
                          f"H={hidden} {tname}, one call: max_abs_err {err:.3g} (tol "
                          f"{tol:.3g}, max |out| {peak:.3g}); planted fault (one head's "
                          f"context zeroed) err {fault_err:.3g}: caught; device ms: "
                          f"kernel {dev['ms']:.4f}, plain {dev['plain_ms']:.4f}, "
                          f"library calls {dev['library_ms']:.4f}; bound "
                          f"{max(flop_ms, byte_ms):.4f} (operations {flop_ms:.4f}, "
                          f"bytes {byte_ms:.4f}) | {gpu}", flush=True)
                    if case == "uni" and dtype == torch.bfloat16:
                        main_rows[kind] = dict(err=err, flop_ms=flop_ms,
                                               byte_ms=byte_ms, **dev)
                    del tree, faulty_tree
                    continue

                # ---- the int8 kernels: (args, keyword args) -> output
                if kind == "attn_i8":
                    wa = quantized(rnd(3 * d, d, scale=d ** -0.5))
                    wb = quantized(rnd(d, d, scale=d ** -0.5))
                    ba, bb = rnd(3 * d, scale=0.1), rnd(d, scale=0.1)
                    make = lambda ns_, nb_, wa_, wb_: (x, ns_, nb_, wa_, wb_, ba, bb, ls)
                    kw = dict(num_heads=heads)
                    kernel_fn, plain_fn = tvi.fused_attn_block_i8, \
                        tvi.fused_attn_block_i8_reference
                    quantum_fn = tvi.attn_output_quantum
                    library = lambda: library_attn_i8(x, ns, nb, wa, wb, ba, bb, ls, heads)
                    chunk_kw = None
                else:
                    swiglu = kind == "swiglu_i8"
                    packed = 2 if swiglu else 1
                    wa = quantized(rnd(packed * hidden, d, scale=d ** -0.5))
                    wb = quantized(rnd(d, hidden, scale=hidden ** -0.5))
                    ba, bb = rnd(packed * hidden, scale=0.1), rnd(d, scale=0.1)
                    make = lambda ns_, nb_, wa_, wb_: (x, ns_, nb_, wa_, ba, wb_, bb, ls)
                    kw = dict(num_chunks=1)
                    kernel_fn, plain_fn = (
                        (tvi.fused_swiglu_mlp_block_i8,
                         tvi.fused_swiglu_mlp_block_i8_reference) if swiglu else
                        (tvi.fused_mlp_block_i8, tvi.fused_mlp_block_i8_reference))
                    quantum_fn = lambda *a: tvi.mlp_output_quantum(*a, swiglu=swiglu)
                    library = lambda: library_mlp_i8(x, ns, nb, wa, ba, wb, bb, ls, swiglu)
                    chunk_kw = dict(num_chunks=2)
                args = make(ns, nb, wa, wb)
                got, want = kernel_fn(*args, **kw), plain_fn(*args, **kw)
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"vit {kind} {case} {tname}: non-finite output")
                peak = want.float().abs().max().item()
                tight = VIT_F32_ATOL if dtype == torch.float32 else \
                    VIT_BF16_ULPS * 2.0 ** -8 * peak
                quantum = quantum_fn(*args)
                bf16 = dtype == torch.bfloat16
                share, worst, changed = i8_mismatch(got, want, tight)
                if not i8_passes(share, worst, changed, tight, quantum, bf16):
                    raise AssertionError(
                        f"vit {kind} {case} {tname}: {share:.4f} of the rows outside "
                        f"{tight:.3g}, worst {worst:.3g} ({worst / quantum:.2f} "
                        f"quanta), {changed:.4f} of the elements differ")
                if not torch.equal(got, kernel_fn(*args, **kw)):
                    raise AssertionError(f"vit {kind} {case} {tname}: two calls differ")
                # #9 and #10 run the very pieces their plain versions repeat
                # to the bit; #9 is held to that
                bitwise = torch.equal(got, want)
                if kind == "mlp_i8" and not bitwise:
                    raise AssertionError(f"vit {kind} {case} {tname}: not bit for bit "
                                         "its plain version")
                del want

                faults = {}
                # 1: round-half-up, on a LayerNorm output made of exact ties
                tie_args = make(tie_ns, tie_nb, wa, wb)
                tie_got = kernel_fn(*tie_args, **kw)
                tie_tight = tight if dtype == torch.float32 else \
                    VIT_BF16_ULPS * 2.0 ** -8 * tie_got.float().abs().max().item()
                tie_q = quantum_fn(*tie_args)
                sound = i8_mismatch(tie_got, plain_fn(*tie_args, **kw), tie_tight)
                if not i8_passes(*sound, tie_tight, tie_q, bf16):
                    raise AssertionError(f"vit {kind} {case} {tname}: on exact ties "
                                         f"{sound[0]:.4f} of the rows outside, worst "
                                         f"{sound[1]:.3g}, {sound[2]:.4f} of the "
                                         "elements differ")
                with rounding_half_up(tvi):
                    faults["round-half-up on ties"] = (
                        *i8_mismatch(tie_got, plain_fn(*tie_args, **kw), tie_tight),
                        tie_tight, tie_q)
                del tie_got
                # 2: the weight scale of one output channel of the last
                # projection dropped
                dropped = {"q": wb["q"], "s": wb["s"].clone()}
                dropped["s"][7] = 1.0
                faults["one channel's weight scale dropped"] = (
                    *i8_mismatch(got, plain_fn(*make(ns, nb, wa, dropped), **kw), tight),
                    tight, quantum)
                # 3: the hidden scale over the whole row where two chunks are due
                if chunk_kw is not None:
                    got2 = kernel_fn(*args, **chunk_kw)
                    want2 = plain_fn(*args, **chunk_kw)
                    sound = i8_mismatch(got2, want2, tight)
                    bitwise2 = torch.equal(got2, want2)
                    del want2
                    if kind == "mlp_i8" and not bitwise2:
                        raise AssertionError(f"vit {kind} {case} {tname} num_chunks=2: "
                                             "not bit for bit its plain version")
                    if not i8_passes(*sound, tight, quantum, bf16):
                        raise AssertionError(
                            f"vit {kind} {case} {tname} num_chunks=2: {sound[0]:.4f} "
                            f"of the rows outside, worst {sound[1]:.3g}, "
                            f"{sound[2]:.4f} of the elements differ")
                    faults["whole-row hidden scale for 2 chunks"] = (
                        *i8_mismatch(got2, plain_fn(*args, **kw), tight), tight, quantum)
                    chunk_note = (f"; num_chunks=2: {sound[0]:.4f} outside, worst "
                                  f"{sound[1]:.3g}, {sound[2]:.4f} of the elements "
                                  f"differ, bit for bit {bitwise2}")
                    del got2
                else:
                    chunk_note = ""
                for label, (f_share, f_worst, f_changed, f_tight, f_q) in faults.items():
                    if i8_passes(f_share, f_worst, f_changed, f_tight, f_q, bf16):
                        raise AssertionError(
                            f"vit {kind} {case} {tname}: the check passes a planted "
                            f"fault ({label}): {f_share:.4f} outside, worst "
                            f"{f_worst:.3g}, {f_changed:.4f} of the elements differ")
                fault_note = "; ".join(
                    f"{label}: {v[0]:.3f} of the rows outside, worst "
                    f"{v[1] / v[4]:.3g} quanta, {v[2]:.3f} of the elements differ"
                    for label, v in faults.items())

                dev = time_all(case, kind, {
                    "ms": lambda: kernel_fn(*args, **kw),
                    "plain_ms": lambda: plain_fn(*args, **kw),
                    "library_ms": library})
                flop_ms, byte_ms = vit_new_bound(kind, b, n, d, hidden, x.element_size())
                lib = "none" if dev["library_ms"] is None else f"{dev['library_ms']:.4f}"
                bound_ms = max(flop_ms, byte_ms)
                piece_note = ""
                if kind in I8_PIECES:
                    pieces, recorded = piece_ms(lambda: kernel_fn(*args, **kw),
                                                I8_PIECES[kind],
                                                math.ceil(b * n / tvi.MLP_SLAB_ROWS))
                    piece_note = "; device ms per piece: " + ", ".join(
                        f"{label} {t:.4f}" for label, t in pieces.items()) + \
                        f" (sum {sum(pieces.values()):.4f}; the trace held " \
                        f"{recorded:.2f} of the launches)"
                print(f"[kernel] vit_{kind} {case}: B={b} N={n} D={d} heads={heads} "
                      f"H={hidden} {tname}: {share:.4f} of {b * n} rows outside the "
                      f"tight bar {tight:.3g} (allowed {I8_FLIP_SHARE}), worst row "
                      f"{worst:.3g} = {worst / quantum:.2f} output quanta of "
                      f"{quantum:.3g} (allowed {I8_LOOSE_QUANTA}), {changed:.5f} of the "
                      f"elements differ"
                      + (f" (allowed {I8_BF16_CHANGED})" if bf16 else "")
                      + f", max |out| {peak:.3g}, bit for bit {bitwise}"
                      f"{chunk_note}; planted faults, all caught: {fault_note}; device "
                      f"ms: kernel {dev['ms']:.4f}, plain {dev['plain_ms']:.4f}, "
                      f"library calls (_int_mm) {lib}; bound "
                      f"{bound_ms:.4f} (operations {flop_ms:.4f}, bytes "
                      f"{byte_ms:.4f}), share of the bound "
                      f"{bound_ms / dev['ms']:.4f}{piece_note} | {gpu}", flush=True)
                main_case = "virchow2-20x64" if kind == "swiglu_i8" else "uni"
                if case == main_case and dtype == torch.bfloat16:
                    main_rows[kind] = dict(err=worst, flop_ms=flop_ms,
                                           byte_ms=byte_ms, **dev)
                del got
    return main_rows


def make_blob_slide(path, side, seed):
    """A blob-on-white slide as a `.npy` array pyramid base: light background
    with noise and a dark disc of tissue of radius 0.45 side. The noise is
    drawn as random bytes, row band by row band (a bounded integer draw
    took most of a minute at 24576 px on the card's host)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8,
                                    shape=(side, side, 3))
    xx = np.arange(side)[None, :]
    band = 1024
    for y0 in range(0, side, band):
        yy = np.arange(y0, min(y0 + band, side))[:, None]
        noise = np.frombuffer(rng.bytes(len(yy) * side * 3), np.uint8).reshape(
            len(yy), side, 3)
        blob = ((yy - side // 2) ** 2 + (xx - side // 2) ** 2
                < (0.45 * side) ** 2)[..., None]
        img[y0: y0 + len(yy)] = np.where(blob, 80 + (noise & 63),
                                         240 + (noise & 7))
    img.flush()
    del img


def feature_mismatch(got, want):
    """Worst |got - want|_2 / |want|_2 over the rows of two (rows, dim)
    arrays."""
    import numpy as np

    num = np.linalg.norm(got.astype(np.float64) - want, axis=-1)
    return float((num / np.linalg.norm(want.astype(np.float64), axis=-1)).max())


def feature_cosine(got, want):
    """Lowest cosine between the rows of two (rows, dim) arrays."""
    import numpy as np

    got, want = got.astype(np.float64), want.astype(np.float64)
    return float(((got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                          * np.linalg.norm(want, axis=-1))).min())


def preprocess_phase(torch, tfa, tvf, gpu):
    import copy
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch.cli.preprocess import main as preprocess_main
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.encoders import vit
    from paths_tpu_torch.encoders.registry import from_name
    from paths_tpu_torch.encoders.transforms import (UNI_TRANSFORM, VIRCHOW2_TRANSFORM,
                                                     apply_transform)
    from paths_tpu_torch.kernels import vit_int8 as tvi
    from paths_tpu_torch.preprocess.pipeline import _read_batch
    from paths_tpu_torch.preprocess.wsi import open_wsi

    side, powers, batch = 7168, [0.625, 1.25, 2.5, 5.0, 10.0], 64
    slide_dir = os.path.join(WORK, "slides")
    os.makedirs(slide_dir)
    t0 = time.perf_counter()
    for i in range(2):
        make_blob_slide(os.path.join(slide_dir, f"slide{i}.npy"), side, seed=i)
    print(f"[preprocess] 2 synthetic slides of {side} x {side} px at objective "
          f"power 10, written in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- UNI, full width and depth, bf16, through the CLI on every block route
    # but flash
    kernel_impls = ("fused", "int8", "fused1")
    runs = {}
    for impl in kernel_impls + ("xla",):
        out = os.path.join(WORK, f"features_{impl}")
        reset_vit_counts(tvf)
        reset_counts(tfa)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = preprocess_main(
            ["-m", "UNI", "-d", slide_dir, "-o", out, "--ext", ".npy", "-b",
             str(batch), "--default-power", "10", "--block-impl", impl])
        torch.cuda.synchronize()
        runs[impl] = dict(wall=time.perf_counter() - t0, stats=stats,
                          counts=vit_counts(tvf), out=out,
                          peak=torch.cuda.max_memory_allocated() / 2**20)
        if any(launch_counts(tfa).values()):
            raise AssertionError(f"{impl} route launched flash kernels: "
                                 f"{launch_counts(tfa)}")
    stores = {impl: FeatureStore(r["out"]) for impl, r in runs.items()}
    patches = batches = 0
    worst = dict.fromkeys(kernel_impls, 0.0)
    cosine = 1.0
    for i in range(2):
        for power in powers:
            b = np.asarray(stores["xla"].load(f"slide{i}", power))
            cells = np.abs(b).sum(-1) > 0
            patches += int(cells.sum())
            batches += math.ceil(int(cells.sum()) / batch)
            for impl in kernel_impls:
                a = np.asarray(stores[impl].load(f"slide{i}", power))
                if a.shape != b.shape or a.shape[2] != 1024 or a.dtype != np.float32:
                    raise AssertionError(f"slide{i} @ {power} {impl}: grids "
                                         f"{a.shape} {a.dtype} vs {b.shape}")
                if not np.array_equal(cells, np.abs(a).sum(-1) > 0):
                    raise AssertionError(f"slide{i} @ {power} {impl}: background "
                                         "cells differ")
                if not np.isfinite(a).all():
                    raise AssertionError(f"slide{i} @ {power} {impl}: non-finite "
                                         "features")
                if cells.any():
                    worst[impl] = max(worst[impl],
                                      feature_mismatch(a[cells], b[cells]))
                    if impl == "int8":
                        cosine = min(cosine, feature_cosine(a[cells], b[cells]))
    bars = {"fused": FEATURE_RTOL_BF16, "fused1": FEATURE_RTOL_BF16,
            "int8": FEATURE_RTOL_INT8}
    for impl in kernel_impls:
        if not worst[impl] <= bars[impl]:
            raise AssertionError(f"UNI {impl} vs plain route: features differ by "
                                 f"{worst[impl]:.3g} of their norm > {bars[impl]}")
    if not cosine >= FEATURE_COS_INT8:
        raise AssertionError(f"UNI int8 vs plain route: cosine {cosine:.5f}")
    depth = vit.UNI.depth
    per_run = depth * batches
    wants = {"fused": vit_expect(tvf, fused_attn_block=per_run, fused_mlp_block=per_run),
             "int8": vit_expect(tvf, fused_attn_block_i8=per_run,
                                fused_mlp_block_i8=per_run),
             "fused1": vit_expect(tvf, fused_block=per_run),
             "xla": vit_expect(tvf)}
    for impl, want in wants.items():
        if runs[impl]["counts"] != want:
            raise AssertionError(f"{impl} route launched {runs[impl]['counts']}, "
                                 f"the code says {want}")
    for impl, r in runs.items():
        st = r["stats"]
        launched = {k: v for k, v in r["counts"].items() if v}
        print(f"[preprocess] cli.preprocess -m UNI --block-impl {impl} (bf16, -b "
              f"{batch}, 24 blocks, D 1024): {patches} tissue patches of 2 slides "
              f"x {len(powers)} magnifications in {batches} encoded batches, "
              f"{r['wall']:.1f} s wall with the encoder's initialisation = "
              f"{patches / r['wall']:.1f} patches/s; staging thread busy "
              f"{st['h2d_busy_s'] / batches * 1e3:.2f} ms per batch for "
              f"{st['h2d_bytes'] / batches / 2**20:.1f} MiB; kernel launches "
              f"{launched}, every other wrapper 0; peak memory {r['peak']:.0f} MiB "
              f"| {gpu}", flush=True)
    for impl in kernel_impls:
        print(f"[preprocess] UNI {impl} vs plain route over {patches} tissue "
              f"cells: same grids and background, worst |diff|/|feature| "
              f"{worst[impl]:.3g} (rtol {bars[impl]})"
              + (f", lowest cosine {cosine:.6f} (at least {FEATURE_COS_INT8})"
                 if impl == "int8" else ""), flush=True)
    uni_counts = {impl: runs[impl]["counts"] for impl in kernel_impls}

    # two 64-patch batches of real tissue for the single-batch checks, read
    # as the pipeline's producer reads them (8 threads), which is timed
    wsi = open_wsi(os.path.join(slide_dir, "slide0.npy"), 10.0)
    cells = np.array([(r, c) for r in range(10, 18) for c in range(10, 26)])
    with ThreadPoolExecutor(max_workers=8) as pool:
        t0 = time.perf_counter()
        read = [_read_batch(wsi, cells, bi, 10.0, 256, batch, pool, False)[0]
                for bi in range(2)]
        decode_ms = (time.perf_counter() - t0) / 2 * 1e3
    wsi.close()
    print(f"[preprocess] host decode of one 64-patch batch from a .npy slide "
          f"(8 threads): {decode_ms:.1f} ms", flush=True)
    imgs = torch.from_numpy(np.concatenate(read)).cuda()
    two_batches = [imgs[:64], imgs[64:]]

    # -- encode time, busy share and profile of one UNI batch on every route,
    # all from one random model (`from_name` is timed by the CLI runs above)
    t0 = time.perf_counter()
    base = vit.vit_init(0, vit.UNI)
    init_s = time.perf_counter() - t0
    ls1_model = copy.deepcopy(base)          # for the f32 checks below
    t0 = time.perf_counter()
    quantised = tvi.quantize_vit_blocks(copy.deepcopy(base))
    quantise_s = time.perf_counter() - t0
    held = {}
    for name, m in (("float", base), ("int8", quantised)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        m.cuda()
        torch.cuda.synchronize()
        held[name] = (torch.cuda.memory_allocated() - before) / 2**20
    print(f"[preprocess] vit_init(0, UNI) took {init_s:.1f} s, quantising its 96 "
          f"block matrices on the host {quantise_s:.1f} s; on the card the float "
          f"encoder holds {held['float']:.0f} MiB (f32, before the bf16 copies of "
          f"the block matrices), the int8 encoder {held['int8']:.0f} MiB | {gpu}",
          flush=True)

    def encoder(impl, dtype=torch.bfloat16):
        model = quantised if impl == "int8" else base
        return lambda imgs: vit.vit_apply(
            model, apply_transform(imgs.float() / 255.0, UNI_TRANSFORM), dtype, impl)

    encoders = {impl: encoder(impl) for impl in kernel_impls + ("xla", "flash")}
    for impl in kernel_impls + ("xla", "flash"):
        enc = encoders[impl]
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: enc(two_batches[0]), iters=2, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            enc(two_batches[0])
            torch.cuda.synchronize()
        busy_us = kernel_us(prof)
        print(f"[preprocess] UNI encode of one 64-patch batch, block_impl={impl}, "
              f"bf16: {ms:.2f} ms between CUDA events = {64e3 / ms:.1f} patches/s "
              f"of encode alone; kernel time in one profiled encode "
              f"{busy_us / 1e3:.2f} ms (busy share {busy_us / 1e3 / ms:.3f}); peak "
              f"memory with both encoders resident {peak:.0f} MiB | {gpu}",
              flush=True)
        if impl != "xla":
            table = prof.key_averages().table(
                sort_by="device_time_total", row_limit=15 if impl == "fused" else 6)
            for line in table.splitlines():
                print(f"[preprocess-profile] {impl}: {line}", flush=True)

    # -- one UNI batch on the flash route: kernel #1 at bf16, head_dim 64
    reset_counts(tfa)
    reset_vit_counts(tvf)
    got = encoders["flash"](two_batches[0])
    ref = encoders["xla"](two_batches[0])
    torch.cuda.synchronize()
    flash_counts = launch_counts(tfa)
    rel = feature_mismatch(got.cpu().numpy(), ref.cpu().numpy())
    if flash_counts["masked_flash_attention_fwd"] != depth or any(
            vit_counts(tvf).values()) or not rel <= FEATURE_RTOL_BF16:
        raise AssertionError(f"flash route: launches {flash_counts}, "
                             f"{vit_counts(tvf)}, mismatch {rel:.3g}")
    print(f"[preprocess] UNI, one batch, block_impl=flash: {depth} launches of "
          f"the flash forward kernel (bf16, head_dim 64, N 197), worst "
          f"|diff|/|feature| vs the plain route {rel:.3g} (rtol "
          f"{FEATURE_RTOL_BF16})", flush=True)
    del encoders, base, quantised

    # -- one f32 UNI batch with LayerScale 1: the check with power
    x = apply_transform(two_batches[0].float() / 255.0, UNI_TRANSFORM)
    model = ls1_model
    with torch.no_grad():
        for blk in model.blocks:
            blk.ls1.fill_(1.0)
            blk.ls2.fill_(1.0)
    model_i8 = tvi.quantize_vit_blocks(copy.deepcopy(model)).cuda()
    model = model.cuda()
    plain = vit.vit_apply(model, x, torch.float32, "xla")
    sound = {}
    for impl in ("fused", "fused1"):
        reset_vit_counts(tvf)
        sound[impl] = vit.vit_apply(model, x, torch.float32, impl)
    with torch.no_grad():
        # every other entry: a shift of all entries alike would vanish in the
        # next LayerNorm
        model.blocks[12].fc2.bias[::2] += 0.02
    for impl in ("fused", "fused1"):
        reset_vit_counts(tvf)
        faulty = vit.vit_apply(model, x, torch.float32, impl)
        torch.cuda.synchronize()
        err = (sound[impl] - plain).abs().max().item()
        fault_err = (faulty - plain).abs().max().item()
        want = vit_expect(tvf, fused_block=depth) if impl == "fused1" else \
            vit_expect(tvf, fused_attn_block=depth, fused_mlp_block=depth)
        if vit_counts(tvf) != want or not err <= FEATURE_ATOL_F32 \
                or not fault_err > FEATURE_ATOL_F32:
            raise AssertionError(f"f32 UNI batch, {impl}: err {err:.3g}, planted "
                                 f"fault {fault_err:.3g}, atol {FEATURE_ATOL_F32}, "
                                 f"launches {vit_counts(tvf)} (want {want})")
        print(f"[preprocess] UNI, one f32 batch, LayerScale 1, {impl} vs plain "
              f"route: max |diff| {err:.3g} on features up to "
              f"{plain.abs().max().item():.3g} (atol {FEATURE_ATOL_F32}); planted "
              f"fault (every other entry of block 12's fc2 bias + 0.02): "
              f"{fault_err:.3g}, caught", flush=True)
    del model, sound

    # the int8 route through the kernels against the same route through the
    # plain versions, and against the float plain route (the quantisation error)
    reset_vit_counts(tvf)
    got = vit.vit_apply(model_i8, x, torch.float32, "int8")
    counts_i8 = vit_counts(tvf)
    with plain_int8(tvi):
        ref_i8 = vit.vit_apply(model_i8, x, torch.float32, "int8")
    with torch.no_grad():
        model_i8.blocks[12].fc2.weight_s[5] = 1.0
    faulty = vit.vit_apply(model_i8, x, torch.float32, "int8")
    torch.cuda.synchronize()
    err = (got - ref_i8).abs().max().item()
    fault_err = (faulty - ref_i8).abs().max().item()
    noise = (got - plain).abs().max().item()
    bar = FEATURE_INT8_SELF * noise
    quant_rel = feature_mismatch(got.cpu().numpy(), plain.cpu().numpy())
    quant_cos = feature_cosine(got.cpu().numpy(), plain.cpu().numpy())
    want = vit_expect(tvf, fused_attn_block_i8=depth, fused_mlp_block_i8=depth)
    if counts_i8 != want or not err <= bar or not fault_err > bar \
            or not quant_rel <= FEATURE_RTOL_INT8 or not quant_cos >= FEATURE_COS_INT8:
        raise AssertionError(f"f32 UNI batch, int8: err {err:.3g}, planted fault "
                             f"{fault_err:.3g}, bar {bar:.3g}; vs the float route "
                             f"{quant_rel:.3g}, cosine {quant_cos:.5f}; launches "
                             f"{counts_i8} (want {want})")
    print(f"[preprocess] UNI, one f32 batch, LayerScale 1, int8 route through the "
          f"kernels vs through the plain versions: max |diff| {err:.3g} (at most "
          f"{FEATURE_INT8_SELF} x the quantisation noise {noise:.3g}, the max "
          f"|diff| of the kernels vs the float plain route); planted fault (block "
          f"12's fc2 scale of channel 5 set to 1): {fault_err:.3g}, caught; vs the "
          f"float plain route: worst |diff|/|feature| {quant_rel:.3g} (rtol "
          f"{FEATURE_RTOL_INT8}), lowest cosine {quant_cos:.6f}", flush=True)
    del model_i8

    inits = {}

    def route_encoder(name, impl):
        """from_name(name, block_impl=impl, seed=0) with the host's
        vit_init(0) run once per encoder (about 10 s a UNI on the card's
        host): every route gets a copy of the same weights, which the int8
        route quantises in place."""
        real = vit.vit_init

        def init_once(seed, spec):
            if name not in inits:
                inits[name] = real(seed, spec)
                if name == "virchow2":
                    # LayerScale 1, as the f32 UNI batch above: at the
                    # published 1e-5 the 32 blocks would add about 1e-5 to
                    # the features, and a wrong kernel would pass this check
                    with torch.no_grad():
                        for blk in inits[name].blocks:
                            blk.ls1.fill_(1.0)
                            blk.ls2.fill_(1.0)
            return copy.deepcopy(inits[name])

        vit.vit_init = init_once
        try:
            return from_name(name, block_impl=impl, seed=0)
        finally:
            vit.vit_init = real

    # -- Virchow2 (published: 16 heads of 80), full width and depth, bf16,
    # LayerScale 1, through from_name on every route that takes head_dim 80;
    # #8 (int8) and #1 (flash) refuse it
    for refused, call in (
            ("int8", lambda: tvi.fused_attn_block_i8(
                torch.zeros(1, 5, 1280, device="cuda", dtype=torch.bfloat16),
                None, None, None, None, None, None, num_heads=16)),
            ("flash", lambda: tfa.masked_flash_attention_fwd(
                *(torch.zeros(1, 16, 261, 80, device="cuda", dtype=torch.bfloat16)
                  for _ in range(3)),
                torch.full((1,), 261, dtype=torch.int32, device="cuda")))):
        try:
            call()
        except ValueError as e:
            if "head_dim 80" not in str(e):
                raise
        else:
            raise AssertionError(f"the {refused} route took head_dim 80")
    v_impls = tuple(i for i in kernel_impls if i != "int8")
    feats, ms, vcounts, vpeak = {}, {}, {}, {}
    for impl in v_impls + ("xla",):
        enc, dim, _ = route_encoder("virchow2", impl)
        if dim != 2560:
            raise AssertionError(f"virchow2 out dim {dim}")
        reset_vit_counts(tvf)
        feats[impl] = torch.cat([enc(b) for b in two_batches]).cpu().numpy()
        torch.cuda.synchronize()
        vcounts[impl] = vit_counts(tvf)
        torch.cuda.reset_peak_memory_stats()
        ms[impl] = cuda_ms(lambda: enc(two_batches[0]), iters=2, warmup=0)
        vpeak[impl] = torch.cuda.max_memory_allocated() / 2**20
        del enc
    vdepth = vit.VIRCHOW2.depth
    pair = vit_expect(tvf, fused_attn_block=2 * vdepth,
                      fused_swiglu_mlp_block=2 * vdepth)
    wants = {"fused": pair, "fused1": pair, "xla": vit_expect(tvf)}
    rels = {impl: feature_mismatch(feats[impl], feats["xla"]) for impl in v_impls}
    for impl in v_impls:
        if vcounts[impl] != wants[impl] or feats[impl].shape != (128, 2560) or \
                not np.isfinite(feats[impl]).all() or not rels[impl] <= bars[impl]:
            raise AssertionError(f"virchow2 {impl}: launches {vcounts[impl]} (want "
                                 f"{wants[impl]}), shape {feats[impl].shape}, "
                                 f"mismatch {rels[impl]:.3g} (rtol {bars[impl]})")
    if any(vcounts["xla"].values()):
        raise AssertionError(f"virchow2: plain route launched {vcounts['xla']}")
    for impl in v_impls:
        launched = {k: v for k, v in vcounts[impl].items() if v}
        print(f"[preprocess] Virchow2 (32 blocks, D 1280, 16 heads of 80, packed "
              f"SwiGLU 2 x 3416 held as 3456, 261 tokens, bf16, LayerScale 1), "
              f"2 batches of 64 "
              f"through from_name(block_impl={impl!r}): launches {launched}; "
              f"(128, 2560) features, worst |diff|/|feature| vs the plain route "
              f"{rels[impl]:.3g} (rtol {bars[impl]}); int8 and flash refuse "
              f"head_dim 80"
              + f"; encode of one batch {ms[impl]:.1f} ms, plain route "
              f"{ms['xla']:.1f} ms; peak memory over the timed batches "
              f"{vpeak[impl]:.0f} MiB (encoder resident; plain route "
              f"{vpeak['xla']:.0f} MiB) | {gpu}", flush=True)
    del inits["virchow2"]

    # -- the int8 route (#8, #10) on the SwiGLU ViT that #8 takes: Virchow2's
    # depth, width and 261 tokens at 20 heads of 64, packed SwiGLU 2 x 6912,
    # no LayerScale (the port's Virchow2 before it took its published
    # widths), quantised as from_name quantises, through vit_apply
    v64 = dataclasses.replace(vit.VIRCHOW2, num_heads=20, glu_width=0,
                              layer_scale=False)
    m64 = vit.vit_init(0, v64)
    q64 = tvi.quantize_vit_blocks(copy.deepcopy(m64)).cuda()
    m64 = m64.cuda()
    xs = [apply_transform(b.float() / 255.0, VIRCHOW2_TRANSFORM) for b in two_batches]
    plain64 = torch.cat([vit.vit_apply(m64, x, torch.bfloat16, "xla") for x in xs])
    del m64
    reset_vit_counts(tvf)
    got64 = torch.cat([vit.vit_apply(q64, x, torch.bfloat16, "int8") for x in xs])
    torch.cuda.synchronize()
    i8counts = vit_counts(tvf)
    torch.cuda.reset_peak_memory_stats()
    i8ms = cuda_ms(lambda: vit.vit_apply(q64, xs[0], torch.bfloat16, "int8"),
                   iters=2, warmup=0)
    i8peak = torch.cuda.max_memory_allocated() / 2**20
    got64, plain64 = got64.cpu().numpy(), plain64.cpu().numpy()
    i8rel = feature_mismatch(got64, plain64)
    i8cos = feature_cosine(got64, plain64)
    want = vit_expect(tvf, fused_attn_block_i8=2 * v64.depth,
                      fused_swiglu_mlp_block_i8=2 * v64.depth)
    if i8counts != want or got64.shape != (128, 2560) or \
            not np.isfinite(got64).all() or not i8rel <= bars["int8"] \
            or not i8cos >= FEATURE_COS_INT8:
        raise AssertionError(f"virchow2-20x64 int8: launches {i8counts} (want "
                             f"{want}), shape {got64.shape}, mismatch {i8rel:.3g} "
                             f"(rtol {bars['int8']}), cosine {i8cos:.5f}")
    print(f"[preprocess] virchow2-20x64 (32 blocks, D 1280, 20 heads of 64, packed "
          f"SwiGLU 2 x 6912, 261 tokens, bf16, no LayerScale), 2 batches of 64 "
          f"through vit_apply(block_impl='int8'): launches "
          f"{ {k: v for k, v in i8counts.items() if v} }; (128, 2560) features, "
          f"worst |diff|/|feature| vs the plain route {i8rel:.3g} (rtol "
          f"{bars['int8']}), lowest cosine {i8cos:.6f} (at least "
          f"{FEATURE_COS_INT8}); encode of one batch {i8ms:.1f} ms; peak memory "
          f"over the timed batch {i8peak:.0f} MiB | {gpu}", flush=True)
    del q64

    # -- Kaiko-B/8 (patch 8: 785 tokens), full width and depth, bf16, one
    # batch through from_name on every route: the kernels' streamed key tiles
    # (#4, #7, #8)
    kfeats, kms, kcounts = {}, {}, {}
    for impl in kernel_impls + ("xla",):
        enc, dim, _ = route_encoder("kaiko-vitb8", impl)
        if dim != 768:
            raise AssertionError(f"kaiko-vitb8 out dim {dim}")
        reset_vit_counts(tvf)
        kfeats[impl] = enc(two_batches[0]).cpu().numpy()
        torch.cuda.synchronize()
        kcounts[impl] = vit_counts(tvf)
        kms[impl] = cuda_ms(lambda: enc(two_batches[0]), iters=2, warmup=0)
        del enc
    kdepth = vit.KAIKO_VITB8.depth
    wants = {"fused": vit_expect(tvf, fused_attn_block=kdepth, fused_mlp_block=kdepth),
             "fused1": vit_expect(tvf, fused_block=kdepth),
             "int8": vit_expect(tvf, fused_attn_block_i8=kdepth, fused_mlp_block_i8=kdepth),
             "xla": vit_expect(tvf)}
    krels = {impl: feature_mismatch(kfeats[impl], kfeats["xla"]) for impl in kernel_impls}
    kcos = feature_cosine(kfeats["int8"], kfeats["xla"])
    for impl in kernel_impls + ("xla",):
        if kcounts[impl] != wants[impl]:
            raise AssertionError(f"kaiko-vitb8 {impl}: launches {kcounts[impl]}, the "
                                 f"code says {wants[impl]}")
    for impl in kernel_impls:
        if kfeats[impl].shape != (64, 768) or not np.isfinite(kfeats[impl]).all() \
                or not krels[impl] <= bars[impl]:
            raise AssertionError(f"kaiko-vitb8 {impl}: shape {kfeats[impl].shape}, "
                                 f"mismatch {krels[impl]:.3g} (rtol {bars[impl]})")
    if not kcos >= FEATURE_COS_INT8:
        raise AssertionError(f"kaiko-vitb8 int8: cosine {kcos:.5f}")
    for impl in kernel_impls:
        launched = {k: v for k, v in kcounts[impl].items() if v}
        print(f"[preprocess] Kaiko-B/8 (12 blocks, D 768, MLP 3072, patch 8: 785 "
              f"tokens, bf16), one batch of 64 through from_name(block_impl="
              f"{impl!r}): launches {launched}; (64, 768) features, worst "
              f"|diff|/|feature| vs the plain route {krels[impl]:.3g} (rtol "
              f"{bars[impl]})"
              + (f", lowest cosine {kcos:.6f}" if impl == "int8" else "")
              + f"; encode of one batch {kms[impl]:.1f} ms, plain route "
              f"{kms['xla']:.1f} ms | {gpu}", flush=True)

    return {"vit_attn": uni_counts["fused"]["fused_attn_block"],
            "vit_mlp": uni_counts["fused"]["fused_mlp_block"],
            "vit_swiglu_mlp": vcounts["fused"]["fused_swiglu_mlp_block"],
            "vit_block": uni_counts["fused1"]["fused_block"],
            "vit_attn_i8": uni_counts["int8"]["fused_attn_block_i8"],
            "vit_mlp_i8": uni_counts["int8"]["fused_mlp_block_i8"],
            "vit_swiglu_mlp_i8": i8counts["fused_swiglu_mlp_block_i8"]}


def native_build(gpu):
    """Build the port's two host libraries with g++ (the table builder must
    build; the JPEG decoder needs libjpeg's headers and is reported when it
    does not), and print the command lines and thread counts."""
    from paths_tpu_torch import native
    from paths_tpu_torch.native import build as nbuild
    from paths_tpu_torch.native import jpeg as njpeg

    t0 = time.perf_counter()
    nbuild.build(verbose=False)
    jpath = nbuild.build_jpeg(verbose=False)
    took = time.perf_counter() - t0
    for name in ("host", "jpeg"):
        print(f"[native] {nbuild.commands[name]}", flush=True)
    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    decoder = (f"decoder {njpeg.load().jpeg_omp_thread_count()}" if jpath else
               "decoder not built (no libjpeg headers on this host: .tiles "
               "decode goes through PIL)")
    print(f"[native] host libraries built in {took:.1f} s; OpenMP threads: "
          f"table builder {native.load().omp_thread_count()}, {decoder}; "
          f"{os.cpu_count()} host cores; {pil} | {gpu}", flush=True)


@contextlib.contextmanager
def numpy_tables():
    """While inside, `engine.tables.build_level_table` takes its numpy path."""
    from paths_tpu_torch import native

    real = native.build_level_table_native
    native.build_level_table_native = lambda grid, min_rows=0: None
    try:
        yield
    finally:
        native.build_level_table_native = real


def native_phase(torch, gpu, sl):
    """The native table builder against the numpy path on every (slide,
    level) of the [slice] store, bit for bit, with both builders' times; then
    a cold 32-slide request on a new streaming session (which builds every
    slide's tables) with native and with numpy tables, in turns."""
    import numpy as np

    from paths_tpu_torch import native
    from paths_tpu_torch.engine.tables import build_level_table_numpy
    from paths_tpu_torch.serve import ServingSession

    if not native.available():
        raise AssertionError("[native] the table builder is not built")
    ds = sl["sess"]._dataset
    n, ms = 0, {"native": 0.0, "numpy": 0.0}
    for s in ds.slides:
        for lvl, power in enumerate(s.powers()):
            grid = np.asarray(s.store.load(s.slide_id, power))
            rows = min(s.level_min_rows[lvl], grid.shape[0] * grid.shape[1])
            t0 = time.perf_counter()
            got = native.build_level_table_native(grid, rows)
            t1 = time.perf_counter()
            want = build_level_table_numpy(grid, rows)
            t2 = time.perf_counter()
            ms["native"] += (t1 - t0) * 1e3
            ms["numpy"] += (t2 - t1) * 1e3
            for key in ("fts", "locs", "count", "index", "grid_hw"):
                if not (np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
                        and np.array_equal(got[key], want[key])):
                    raise AssertionError(f"[native] {s.slide_id} level {lvl}: "
                                         f"{key} differs from the numpy table")
            n += 1
    print(f"[native] tables of {n} (slide, level) grids of the [slice] store: "
          f"native equal to numpy bit for bit; host time {ms['native']:.1f} ms "
          f"native, {ms['numpy']:.1f} ms numpy | {gpu}", flush=True)

    sdir = os.path.join(WORK, "model_streaming")
    ids = sl["ids"]
    walls = {"native": [], "numpy": []}
    first = None
    for kind in ("native", "numpy", "numpy", "native"):
        sess = ServingSession(sdir, cache_batches=0, device="cuda")
        with numpy_tables() if kind == "numpy" else contextlib.nullcontext():
            t0 = time.perf_counter()
            out = sess.predict(ids)
            walls[kind].append((time.perf_counter() - t0) * 1e3)
        first = first or out
        if out != first:
            raise AssertionError("[native] cold requests with native and numpy "
                                 "tables give other hazards")
        del sess
    print(f"[native] cold 32-slide request on a new streaming session (builds "
          f"every slide's tables), in turns: native tables "
          f"{', '.join(f'{w:.1f}' for w in walls['native'])} ms, numpy tables "
          f"{', '.join(f'{w:.1f}' for w in walls['numpy'])} ms; hazards equal "
          f"| {gpu}", flush=True)


# `.tiles` runs vs the `.npy` runs of the same slides: JPEG at quality 80
# moves pixels by a few levels, which flips only the tissue test of cells
# near the threshold (the JAX package's bar for the same comparison).
TILES_SELECTION = 0.15
# The native decoder vs PIL on the same JPEG streams: both are libjpeg, and
# IDCT variants differ by at most 2 levels (the JAX package's bar).
DECODER_ATOL = 2


def tiles_phase(torch, tvf, gpu, weights):
    """The two 7168-px [preprocess] slides written as JPEG-tiled pyramids and
    run through `cli.preprocess` with UNI on `fused` from a `--weights` file,
    with one decode thread of producers (`-w 0`) and with two decode
    processes (`-w 2`): grids equal to the bit, launches as the code says,
    the tissue selection against the `.npy` runs'. Without PIL on the host
    the fixture cannot be written, and both runs go over the `.npy` slides."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from paths_tpu_torch.cli.preprocess import main as preprocess_main
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.encoders import vit
    from paths_tpu_torch.native import jpeg as njpeg
    from paths_tpu_torch.preprocess.pipeline import _read_batch
    from paths_tpu_torch.preprocess.wsi import TiledJpegWSI, write_tiled_jpeg

    src_dir = os.path.join(WORK, "slides")
    powers, batch = [0.625, 1.25, 2.5, 5.0, 10.0], 64
    try:
        import PIL  # noqa: F401 — only whether the fixture can be written
        have_pil = True
    except ImportError as e:
        have_pil, why = False, str(e)
    if have_pil:
        slide_dir, ext = os.path.join(WORK, "tiles"), ".tiles"
        os.makedirs(slide_dir)
        t0 = time.perf_counter()
        for i in range(2):
            img = np.load(os.path.join(src_dir, f"slide{i}.npy"))
            write_tiled_jpeg(img, os.path.join(slide_dir, f"slide{i}.tiles"),
                             base_power=10.0, tile=512, quality=80)
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(slide_dir) for f in fs)
        decoder = "native" if njpeg.available() else "pil"
        print(f"[tiles] 2 slides of {img.shape[0]} x {img.shape[1]} px written "
              f"as JPEG-tiled pyramids (tile 512, quality 80, levels 1, 1/4, 1/16: "
              f"{size / 2**20:.1f} MiB) in {time.perf_counter() - t0:.1f} s; "
              f"tiles decode through {decoder}", flush=True)
    else:
        slide_dir, ext, decoder = src_dir, ".npy", "none (.npy)"
        print(f"[tiles] JPEG-tiled fixture not written: {why} on this host; "
              "the -w 0 and -w 2 runs go over the .npy slides", flush=True)

    runs = {}
    for workers in (0, 2):
        out = os.path.join(WORK, f"features_tiles_w{workers}")
        reset_vit_counts(tvf)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = preprocess_main(
            ["-m", "UNI", "-d", slide_dir, "-o", out, "--ext", ext, "-b",
             str(batch), "--default-power", "10", "--block-impl", "fused",
             "--weights", weights, "-w", str(workers)])
        torch.cuda.synchronize()
        runs[workers] = dict(wall=time.perf_counter() - t0, stats=stats,
                             counts=vit_counts(tvf), store=FeatureStore(out),
                             peak=torch.cuda.max_memory_allocated() / 2**20)
    npy = FeatureStore(os.path.join(WORK, "features_fused"))
    patches = batches = 0
    flips = []
    for i in range(2):
        for power in powers:
            a = np.asarray(runs[0]["store"].load(f"slide{i}", power))
            b = np.asarray(runs[2]["store"].load(f"slide{i}", power))
            if a.shape[2] != vit.UNI.embed_dim or not np.array_equal(a, b) \
                    or not np.isfinite(a).all():
                raise AssertionError(f"[tiles] slide{i} @ {power}: -w 0 and -w 2 "
                                     f"grids differ ({a.shape}, {b.shape})")
            cells = np.abs(a).sum(-1) > 0
            patches += int(cells.sum())
            batches += math.ceil(int(cells.sum()) / batch)
            ref = np.abs(np.asarray(npy.load(f"slide{i}", power))).sum(-1) > 0
            if ref.shape != cells.shape:
                raise AssertionError(f"[tiles] slide{i} @ {power}: grid "
                                     f"{cells.shape} vs .npy {ref.shape}")
            flips.append(float((ref != cells).mean()))
    depth = vit.UNI.depth
    want = vit_expect(tvf, fused_attn_block=depth * batches,
                      fused_mlp_block=depth * batches)
    for workers, r in runs.items():
        if r["counts"] != want:
            raise AssertionError(f"[tiles] -w {workers}: launches {r['counts']}, "
                                 f"the code says {want}")
    if not max(flips) <= TILES_SELECTION:
        raise AssertionError(f"[tiles] tissue selection differs from the .npy "
                             f"runs' in {max(flips):.3f} of the cells")
    for workers, r in runs.items():
        st = r["stats"]
        print(f"[tiles] cli.preprocess -m UNI --block-impl fused --weights "
              f"(bf16, -b {batch}) over 2 {ext} slides, -w {workers}: {patches} "
              f"tissue patches in {batches} encoded batches, {r['wall']:.1f} s "
              f"wall with the encoder's load = {patches / r['wall']:.1f} "
              f"patches/s; staging {st['h2d_busy_s'] / batches * 1e3:.2f} ms per "
              f"batch; launches #4 {r['counts']['fused_attn_block']}, #5 "
              f"{r['counts']['fused_mlp_block']} ({depth} per encoded batch); peak "
              f"memory {r['peak']:.0f} MiB | {gpu}", flush=True)
    print(f"[tiles] -w 0 and -w 2 grids equal bit for bit; tissue selection vs "
          f"the .npy runs: at most {max(flips):.4f} of a level's cells differ "
          f"(bar {TILES_SELECTION})", flush=True)
    if not have_pil:
        return

    # host decode of one 64-patch batch of tissue at 10x, cold tile cache, as
    # the pipeline's producer reads it (8 threads), with each decoder the
    # host has; and the decoders against each other
    path = os.path.join(slide_dir, "slide0.tiles")
    cells = np.array([(r, c) for r in range(10, 18) for c in range(10, 26)])
    decoders = ("pil", "native") if njpeg.available() else ("pil",)
    read, decode_ms = {}, {}
    for name in decoders:
        wsi = TiledJpegWSI(path, decoder=name)
        with ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            read[name] = [_read_batch(wsi, cells, bi, 10.0, 256, batch, pool,
                                      False)[0] for bi in range(2)]
            decode_ms[name] = (time.perf_counter() - t0) / 2 * 1e3
        wsi.close()
    line = "; ".join(f"{k} {v:.1f} ms" for k, v in decode_ms.items())
    if len(decoders) == 2:
        diff = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                   for a, b in zip(read["pil"], read["native"]))
        if diff > DECODER_ATOL:
            raise AssertionError(f"[tiles] native vs PIL decode: {diff} levels")
        line += f"; native vs PIL: max |diff| {diff} (bar {DECODER_ATOL})"
    else:
        line += "; native decoder not built on this host, PIL only"
    print(f"[tiles] host decode of one 64-patch batch at 10x from a .tiles "
          f"slide (8 threads, cold tile cache; the runs above decoded through "
          f"{decoder}): {line} | {gpu}", flush=True)


def dp_preprocess_phase(torch, tvf, gpu, weights):
    """[dp-preprocess]: the two [preprocess] slides through `cli.preprocess`
    with UNI from the [tiles] `--weights` file, on one device and over two
    shards (`--data-shards 2`), on `fused` and on `int8`: grids against the
    one-device run, the block kernels' launches against the code's count,
    patches/s."""
    import numpy as np

    from paths_tpu_torch.cli.preprocess import main as preprocess_main
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.encoders import vit

    slide_dir = os.path.join(WORK, "slides")
    powers, batch = [0.625, 1.25, 2.5, 5.0, 10.0], 64
    backend, devices, layout = dp_layout(torch)
    on = ["--device", "cuda:0"] if backend == "gloo" else []
    runs = {}
    for name, impl, shards in (("one", "fused", 0), ("fused", "fused", 2),
                               ("int8", "int8", 2)):
        out = os.path.join(WORK, f"dp_features_{name}")
        reset_vit_counts(tvf)
        t0 = time.perf_counter()
        preprocess_main(["-m", "UNI", "-d", slide_dir, "-o", out, "--ext",
                         ".npy", "-b", str(batch), "--default-power", "10",
                         "--block-impl", impl, "--weights", weights] + on
                        + (["--data-shards", str(shards)] if shards else []))
        torch.cuda.synchronize()
        runs[name] = dict(wall=time.perf_counter() - t0, counts=vit_counts(tvf),
                          store=FeatureStore(out))
    patches = batches = 0
    same, worst, int8_worst, cosine = True, 0.0, 0.0, 1.0
    for i in range(2):
        for power in powers:
            want = np.asarray(runs["one"]["store"].load(f"slide{i}", power))
            cells = np.abs(want).sum(-1) > 0
            patches += int(cells.sum())
            batches += math.ceil(int(cells.sum()) / batch)
            got = np.asarray(runs["fused"]["store"].load(f"slide{i}", power))
            q = np.asarray(runs["int8"]["store"].load(f"slide{i}", power))
            for a in (got, q):
                if a.shape != want.shape or not np.array_equal(
                        cells, np.abs(a).sum(-1) > 0) or not np.isfinite(a).all():
                    raise AssertionError(f"[dp-preprocess] slide{i} @ {power}: "
                                         "shape, background cells or finite "
                                         "values differ")
            same = same and np.array_equal(got, want)
            if cells.any():
                worst = max(worst, feature_mismatch(got[cells], want[cells]))
                int8_worst = max(int8_worst,
                                 feature_mismatch(q[cells], want[cells]))
                cosine = min(cosine, feature_cosine(q[cells], want[cells]))
    if not same and not worst <= FEATURE_RTOL_BF16:
        raise AssertionError(f"[dp-preprocess] two shards vs one device: "
                             f"features differ by {worst:.3g} of their norm")
    if not (int8_worst <= FEATURE_RTOL_INT8 and cosine >= FEATURE_COS_INT8):
        raise AssertionError(f"[dp-preprocess] int8 over two shards vs fused: "
                             f"{int8_worst:.3g}, cosine {cosine:.5f}")
    per = vit.UNI.depth * batches
    wants = {"one": vit_expect(tvf, fused_attn_block=per, fused_mlp_block=per),
             "fused": vit_expect(tvf, fused_attn_block=2 * per,
                                 fused_mlp_block=2 * per),
             "int8": vit_expect(tvf, fused_attn_block_i8=2 * per,
                                fused_mlp_block_i8=2 * per)}
    for name, want in wants.items():
        if runs[name]["counts"] != want:
            raise AssertionError(f"[dp-preprocess] {name} launched "
                                 f"{runs[name]['counts']}, the code says {want}")
    rate = {n: patches / r["wall"] for n, r in runs.items()}
    print(f"[dp-preprocess] cli.preprocess -m UNI --weights (bf16, -b {batch}) "
          f"over {patches} tissue patches in {batches} batches: one device "
          f"fused {runs['one']['wall']:.1f} s = {rate['one']:.1f} patches/s; "
          f"--data-shards 2 ({layout}) fused {runs['fused']['wall']:.1f} s = "
          f"{rate['fused']:.1f} patches/s, int8 {runs['int8']['wall']:.1f} s = "
          f"{rate['int8']:.1f} patches/s | {gpu}", flush=True)
    print(f"[dp-preprocess] two shards vs one device on fused: grids "
          f"{'equal to the bit' if same else f'within {worst:.3g} of the norm (bar {FEATURE_RTOL_BF16})'}; "
          f"int8 over two shards vs one-device fused {int8_worst:.3g} of the "
          f"norm, cosine {cosine:.5f}; launches: one device "
          f"{ {k: v for k, v in runs['one']['counts'].items() if v} }, two "
          f"shards fused { {k: v for k, v in runs['fused']['counts'].items() if v} }, "
          f"int8 { {k: v for k, v in runs['int8']['counts'].items() if v} } "
          f"(each batch splits into two encodes of {batch // 2}) | {gpu}",
          flush=True)


def resnet_mirror(torch, arch, seed=0):
    """A random torchvision-keyed mirror with non-trivial BatchNorm
    statistics."""
    from paths_tpu_torch.encoders import torch_mirror

    torch.manual_seed(seed)
    m = (torch_mirror.TorchResNet50() if arch == "resnet50"
         else torch_mirror.TorchResNet18()).eval()
    with torch.no_grad():
        for b in m.modules():
            if isinstance(b, torch.nn.BatchNorm2d):
                b.running_mean.uniform_(-0.2, 0.2)
                b.running_var.uniform_(0.5, 1.5)
    return m


# ResNet vs its mirror on the card: f32 with TF32 off sums in other orders
# (the mirror's BatchNorm after the conv, the port's folded affine); bf16
# rounds each conv output and affine: the feature-grid bar.
RESNET_F32_RTOL = 1e-4
RESNET_BF16_RTOL = FEATURE_RTOL_BF16


def resnet_phase(torch, gpu):
    """ResNet-50 through `cli.preprocess` over the two [preprocess] `.npy`
    slides from a random mirror's state dict; one batch's encode time,
    profile and agreement with the mirror on the card; ResNet-18 one batch."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch.cli.preprocess import main as preprocess_main
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.encoders.registry import from_name
    from paths_tpu_torch.preprocess.pipeline import _read_batch
    from paths_tpu_torch.preprocess.wsi import open_wsi

    slide_dir = os.path.join(WORK, "slides")
    powers, batch = [0.625, 1.25, 2.5, 5.0, 10.0], 64
    paths = {}
    for arch in ("resnet50", "resnet18"):
        paths[arch] = os.path.join(WORK, f"{arch}.pt")
        torch.save(resnet_mirror(torch, arch).state_dict(), paths[arch])
    out = os.path.join(WORK, "features_resnet50")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preprocess_main(["-m", "resnet50", "--weights", paths["resnet50"], "-d",
                     slide_dir, "-o", out, "--ext", ".npy", "-b", str(batch),
                     "--default-power", "10"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    store, npy = FeatureStore(out), FeatureStore(os.path.join(WORK, "features_fused"))
    patches = batches = 0
    for i in range(2):
        for power in powers:
            a = np.asarray(store.load(f"slide{i}", power))
            cells = np.abs(a).sum(-1) > 0
            ref = np.abs(np.asarray(npy.load(f"slide{i}", power))).sum(-1) > 0
            if a.shape[2] != 2048 or not np.isfinite(a).all() \
                    or not np.array_equal(cells, ref):
                raise AssertionError(f"[resnet] slide{i} @ {power}: grid "
                                     f"{a.shape}, tissue cells unlike UNI's")
            patches += int(cells.sum())
            batches += math.ceil(int(cells.sum()) / batch)
    print(f"[resnet] cli.preprocess -m resnet50 --weights (random mirror, bf16, "
          f"-b {batch}) over the 2 .npy slides: {patches} tissue patches in "
          f"{batches} batches, {wall:.1f} s wall with the encoder's load = "
          f"{patches / wall:.1f} patches/s; the same tissue cells as UNI's; "
          f"peak memory {peak:.0f} MiB | {gpu}", flush=True)

    wsi = open_wsi(os.path.join(slide_dir, "slide0.npy"), 10.0)
    cells = np.array([(r, c) for r in range(10, 18) for c in range(10, 26)])
    with ThreadPoolExecutor(max_workers=8) as pool:
        imgs = torch.from_numpy(_read_batch(wsi, cells, 0, 10.0, 256, batch,
                                            pool, False)[0]).cuda()
    wsi.close()
    x = imgs.permute(0, 3, 1, 2).float() / 255.0
    for arch in ("resnet50", "resnet18"):
        mirror = resnet_mirror(torch, arch).cuda()
        with torch.no_grad():
            want = mirror(x)
        del mirror
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            enc, dim, _ = from_name(arch, weights_path=paths[arch],
                                    compute_dtype=dtype)
            got = enc(imgs)
            errs[dtype] = ((got - want).abs().max() / want.abs().max()).item() \
                if dtype == torch.float32 else \
                ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            if got.shape != (batch, dim) or not torch.isfinite(got).all():
                raise AssertionError(f"[resnet] {arch} {dtype}: {got.shape}")
            if arch == "resnet50" and dtype == torch.bfloat16:
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: enc(imgs), iters=10, warmup=3)
                enc_peak = torch.cuda.max_memory_allocated() / 2**20
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    enc(imgs)
                    torch.cuda.synchronize()
                busy_us = kernel_us(prof)
                table = prof.key_averages().table(sort_by="device_time_total",
                                                  row_limit=8)
            del enc
        if not (errs[torch.float32] <= RESNET_F32_RTOL
                and errs[torch.bfloat16] <= RESNET_BF16_RTOL):
            raise AssertionError(f"[resnet] {arch} vs mirror: f32 {errs[torch.float32]:.3g}"
                                 f", bf16 {errs[torch.bfloat16]:.3g}")
        print(f"[resnet] {arch}, one batch of 64 at 256 px vs the mirror on the "
              f"card (f32, TF32 off): f32 max |diff| {errs[torch.float32]:.3g} "
              f"of the largest feature (bar {RESNET_F32_RTOL}); bf16 worst "
              f"|diff|/|feature| {errs[torch.bfloat16]:.3g} (bar "
              f"{RESNET_BF16_RTOL}) | {gpu}", flush=True)
    print(f"[resnet] resnet50 encode of one 64-patch batch, bf16: {ms:.2f} ms "
          f"between CUDA events = {64e3 / ms:.1f} patches/s of encode alone; "
          f"kernel time in one profiled encode {busy_us / 1e3:.2f} ms (busy "
          f"share {busy_us / 1e3 / ms:.3f}); peak memory {enc_peak:.0f} MiB | "
          f"{gpu}", flush=True)
    for line in table.splitlines():
        print(f"[resnet-profile] {line}", flush=True)
    return paths["resnet50"]


# A planted fault in the converted encoder (the middle block's fc1 weight
# scaled by 1.05 after conversion; the mirror keeps the file's weights): the
# check must report it.
VERIFY_FAULT_SCALE = 1.05


def verify_phase(torch, tvf, gpu, uni_weights, r50_weights):
    """`cli.verify_conversion` on the card: UNI at full depth on `fused` in
    f32 (#4 and #5 once per block) from the [heatmap] weights file, and
    ResNet-50; then the planted fault, which must fail the check."""
    from paths_tpu_torch.cli import verify_conversion as vc
    from paths_tpu_torch.encoders import vit

    depth = vit.UNI.depth
    for model, path, extra in (("UNI", uni_weights, ["--block-impl", "fused"]),
                               ("resnet50", r50_weights, [])):
        reset_vit_counts(tvf)
        t0 = time.perf_counter()
        res = vc.main(["--model", model, "--weights", path, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = (vit_expect(tvf, fused_attn_block=depth, fused_mlp_block=depth)
                if model == "UNI" else vit_expect(tvf))
        if vit_counts(tvf) != want or not res["ok"]:
            raise AssertionError(f"[verify] {model}: launches {vit_counts(tvf)} "
                                 f"(want {want}), ok {res['ok']}")
        print(f"[verify] cli.verify_conversion --model {model}"
              f"{''.join(' ' + a for a in extra)} (4 images, f32, TF32 off) in "
              f"{wall:.1f} s: max_abs "
              f"{res['max_abs']:.3g}, max_rel {res['max_rel']:.3g} (tol 1e-3), ok"
              + (f"; launches #4 {depth}, #5 {depth}" if model == "UNI" else "")
              + f" | {gpu}", flush=True)

    convert = vc.vit_from_timm

    def faulty(sd, spec):
        model = convert(sd, spec)
        with torch.no_grad():
            model.blocks[depth // 2].fc1.weight.mul_(VERIFY_FAULT_SCALE)
        return model

    vc.vit_from_timm = faulty
    try:
        res = vc.run("UNI", uni_weights, block_impl="fused")
    finally:
        vc.vit_from_timm = convert
    if res["ok"]:
        raise AssertionError(f"[verify] planted fault not caught: max_abs "
                             f"{res['max_abs']:.3g}")
    print(f"[verify] planted fault (block {depth // 2}'s fc1 weight x "
          f"{VERIFY_FAULT_SCALE} after conversion): max_abs {res['max_abs']:.3g}"
          f" = {res['max_abs'] / 1e-3:.0f} x the tolerance, ok false, caught",
          flush=True)


# Which kernels each stage of the synthetic demo must launch, and no other:
# the ViT block kernels (#4 attention, #5 GELU MLP) where kaiko-vits16
# encodes patches, the flash kernels where the PATHS model runs (#1 every
# forward, #2 / #3 every train step at the demo's dropout 0); the artifact
# stage, `cli.export` to the end of the HTTP request, runs #1 through the
# artifact's operator.
DEMO_STAGES = (
    ("verify", "paths_tpu_torch.cli.verify_conversion", "main", {4, 5}),
    ("preprocess", "paths_tpu_torch.cli.preprocess", "main", {4, 5}),
    ("train", "paths_tpu_torch.cli.train", "main", {1, 2, 3}),
    ("evaluate", "paths_tpu_torch.cli.evaluate", "main", {1}),
    ("predict", "paths_tpu_torch.cli.predict", "main", {1}),
    ("heatmap", "paths_tpu_torch.examples.run_synthetic_demo",
     "heatmap_stage", {1, 4, 5}),
    ("artifact", "paths_tpu_torch.cli.export", "main", {1}),
)
EXAMPLE_KERNELS = {1: "masked_flash_attention_fwd",
                   2: "masked_flash_attention_bwd_dq",
                   3: "masked_flash_attention_bwd_dkv",
                   4: "fused_attn_block", 5: "fused_mlp_block"}


def examples_phase(torch, tfa, tvf, gpu):
    """[examples]: the port's end-to-end entry points. The synthetic demo at
    its defaults, each stage's launches of #1-#5 against `DEMO_STAGES`;
    then the flagship dress rehearsal's recipe for 2 epochs on its 48
    slides at full width (training at the published dropout 0.05 on the
    plain route, every evaluation on #1), its launches against the code's
    count, and the trained model's val hazards on the kernel route against
    the plain route on the same weights (PRED_ATOL, as [slice])."""
    import importlib

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import load_splits
    from paths_tpu_torch.examples import flagship_dress_rehearsal as reh
    from paths_tpu_torch.examples import run_synthetic_demo
    from paths_tpu_torch.serve import ServingSession

    def counts():
        return {**launch_counts(tfa), **vit_counts(tvf)}

    def launched(before, after):
        return {k for k, name in EXAMPLE_KERNELS.items()
                if after[name] > before[name]}

    stages, patched = {}, []
    for stage, module, attr, _ in DEMO_STAGES:
        mod = importlib.import_module(module)
        real = getattr(mod, attr)

        def wrapper(*args, _real=real, _stage=stage, **kwargs):
            before = counts()
            try:
                return _real(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                stages[_stage] = (before, counts())

        patched.append((mod, attr, real))
        setattr(mod, attr, wrapper)
    reset_counts(tfa)
    reset_vit_counts(tvf)
    t0 = time.perf_counter()
    try:
        demo = run_synthetic_demo.main(["--workdir",
                                        os.path.join(WORK, "demo")])
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)
    torch.cuda.synchronize()
    demo_wall = time.perf_counter() - t0
    total = counts()
    stages["artifact"] = (stages["artifact"][0], total)
    want = {stage: kernels for stage, _, _, kernels in DEMO_STAGES}
    got = {stage: launched(*stages[stage]) for stage in want}
    if got != want:
        raise AssertionError(f"[examples] demo launches by stage {got}, "
                             f"want {want}")
    haz = [r["risk"] for r in demo["served"]]
    if not (len(haz) == 2 and all(math.isfinite(h) for h in haz)
            and math.isfinite(demo["metrics"]["test_loss"])):
        raise AssertionError(f"[examples] demo outputs: {demo['metrics']}, "
                             f"served risks {haz}")
    main_path = {name: total[name] for name in EXAMPLE_KERNELS.values()}
    print(f"[examples] run_synthetic_demo at its defaults (10 slides, "
          f"kaiko-vits16, 3 epochs) in {demo_wall:.1f} s: nine stages, "
          f"test loss {demo['metrics']['test_loss']:.4f}, served risks "
          f"{[round(h, 4) for h in haz]}; kernels by stage "
          + ", ".join(f"{s} {sorted(k)}" for s, k in got.items())
          + f"; launches {main_path} | {gpu}", flush=True)

    wd = os.path.join(WORK, "rehearsal")
    t0 = time.perf_counter()
    summary = reh.main(["--workdir", wd, "--epochs", "2"])
    torch.cuda.synchronize()
    reh_wall = time.perf_counter() - t0
    mdir = os.path.join(wd, "model")
    cfg = Config.load(mdir, test_mode=True)
    splits = load_splits([0.7, 0.15, 0.15], cfg.seed, cfg)
    bs = cfg.batch_size[0]
    n_val, n_test = len(splits[1]), len(splits[2])
    per = cfg.model_config.trans_layers * cfg.num_levels
    # val every epoch and test once inside train_loop, test again in
    # cli.evaluate; the train steps run at dropout 0.05 on the plain route
    want = {"masked_flash_attention_fwd": per * (
        cfg.num_epochs * math.ceil(n_val / bs) + 2 * math.ceil(n_test / bs)),
        "masked_flash_attention_bwd_dq": 0,
        "masked_flash_attention_bwd_dkv": 0}
    if summary["kernel_launches"] != want:
        raise AssertionError(f"[examples] rehearsal launches "
                             f"{summary['kernel_launches']}, want {want}")
    for name, n in summary["kernel_launches"].items():
        main_path[name] += n
    with open(os.path.join(mdir, "train_stats.json")) as f:
        stats = json.load(f)
    losses = [stats["train_loss"][str(e)] for e in (1, 2)]
    test_ci = summary["test_metrics"]["test_c-index"]
    if not (all(math.isfinite(x) for x in losses) and 0.0 <= test_ci <= 1.0):
        raise AssertionError(f"[examples] rehearsal losses {losses}, test "
                             f"c-index {test_ci}")
    print(f"[examples] flagship_dress_rehearsal --epochs 2 (48 slides, "
          f"brca_paths_0 at full width, dropout {cfg.model_config.dropout}) "
          f"in {reh_wall:.1f} s (train {summary['train_wall_s']} s): train "
          f"loss {losses[0]:.4f} -> {losses[1]:.4f}, val c-index "
          f"{stats['val_c-index']['2']:.3f}, test c-index {test_ci:.3f}; #1 "
          f"launches {want['masked_flash_attention_fwd']} as the code counts "
          f"them, #2 / #3 0 | {gpu}", flush=True)

    val_ids = splits[1].slide_ids
    plain_dir = model_dir_copy(mdir, "rehearsal_plain", attention_impl="xla")
    got = ServingSession(mdir, cache_batches=0, device="cuda").predict(val_ids)
    ref = ServingSession(plain_dir, cache_batches=0,
                         device="cuda").predict(val_ids)
    worst = max(abs(x - y) for a, b in zip(got, ref)
                for x, y in zip(a["hazards"], b["hazards"]))
    if not worst <= PRED_ATOL:
        raise AssertionError(f"[examples] rehearsal val hazards, kernel vs "
                             f"plain route: {worst:.3g} > {PRED_ATOL}")
    print(f"[examples] trained rehearsal model, {len(val_ids)} val slides on "
          f"the streaming engine: kernel route vs plain route max |hazard "
          f"diff| {worst:.3g} (atol {PRED_ATOL})", flush=True)
    shutil.rmtree(wd, ignore_errors=True)
    return main_path


@contextlib.contextmanager
def plain_int8(tvi):
    """While inside, the int8 wrappers are their plain versions, whatever the
    device: the int8 route's own reference on the card."""
    names = ("fused_attn_block_i8", "fused_mlp_block_i8",
             "fused_swiglu_mlp_block_i8")
    kernels = {n: getattr(tvi, n) for n in names}
    for n in names:
        setattr(tvi, n, getattr(tvi, n + "_reference"))
    try:
        yield
    finally:
        for n, fn in kernels.items():
            setattr(tvi, n, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paths_tpu_torch.kernels import build
    from paths_tpu_torch.kernels import flash_attention as tfa
    from paths_tpu_torch.kernels import vit_fused as tvf
    from paths_tpu_torch.kernels import vit_int8 as tvi

    started = time.perf_counter()
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
    native_build(gpu)
    from paths_tpu_torch.native import zstd

    print(f"[env] libzstd (the Orbax reader's): "
          f"{zstd.find_library() or 'absent'}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    walls = {}

    def timed(name, phase, *args):
        """phase(*args), its wall time kept for the [env] phases line."""
        t0 = time.perf_counter()
        try:
            return phase(*args)
        finally:
            walls[name] = time.perf_counter() - t0

    try:
        cases = timed("kernel", kernel_phase, torch, tfa, gpu)
        bwd = timed("backward", backward_kernel_phase, torch, tfa, gpu)
        sl = timed("slice", serving_phase, torch, tfa, gpu)
        launches, tr = timed("train", training_phase, torch, tfa, gpu)
        stream_sess = timed("streaming-serve", streaming_serving_phase, torch,
                            tfa, gpu, sl)
        timed("streaming-train", streaming_training_phase, torch, tfa, gpu, tr)
        bf16_launches = timed("bf16", bf16_phase, torch, tfa, gpu, sl, tr,
                              stream_sess)
        timed("auto", auto_phase, sl)
        timed("lru", lru_phase, torch, tfa, gpu, sl)
        cli_out = timed("cli", cli_phase, torch, tfa, gpu, tr)
        timed("staging", staging_probe, torch, gpu, sl)
        timed("remat", remat_phase, torch, tfa, gpu, tr)
        timed("ckpt", ckpt_phase, torch, gpu, sl, tr, cli_out)
        timed("orbax", orbax_phase, torch, gpu, sl, tr, cli_out)
        export_launches = timed("export", export_phase, torch, tfa, gpu, sl)
        timed("dp-train", dp_train_phase, torch, tfa, gpu, tr)
        timed("dp-serve", dp_serve_phase, torch, tfa, gpu, sl)
        seq_launches = timed("seq", seq_phases, torch, tfa, gpu)
        timed("http", http_phase, torch, tfa, gpu, sl)
        uni_weights = timed("heatmap", heatmap_phase, torch, tfa, tvf, gpu, sl)
        timed("native", native_phase, torch, gpu, sl)
        del sl, tr, stream_sess
        vit_cases = timed("vit-kernel", vit_kernel_phase, torch, tvf, gpu)
        vit_cases.update(timed("vit-new-kernel", vit_new_kernel_phase, torch,
                               tvf, tvi, gpu))
        vit_launches = timed("preprocess", preprocess_phase, torch, tfa, tvf,
                             gpu)
        timed("tiles", tiles_phase, torch, tvf, gpu, uni_weights)
        timed("dp-preprocess", dp_preprocess_phase, torch, tvf, gpu,
              uni_weights)
        r50_weights = timed("resnet", resnet_phase, torch, gpu)
        timed("verify", verify_phase, torch, tvf, gpu, uni_weights,
              r50_weights)
        example_launches = timed("examples", examples_phase, torch, tfa,
                                 tvf, gpu)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
        print("[env] phases: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in walls.items()),
              flush=True)

    # #1's main path runs through [train] and the [export] artifact request;
    # #1-#3 also through [seq-train]'s two runs (rank 0's launches) and the
    # [examples] demo; #1 through the rehearsal's evaluations, #4 / #5
    # through the demo's encoder
    launches["masked_flash_attention_fwd"] += export_launches
    for name, n in bf16_launches.items():     # [bf16]'s request and step
        launches[name] += n
    for name, n in zip(("masked_flash_attention_fwd",
                        "masked_flash_attention_bwd_dq",
                        "masked_flash_attention_bwd_dkv"), seq_launches):
        launches[name] += n
    for name in ("masked_flash_attention_fwd", "masked_flash_attention_bwd_dq",
                 "masked_flash_attention_bwd_dkv"):     # [examples]
        launches[name] += example_launches[name]
    # one flagship forward (or train step) of 32 slides launches each kernel
    # twice at level 0 and 8 times deeper
    weights = {"level0": 2, "deeper": 8}

    def per_step(table, key):
        return sum(w * table[c][key] for c, w in weights.items())

    def row(name, source, replaces, err, ms, plain_ms, library_ms, flop_ms,
            byte_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(flop_ms, byte_ms),
                "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                "library_ms": library_ms}

    bwd_src = "paths_tpu_torch/csrc/flash_attention_bwd.cu"
    bound = {k: [sum(w * bwd[c]["bound"][k][i] for c, w in weights.items())
                 for i in (0, 1)] for k in ("dq", "dkv")}
    # library_ms of both backward rows is the one SDPA backward that computes
    # dq, dk and dv together: no PyTorch call computes either pass alone
    kernels = [
        row("masked_flash_attention_fwd", "paths_tpu_torch/csrc/flash_attention.cu",
            "paths_tpu/kernels/flash_attention.py:219",
            max(cases[c]["err"] for c in cases), per_step(cases, "ms"),
            per_step(cases, "plain_ms"), per_step(cases, "library_ms"),
            per_step(cases, "flop_ms"), per_step(cases, "byte_ms")),
        row("masked_flash_attention_bwd_dq", bwd_src,
            "paths_tpu/kernels/flash_attention.py:283",
            max(bwd[c]["err_dq"] for c in bwd), per_step(bwd, "dq_ms"),
            per_step(bwd, "plain_dq_ms"), per_step(bwd, "library_ms"),
            *bound["dq"]),
        row("masked_flash_attention_bwd_dkv", bwd_src,
            "paths_tpu/kernels/flash_attention.py:305",
            max(bwd[c]["err_dkv"] for c in bwd), per_step(bwd, "dkv_ms"),
            per_step(bwd, "plain_dkv_ms"), per_step(bwd, "library_ms"),
            *bound["dkv"]),
    ]
    # the fused block kernels at their main-path shape in bf16 (UNI for the
    # attention and GELU-MLP blocks, Virchow2 for the packed-SwiGLU block),
    # 64 images; launches from the preprocess runs (UNI through the CLI,
    # Virchow2 two batches)
    # (the whole-block kernel and the int8 blocks likewise: UNI through the
    # CLI on the fused1 and int8 routes, Virchow2 two batches on int8; for the
    # int8 kernels max_abs_err is the worst row, moved codes included)
    vit_src = "paths_tpu_torch/csrc/vit_fused.cu"
    i8_src = "paths_tpu_torch/csrc/vit_int8.cu"
    example_vit = {"vit_attn": example_launches["fused_attn_block"],   # demo
                   "vit_mlp": example_launches["fused_mlp_block"]}
    for name, kind, src, replaces in (
            ("vit_attn", "attn", vit_src, "vit_fused.py:174"),
            ("vit_mlp", "mlp", vit_src, "vit_fused.py:218"),
            ("vit_swiglu_mlp", "swiglu", vit_src, "vit_fused.py:298"),
            ("vit_block", "block", vit_src, "vit_fused.py:407"),
            ("vit_attn_i8", "attn_i8", i8_src, "vit_int8.py:156"),
            ("vit_mlp_i8", "mlp_i8", i8_src, "vit_int8.py:224"),
            ("vit_swiglu_mlp_i8", "swiglu_i8", i8_src, "vit_int8.py:305")):
        c = vit_cases[kind]
        launches[name] = vit_launches[name] + example_vit.get(name, 0)
        kernels.append(row(name, src, f"paths_tpu/kernels/{replaces}",
                           c["err"], c["ms"], c["plain_ms"], c["library_ms"],
                           c["flop_ms"], c["byte_ms"]))
    if len(kernels) != 10 or not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched on its path: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(f"[env] whole run took {time.perf_counter() - started:.0f} s", flush=True)
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
