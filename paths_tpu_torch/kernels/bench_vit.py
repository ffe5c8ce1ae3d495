"""Time the ViT block kernels (#4-#10) and the flash kernels (#1-#3) at the
shapes their paths give them on one GPU.

    python3 paths_tpu_torch/kernels/bench_vit.py [--root TREE] [--only KINDS]
        [--slabs N,N,..] [--save-outputs FILE | --compare-outputs FILE]
        [--sweep-auto]

Each block case is one bf16 (or f32) call at 64 images of UNI (197 tokens,
D 1024, MLP 4096), Virchow2 (261 tokens, D 1280, 16 heads of 80, packed
SwiGLU 2 x 3416 held as 2 x 3456; the int8 and flash cases, whose kernels
take head_dim 64 only, at 20 heads of 64 and 2 x 6912, `virchow2-20x64`) or
Kaiko-B/8 (785 tokens, D 768, MLP 3072) with random weights from a seed,
timed between CUDA events over back-to-back calls after a warm-up. The flash
cases are #1 on the ViT flash route's q, k, v (bf16, head_dim 64, every
token valid, JAX's key block min(256, 128 ceil(N / 128))) and at the
flagship aggregator's level-0 and deeper shapes (f32, B 32, 4 heads of 32,
lengths 1..N from a seed). The `flash_bwd` cases time the backward's dq
kernel (#2) and dk/dv kernel (#3) apart, at those two flagship shapes, at one
long bag (B 2, N 4096), in bf16 with head_dim 64 at N 257, and at (4, 4,
129, 64) in f32 and bf16 with lengths 129, 1, 0, 50. A flash call takes less
time than its launch from Python, so those are timed as device time from the
profiler's trace. The key block is passed only where the checkout's wrapper
takes one.

`--root` imports the `paths_tpu_torch` package of another checkout (a
parent commit, say), so that two versions can be timed in turns on one card;
cases whose wrapper that checkout lacks, or refuses (a head_dim it does not
take), are skipped and read null. `--only` keeps the
cases of the named kinds (`attn`, `flash`, `flash_bwd`, ...).
`--save-outputs` writes the `flash_bwd` cases' inputs to the backward (out,
lse) and its results (dq, delta, dk, dv) to a file; `--compare-outputs`
reads such a file (from another checkout's run on the same card) and reports,
per case and tensor, how many elements differ in their bits. `--slabs` also
times kernel #10 at `virchow2-20x64` with each given row-slab size
(`vit_int8.MLP_SLAB_ROWS`) and reports the peak device memory of the call.
`--sweep-auto` times `MultiheadAttention(128, 4)` in f32 on the `pallas`
route against the `xla` route, forward alone and forward + backward, in
turns between CUDA events, over bag lengths 81 .. 4096 (lengths uniform in
1..N), and names the smallest swept N from which the kernel route wins at
every larger swept N in both modes (`nn.attention.AUTO_PALLAS_MIN_LEN`).
Prints one JSON object, with the card's name and power limit, as its last
line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

SHAPES = {  # name: (images, tokens, D, heads, hidden)
    "uni": (64, 197, 1024, 16, 4096),
    "virchow2": (64, 261, 1280, 16, 3456),
    "virchow2-20x64": (64, 261, 1280, 20, 6912),
    "kaiko-b8": (64, 785, 768, 12, 3072),
}
CASES = (  # (kernel, shape, dtype)
    ("attn", "uni", "bf16"), ("attn", "virchow2", "bf16"),
    ("attn", "uni", "f32"), ("attn", "virchow2", "f32"),
    ("attn", "kaiko-b8", "bf16"), ("mlp", "uni", "bf16"),
    ("mlp", "kaiko-b8", "bf16"), ("swiglu", "virchow2", "bf16"),
    ("block", "uni", "bf16"), ("block", "kaiko-b8", "bf16"),
    ("attn_i8", "uni", "bf16"), ("attn_i8", "virchow2-20x64", "bf16"),
    ("attn_i8", "kaiko-b8", "bf16"), ("attn_i8", "uni", "f32"),
    ("mlp_i8", "uni", "bf16"), ("mlp_i8", "kaiko-b8", "bf16"),
    ("swiglu_i8", "virchow2-20x64", "bf16"), ("swiglu_i8", "virchow2-20x64", "f32"),
    ("flash", "uni", "bf16"), ("flash", "virchow2-20x64", "bf16"),
    ("flash", "kaiko-b8", "bf16"), ("flash", "level0", "f32"),
    ("flash", "deeper", "f32"),
    ("flash_bwd", "level0", "f32"), ("flash_bwd", "deeper", "f32"),
    ("flash_bwd", "long", "f32"), ("flash_bwd", "level0-d64", "bf16"),
    ("flash_bwd", "small-d64", "f32"), ("flash_bwd", "small-d64", "bf16"),
)
# the flagship aggregator's attention (`models/brca_paths_0`): slides, keys
FLAGSHIP = {"level0": (32, 257), "deeper": (32, 81)}
# the backward's cases: (B, H, N, D); lengths from a seed unless listed
FLASH_BWD = {"level0": (32, 4, 257, 32), "deeper": (32, 4, 81, 32),
             "long": (2, 4, 4096, 32), "level0-d64": (32, 4, 257, 64),
             "small-d64": (4, 4, 129, 64)}
FLASH_BWD_LENGTHS = {"small-d64": [129, 1, 0, 50]}
# the `--sweep-auto` bag lengths, and the batch at each
SWEEP = ((81, 32), (257, 32), (513, 32), (1025, 32), (2049, 2), (4096, 2))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of one call: its kernels' time in the profiler's
    trace over `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / iters


def flash_call(torch, tfa, shape, dtype):
    """#1 on the shape's q, k, v (B, H, N, D) with its lengths."""
    gen = torch.Generator().manual_seed(7)
    if shape in FLAGSHIP:
        b, n = FLAGSHIP[shape]
        h, d = 4, 32
        lengths = torch.randint(1, n + 1, (b,), generator=gen, dtype=torch.int32)
        block_k = 128
    else:
        b, n, dim, h, _ = SHAPES[shape]
        d = dim // h
        lengths = torch.full((b,), n, dtype=torch.int32)
        block_k = min(256, 128 * -(-n // 128))
    q, k, v = (torch.randn(b, h, n, d, generator=gen).to("cuda", dtype)
               for _ in range(3))
    ln = lengths.cuda()
    fwd = tfa.masked_flash_attention_fwd
    if "block_k" in inspect.signature(fwd).parameters:
        return lambda: fwd(q, k, v, ln, block_k=block_k)
    return lambda: fwd(q, k, v, ln)


def flash_bwd_calls(torch, tfa, shape, dtype):
    """(dq call, dk/dv call, the tensors to save): #2 and #3 on the shape's
    inputs, whose out and lse come from the forward kernel."""
    b, h, n, d = FLASH_BWD[shape]
    gen = torch.Generator().manual_seed(11)
    lengths = torch.randint(1, n + 1, (b,), generator=gen, dtype=torch.int32)
    if shape in FLASH_BWD_LENGTHS:
        lengths = torch.tensor(FLASH_BWD_LENGTHS[shape], dtype=torch.int32)
    q, k, v, dout = (torch.randn(b, h, n, d, generator=gen).to("cuda", dtype)
                     for _ in range(4))
    ln = lengths.cuda()
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
    dq, delta = tfa.masked_flash_attention_bwd_dq(q, k, v, ln, out, lse, dout)
    dk, dv = tfa.masked_flash_attention_bwd_dkv(q, k, v, ln, lse, dout, delta)
    saved = {"out": out, "lse": lse, "dq": dq, "delta": delta, "dk": dk,
             "dv": dv}
    return (lambda: tfa.masked_flash_attention_bwd_dq(q, k, v, ln, out, lse, dout),
            lambda: tfa.masked_flash_attention_bwd_dkv(q, k, v, ln, lse, dout,
                                                       delta),
            {key: t.cpu() for key, t in saved.items()})


def bits_differ(a, b) -> int:
    """Elements of two same-typed tensors whose bit patterns differ."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return int((a.view(bits) != b.view(bits)).sum())


def sweep_auto(torch, cuda_ms_fn):
    """`MultiheadAttention(128, 4)` on the kernel route against the plain
    route, f32, dropout 0: ms per call between CUDA events, forward alone
    (no grad) and forward + backward (gradients of the input and every
    weight), in turns xla, pallas, pallas, xla at each swept bag length."""
    from paths_tpu_torch.nn.attention import MultiheadAttention

    rows = {}
    for n, b in SWEEP:
        gen = torch.Generator().manual_seed(n)
        mha = MultiheadAttention(128, 4, generator=gen).cuda()
        x = torch.randn(b, n, 128, generator=gen).cuda().requires_grad_(True)
        dy = torch.randn(b, n, 128, generator=gen).cuda()
        lengths = torch.randint(1, n + 1, (b,), generator=gen)
        valid = (torch.arange(n)[None] < lengths[:, None]).cuda()
        params = [x, *mha.parameters()]

        def fwd(impl):
            with torch.no_grad():
                return mha(x, x, x, key_valid=valid, impl=impl)

        def fwd_bwd(impl):
            y = mha(x, x, x, key_valid=valid, impl=impl)
            return torch.autograd.grad(y, params, dy)

        iters = 20 if n > 1024 else 50
        row = {}
        for mode, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            turns = {"xla": [], "pallas": []}
            for impl in ("xla", "pallas", "pallas", "xla", "xla", "pallas"):
                turns[impl].append(cuda_ms_fn(torch, lambda: fn(impl), iters,
                                              warmup=5))
            row[mode] = {impl: sum(t) / len(t) for impl, t in turns.items()}
            row[mode]["turns"] = turns
        rows[str(n)] = dict(batch=b, **row)
        print(f"sweep N={n} B={b}: " + ", ".join(
            f"{mode} xla {row[mode]['xla']:.4f} pallas {row[mode]['pallas']:.4f} ms"
            for mode in ("fwd", "fwd_bwd")), flush=True)
        del mha, x, dy, valid, params
        torch.cuda.empty_cache()
    wins = [all(rows[str(n)][m]["pallas"] < rows[str(n)][m]["xla"]
                for m in ("fwd", "fwd_bwd")) for n, _ in SWEEP]
    auto_min_len = None
    for i in range(len(SWEEP) - 1, -1, -1):
        if not wins[i]:
            break
        auto_min_len = SWEEP[i][0]
    return {"lengths": rows, "auto_min_len": auto_min_len}


def make_call(torch, tvf, tvi, kernel, shape, dtype):
    """The kernel's wrapper bound to random inputs, or None where this
    checkout has no such wrapper."""
    b, n, d, heads, hidden = SHAPES[shape]
    gen = torch.Generator().manual_seed(7)
    rnd = lambda *s, scale=1.0, base=0.0: (
        base + scale * torch.randn(*s, generator=gen)).cuda()
    x = rnd(b, n, d).to(dtype)
    ns, nb, ls = rnd(d, scale=0.1, base=1.0), rnd(d, scale=0.1), \
        rnd(d, scale=0.1, base=1.0)
    packed = 2 if kernel.startswith("swiglu") else 1
    w = lambda rows, cols: rnd(rows, cols, scale=cols ** -0.5)
    q = lambda t: tvi.quantize_weight(t)
    if kernel == "attn":
        a = (x, ns, nb, w(3 * d, d).to(dtype), rnd(3 * d, scale=0.1),
             w(d, d).to(dtype), rnd(d, scale=0.1), ls)
        return lambda: tvf.fused_attn_block(*a, num_heads=heads)
    if kernel == "attn_i8":
        a = (x, ns, nb, q(w(3 * d, d)), q(w(d, d)), rnd(3 * d, scale=0.1),
             rnd(d, scale=0.1), ls)
        return lambda: tvi.fused_attn_block_i8(*a, num_heads=heads)
    if kernel == "block":
        tree = {"norm1": {"scale": ns, "bias": nb},
                "attn": {"qkv_w": w(3 * d, d).to(dtype), "qkv_b": rnd(3 * d, scale=0.1),
                         "proj_w": w(d, d).to(dtype), "proj_b": rnd(d, scale=0.1)},
                "norm2": {"scale": ns, "bias": nb},
                "mlp": {"fc1_w": w(hidden, d).to(dtype), "fc1_b": rnd(hidden, scale=0.1),
                        "fc2_w": w(d, hidden).to(dtype), "fc2_b": rnd(d, scale=0.1)},
                "ls1": ls, "ls2": ls}
        return lambda: tvf.fused_block(x, tree, num_heads=heads)
    w1, w2 = w(packed * hidden, d), w(d, hidden)
    b1, b2 = rnd(packed * hidden, scale=0.1), rnd(d, scale=0.1)
    if kernel in ("mlp", "swiglu"):
        a = (x, ns, nb, w1.to(dtype), b1, w2.to(dtype), b2, ls)
        fn = tvf.fused_mlp_block if kernel == "mlp" else tvf.fused_swiglu_mlp_block
        return lambda: fn(*a)
    a = (x, ns, nb, q(w1), b1, q(w2), b2, ls)
    fn = tvi.fused_mlp_block_i8 if kernel == "mlp_i8" else tvi.fused_swiglu_mlp_block_i8
    return lambda: fn(*a)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--slabs", default="", help="row-slab sizes for #10")
    ap.add_argument("--only", default="", help="case kinds to run (comma list)")
    ap.add_argument("--save-outputs", default="",
                    help="file for the flash_bwd cases' results")
    ap.add_argument("--compare-outputs", default="",
                    help="file of another run's flash_bwd results")
    ap.add_argument("--sweep-auto", action="store_true",
                    help="time the attention routes across bag lengths")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_vit: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from paths_tpu_torch.kernels import flash_attention as tfa
    from paths_tpu_torch.kernels import vit_fused as tvf
    from paths_tpu_torch.kernels import vit_int8 as tvi

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    only = set(filter(None, args.only.split(",")))
    times, saved, differ = {}, {}, {}
    with torch.no_grad():
        for kernel, shape, dt in CASES:
            if only and kernel not in only:
                continue
            if kernel == "flash_bwd":
                dq_fn, dkv_fn, tensors = flash_bwd_calls(torch, tfa, shape,
                                                         dtypes[dt])
                iters = 10 if FLASH_BWD[shape][2] > 1024 else 50
                times[f"flash_bwd_dq {shape} {dt}"] = device_ms(torch, dq_fn, iters)
                times[f"flash_bwd_dkv {shape} {dt}"] = device_ms(torch, dkv_fn, iters)
                saved[f"{shape} {dt}"] = tensors
                del dq_fn, dkv_fn
                torch.cuda.empty_cache()
                continue
            if kernel == "flash":
                fn = flash_call(torch, tfa, shape, dtypes[dt])
                times[f"{kernel} {shape} {dt}"] = device_ms(torch, fn)
                del fn
                continue
            fn = make_call(torch, tvf, tvi, kernel, shape, dtypes[dt])
            try:
                times[f"{kernel} {shape} {dt}"] = cuda_ms(torch, fn)
            except ValueError as e:     # a shape this checkout refuses
                times[f"{kernel} {shape} {dt}"] = None
                print(f"{kernel} {shape} {dt}: skipped ({e})", file=sys.stderr)
            del fn
            torch.cuda.empty_cache()
        slabs = {}
        for slab in [int(s) for s in args.slabs.split(",") if s]:
            tvi.MLP_SLAB_ROWS = slab
            fn = make_call(torch, tvf, tvi, "swiglu_i8", "virchow2-20x64",
                           torch.bfloat16)
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            slabs[str(slab)] = {"ms": cuda_ms(torch, fn), "call_peak_mib": peak}
            del fn
            torch.cuda.empty_cache()
    if args.save_outputs:
        torch.save(saved, args.save_outputs)
    if args.compare_outputs:
        other = torch.load(args.compare_outputs)
        for case, tensors in saved.items():
            differ[case] = {key: bits_differ(t, other[case][key])
                            if case in other else None
                            for key, t in tensors.items()}
            print(f"bits differing from {args.compare_outputs}, {case}: "
                  f"{differ[case]}", flush=True)
    sweep = sweep_auto(torch, cuda_ms) if args.sweep_auto else None
    print(json.dumps({"root": os.path.abspath(args.root), "card": card(),
                      "ms": times, "swiglu_i8_slabs": slabs,
                      "flash_bwd_bits_differing": differ,
                      "auto_sweep": sweep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
