"""Time the ViT block kernels (#4-#10) and the flash forward (#1) at the
shapes their paths give them on one GPU.

    python3 paths_tpu_torch/kernels/bench_vit.py [--root TREE] [--slabs N,N,..]

Each block case is one bf16 (or f32) call at 64 images of UNI (197 tokens,
D 1024, MLP 4096), Virchow2 (261 tokens, D 1280, packed SwiGLU 6912) or
Kaiko-B/8 (785 tokens, D 768, MLP 3072) with random weights from a seed,
timed between CUDA events over back-to-back calls after a warm-up. The flash
cases are #1 on the ViT flash route's q, k, v (bf16, head_dim 64, every
token valid, JAX's key block min(256, 128 ceil(N / 128))) and at the
flagship aggregator's level-0 and deeper shapes (f32, B 32, 4 heads of 32,
lengths 1..N from a seed); a call of #1 takes less time than its launch
from Python, so they are timed as device time from the profiler's trace.
The key block is passed only where the checkout's wrapper takes one.
`--root` imports the
`paths_tpu_torch` package of another checkout (a parent commit, say), so
that two versions can be timed in turns on one card; cases whose wrapper
that checkout lacks are skipped. `--slabs` also times kernel #10 at
Virchow2 with each given row-slab size (`vit_int8.MLP_SLAB_ROWS`) and reports
the peak device memory of the call. Prints one JSON object, with the card's
name and power limit, as its last line.
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
    "virchow2": (64, 261, 1280, 20, 6912),
    "kaiko-b8": (64, 785, 768, 12, 3072),
}
CASES = (  # (kernel, shape, dtype)
    ("attn", "uni", "bf16"), ("attn", "virchow2", "bf16"),
    ("attn", "kaiko-b8", "bf16"), ("mlp", "uni", "bf16"),
    ("mlp", "kaiko-b8", "bf16"), ("swiglu", "virchow2", "bf16"),
    ("block", "uni", "bf16"), ("block", "kaiko-b8", "bf16"),
    ("attn_i8", "uni", "bf16"), ("attn_i8", "virchow2", "bf16"),
    ("attn_i8", "kaiko-b8", "bf16"), ("attn_i8", "uni", "f32"),
    ("mlp_i8", "uni", "bf16"), ("mlp_i8", "kaiko-b8", "bf16"),
    ("swiglu_i8", "virchow2", "bf16"), ("swiglu_i8", "virchow2", "f32"),
    ("flash", "uni", "bf16"), ("flash", "virchow2", "bf16"),
    ("flash", "kaiko-b8", "bf16"), ("flash", "level0", "f32"),
    ("flash", "deeper", "f32"),
)
# the flagship aggregator's attention (`models/brca_paths_0`): slides, keys
FLAGSHIP = {"level0": (32, 257), "deeper": (32, 81)}


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
    times = {}
    with torch.no_grad():
        for kernel, shape, dt in CASES:
            if kernel == "flash":
                fn = flash_call(torch, tfa, shape, dtypes[dt])
                times[f"{kernel} {shape} {dt}"] = device_ms(torch, fn)
                del fn
                continue
            fn = make_call(torch, tvf, tvi, kernel, shape, dtypes[dt])
            times[f"{kernel} {shape} {dt}"] = cuda_ms(torch, fn)
            del fn
            torch.cuda.empty_cache()
        slabs = {}
        for slab in [int(s) for s in args.slabs.split(",") if s]:
            tvi.MLP_SLAB_ROWS = slab
            fn = make_call(torch, tvf, tvi, "swiglu_i8", "virchow2", torch.bfloat16)
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
    print(json.dumps({"root": os.path.abspath(args.root), "card": card(),
                      "ms": times, "swiglu_i8_slabs": slabs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
