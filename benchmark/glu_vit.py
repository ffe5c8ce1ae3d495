"""Operation and byte counts of a ViT with register tokens and timm's
packed SwiGLU MLP (`GluMlp`: fc1 d -> 2 h, SiLU of the first half times
the second, fc2 h -> d), as Virchow2 has, and the roofline shares of its
block kernels for the per-layer readers.

Counted as `roofline.py` counts: 2 operations per multiply-add, each input
read once and each output written once. The MLP is counted at the
published branch width h (`glu_width`, 3416), not at the width the program
pads it to (3456): the padding is work the program chose.
"""
from __future__ import annotations

from typing import Optional

from benchmark import roofline
from benchmark.layers import vit_groups
from benchmark.reference.virchow2 import num_tokens as tokens

ATTN_HD80 = "vit_attn_hd80_"


def swiglu_block_counts(b: int, n: int, d: int, h: int, item: int) -> tuple:
    """(operations, bytes) of one packed-SwiGLU MLP block kernel on x
    (b, n, d): fc1 (2 h outputs) and fc2; x read once, out written once,
    the weights once in the compute type, the f32 vectors (LayerNorm scale
    and bias, both biases, LayerScale) once."""
    rows = b * n
    ops = 2.0 * rows * d * 2 * h + 2.0 * rows * h * d
    weights, vectors = 3 * d * h, 4 * d + 2 * h
    return ops, item * (2.0 * rows * d + weights) + 4.0 * vectors


def flops_per_image(dims: dict) -> float:
    """A forward's operations per image: the patch embedding, and per block
    the qkv / proj products (8 n d^2), QK^T and PV (4 n^2 d) and the packed
    SwiGLU MLP (6 n d h); n counts the class and register tokens."""
    p, d, h = dims["patch_size"], dims["embed_dim"], dims["glu_width"]
    n = tokens(dims)
    per_block = 8 * n * d * d + 4 * n * n * d + 6 * n * d * h
    patches = (dims["img_size"] // p) ** 2
    return float(dims["depth"] * per_block + 2 * patches * p * p * 3 * d)


def roofline_pct(layer, kind: str) -> Optional[float]:
    """Kernel #4 ("attn") or #6 ("mlp", the packed SwiGLU block): the
    least time of the traced launches over their device time, in %. The
    attention share needs #4's head-dim-80 kernel in the trace: None
    without it (a program that runs another head dim)."""
    pk, t = layer.run.peaks, layer.trace
    if pk is None or t is None:
        return None
    if kind == "attn" and not t.kernels(ATTN_HD80):
        return None
    dims = layer.run.config["model"]
    n, d, h = tokens(dims), dims["embed_dim"], dims["glu_width"]
    dt = dims["compute_dtype"]
    item = 2 if dt == "bfloat16" else 4
    bound = spent = 0.0
    for g in vit_groups(t):
        if g["kind"] != kind:
            continue
        if kind == "attn":
            ops, nbytes = roofline.vit_block_counts("attn", g["images"], n, d,
                                                    0, item)
        else:
            ops, nbytes = swiglu_block_counts(g["images"], n, d, h, item)
        bound += roofline.bound_seconds(ops, nbytes, pk[dt], pk["bytes_per_s"])
        spent += g["seconds"]
    return 100.0 * bound / spent if spent > 0 else None
