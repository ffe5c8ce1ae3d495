"""Operation and byte counts of the kernels and models the benchmark
measures, and the chip's peaks (`peaks.json`).

Every count is of the work the inputs need: 2 operations per
multiply-add, products over valid keys only for the masked attention,
each input read once and each output written once. A kernel's roofline
share is the least time the chip could take (the larger of operations
over peak rate and bytes over peak bandwidth) over its measured time.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the named card, or None for a card the table
    lacks (whose shares are then not reported)."""
    with open(_PEAKS) as f:
        table = json.load(f)
    for prefix, row in table["cards"].items():
        if device_name.startswith(prefix):
            return row
    return None


def flash_fwd_counts(b: int, h: int, nq: int, d: int, lengths: Sequence[int],
                     item: int) -> tuple:
    """(operations, bytes) of one masked flash-attention forward: QK^T and
    PV over the valid keys of each batch row, for every query row; q and out
    over every row, k and v over the valid rows (`item` bytes each), the
    f32 log-sum-exp and the int32 lengths once."""
    valid = float(sum(lengths))
    ops = 4.0 * h * nq * d * valid
    nbytes = item * (2.0 * b * h * nq * d + 2.0 * h * valid * d) + 4.0 * (b * h * nq + b)
    return ops, nbytes


def flash_bwd_counts(b: int, h: int, nq: int, nk: int, d: int,
                     lengths: Sequence[int], item: int) -> tuple:
    """(operations, bytes) of the two backward kernels of one launch pair:
    dq = 3 products (S, dP, dS K), dk/dv = 4 (S, dP, P^T dO, dS^T Q), over
    the valid keys. Bytes: the dq pass reads q, O and dO over every row, k
    and v over the valid rows, lse, and writes dq and delta; the dk/dv pass
    reads q and dO over every row, k and v over the valid rows, lse and
    delta, and writes dk and dv over every row."""
    valid = float(sum(lengths))
    rows_q, rows_k, vec = b * h * nq * d, b * h * nk * d, b * h * nq
    kv = 2.0 * h * valid * d
    ops = 2.0 * (3 + 4) * h * nq * d * valid
    nbytes = (item * (4 * rows_q + kv) + 4.0 * (2 * vec + b)
              + item * (2 * rows_q + kv + 2 * rows_k) + 4.0 * (2 * vec + b))
    return ops, nbytes


def vit_block_counts(kind: str, b: int, n: int, d: int, hidden: int,
                     item: int) -> tuple:
    """(operations, bytes) of one ViT block kernel on x (b, n, d): the
    attention block (qkv and proj products, QK^T and PV) or the GELU MLP
    block (fc1 and fc2); x read once, out written once, every weight read
    once in the compute type, the f32 vectors once."""
    rows = b * n
    if kind == "attn":
        ops = 2.0 * rows * d * 3 * d + 2.0 * rows * d * d + 4.0 * b * n * n * d
        weights, vectors = 4 * d * d, 7 * d
    elif kind == "mlp":
        ops = 4.0 * rows * d * hidden
        weights, vectors = 2 * d * hidden, 4 * d + hidden
    else:
        raise ValueError(kind)
    return ops, item * (2.0 * rows * d + weights) + 4.0 * vectors


def bound_seconds(ops: float, nbytes: float, peak_ops: float,
                  peak_bytes: float) -> float:
    return max(ops / peak_ops, nbytes / peak_bytes)


def vit_flops_per_image(dims: dict) -> float:
    """A ViT forward's operations per image: the patch embedding, and per
    block the qkv / proj products (8 n d^2), QK^T and PV (4 n^2 d) and the
    MLP (4 n d m); n counts the class token."""
    p, d = dims["patch_size"], dims["embed_dim"]
    n = (dims["img_size"] // p) ** 2 + 1
    m = int(d * dims["mlp_ratio"])
    per_block = 8 * n * d * d + 4 * n * n * d + 4 * n * d * m
    return float(dims["depth"] * per_block + 2 * (n - 1) * p * p * 3 * d)


def paths_level_flops(n: int, dims) -> float:
    """A PATHS level's forward operations on a bag of n patches (no
    padding): the LSTM cell's packed gates and memory map, the importance
    MLP, the projection, and each decoder layer's self-attention
    projections, scores and values over n + 1 rows and feed-forward (the
    cross-attention over the empty conditional sequence does no product),
    and the head."""
    d, t, hc = dims.d, dims.t, dims.ctx_hidden
    f = 2.0 * n * (2 * d) * (3 * hc + d) + 2.0 * n * hc * d
    f += 2.0 * n * d * dims.imp_hidden + 2.0 * n * dims.imp_hidden
    f += 2.0 * n * d * t
    rows = n + 1
    f += dims.layers * (8.0 * rows * t * t + 4.0 * rows * rows * t
                        + 4.0 * rows * t * 4 * t)
    return f + 2.0 * t * dims.n_logits


def paths_slide_flops(rows_per_level: Sequence[int], dims) -> float:
    return sum(paths_level_flops(n, dims) for n in rows_per_level)
