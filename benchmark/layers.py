"""The arithmetic the per-layer readers share (`benchmark/metrics/*.py`):
shares of a roofline or a peak, the device's idle share, percentiles.
A reader that finds nothing to read returns None, and the metric is left
out of the result line."""
from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from benchmark import roofline

VIT_LN = "vit_ln_kernel"
VIT_ATTN = "vit_attn_"
VIT_END = "EpiResidual"


def idle_pct(layer) -> Optional[float]:
    t = layer.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def mfu_pct(layer, flops: float, dtype: str) -> Optional[float]:
    """The useful work's operations over the window's length and the
    chip's peak in the configuration's type."""
    pk = layer.run.peaks
    if pk is None or layer.driver.window_s <= 0:
        return None
    return 100.0 * flops / layer.driver.window_s / pk[dtype]


def vit_groups(trace) -> List[dict]:
    """The ViT block kernels' launches in the trace, each a run of device
    kernels from a LayerNorm pre-pass to the residual GEMM: kind "attn"
    (holds the attention kernel, whose grid's z is the batch) or "mlp";
    its images and its device seconds."""
    groups, cur, batch = [], None, None
    for op in trace.kernels("."):
        if VIT_LN in op.name:
            cur = [op]
            continue
        if cur is None:
            continue
        cur.append(op)
        if VIT_END in op.name:
            attn = [o for o in cur if VIT_ATTN in o.name]
            if attn:
                batch = int(attn[0].args.get("grid", [0, 0, 0])[2])
                kind = "attn"
            else:
                kind = "mlp"
            if batch:
                groups.append({"kind": kind, "images": batch,
                               "seconds": sum(o.end - o.start for o in cur) * 1e-6})
            cur = None
    return groups


def vit_roofline_pct(layer, kind: str) -> Optional[float]:
    pk, t = layer.run.peaks, layer.trace
    if pk is None or t is None:
        return None
    dims = layer.run.config["model"]
    n = (dims["img_size"] // dims["patch_size"]) ** 2 + 1
    hidden = int(dims["embed_dim"] * dims["mlp_ratio"])
    dt = dims["compute_dtype"]
    item = 2 if dt == "bfloat16" else 4
    bound = spent = 0.0
    for g in vit_groups(t):
        if g["kind"] != kind:
            continue
        ops, nbytes = roofline.vit_block_counts(kind, g["images"], n,
                                                dims["embed_dim"], hidden, item)
        bound += roofline.bound_seconds(ops, nbytes, pk[dt], pk["bytes_per_s"])
        spent += g["seconds"]
    return 100.0 * bound / spent if spent > 0 else None


FLASH_KERNELS = {"fwd": "flash_fwd_", "bwd": "flash_bwd_d(q|kv)_kernel"}


def flash_roofline_pct(layer, kind: str) -> Optional[float]:
    """Recorded launches' least time over the flash kernels' device time in
    the traced segment; None unless every traced kernel was counted."""
    pk, t = layer.run.peaks, layer.trace
    flash = getattr(layer.driver, "flash", None)
    if pk is None or t is None or flash is None:
        return None
    ops_list = t.kernels(FLASH_KERNELS[kind])
    spent = sum(o.end - o.start for o in ops_list) * 1e-6
    launches = [x for x in flash.host() if x[0] == kind]
    want = len(launches) * (2 if kind == "bwd" else 1)
    if want != len(ops_list) or not ops_list:
        # a launch the count missed (an entry reached by another name, a
        # fused kernel) would read the share low: the metric falls silent
        print(f"flash {kind}: {len(launches)} launches counted, "
              f"{len(ops_list)} kernels traced; no share", file=sys.stderr)
        return None
    bound = 0.0
    for _, (b, h, nq, d), nk, item, lengths in launches:
        if kind == "fwd":
            ops, nbytes = roofline.flash_fwd_counts(b, h, nq, d, lengths, item)
        else:
            ops, nbytes = roofline.flash_bwd_counts(b, h, nq, nk, d, lengths, item)
        peak = pk["float32"] if item == 4 else pk["bfloat16"]
        bound += roofline.bound_seconds(ops, nbytes, peak, pk["bytes_per_s"])
    return 100.0 * bound / spent if spent > 0 else None


def percentile_ms(seconds: List[float], q: float) -> Optional[float]:
    if not seconds:
        return None
    return 1000.0 * float(np.percentile(np.asarray(seconds), q))
