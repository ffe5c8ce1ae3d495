"""Tiny copies of the benchmark's configurations and traffic, for runs of
the harness on the CPU: the same drivers and checks at sizes a test run
can hold (widths and depths cut, the plain routes)."""
from __future__ import annotations

import copy
import os

from benchmark import harness


def _file(kind: str, name: str) -> dict:
    return harness.read_json(os.path.join(harness.BENCH, kind, f"{name}.json"))


def uni() -> tuple:
    cfg = copy.deepcopy(_file("configs", "uni-vitl16"))
    cfg["model"].update(embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0,
                        compute_dtype="float32", block_impl="xla")
    tr = copy.deepcopy(_file("traffic", "slides_10x"))
    tr["slides"].update(count=2, height=1024, width=768)
    tr["magnifications"] = [5.0, 10.0]
    tr["pipeline"].update(batch_size=8, threads=2)
    tr["check"]["sample_patches"] = 6
    tr["check"]["limits"]["feature_gap"] = 1e-4
    tr["trace_seconds"] = 0.2
    return cfg, tr


def brca(traffic: str, card: bool = False) -> tuple:
    """On a card the heads are 32 wide, a width the flash kernels take."""
    cfg = copy.deepcopy(_file("configs", "brca_paths_0"))
    m = cfg["model"]
    m.update(num_levels=3, top_k_patches=4, batch_size=4)
    m["model_config"].update(patch_embed_dim=16, trans_dim=64 if card else 8,
                             trans_heads=2, importance_mlp_hidden_dim=8,
                             hierarchical_ctx_mlp_hidden_dim=8)
    tr = copy.deepcopy(_file("traffic", traffic))
    tr["cohort"].update(slides=6, base_hw=[3, 4], jitter=2, seed=5)
    tr["trace_seconds"] = 0.2
    if tr["driver"] == "predict":
        tr.update(request_slides=4)
        tr["check"]["limits"]["hazard_gap"] = 1e-5
    else:
        tr["check"]["limits"].update(loss_gap=1e-5, grad_gap=1e-4, change_gap=2e-2)
    return cfg, tr


def bench() -> dict:
    return harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def run(cell: str, cfg: dict, tr: dict, seed: int = 3, seconds: float = 0.5,
        trace: bool = False, cache: str = harness.CACHE) -> dict:
    b = bench()
    return harness.execute(cell, cfg, tr, seed, seconds, trace,
                           harness.metrics_of(b, cell, "end_to_end"),
                           harness.metrics_of(b, cell, "per_layer"),
                           device="cpu", cache=cache)

