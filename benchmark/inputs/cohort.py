"""The PATHS cells' cohort: a feature store of synthetic slide pyramids in
the layout the preprocessor writes (`{slide_id}_{power:.3f}.npy`, one
H x W x D grid per magnification, all-zero rows for background).

The recipe is the repository's synthetic store's: per slide a base grid of
`base_hw` plus a jitter of up to `jitter` - 1 cells on each axis, doubled
at each level; every level a normal grid (0.2 + 0.5 z) with a round tissue
blob at a random centre holding `tissue` of the cells, background zeroed.
The grids are drawn on the device. The cohort is the cell's data set: it
depends on the traffic file's `cohort` entry alone, not on the run's seed,
so it is written once per checkout, under a directory named by a hash of
that entry, and found there by later runs (a run that dies while writing
leaves no `DONE` file, and the next run writes it again). Each file is
synced as it is written, so that the write-back lands in the first run's
set-up and not in the windows of the runs after it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import List, Tuple

import numpy as np
import torch

from benchmark.inputs.weights import generator

VERSION = 1


def slide_ids(spec: dict) -> List[str]:
    return [f"BENCH-{i:04d}" for i in range(spec["slides"])]


def powers(spec: dict) -> List[float]:
    return [spec["base_power"] * 2 ** lvl for lvl in range(spec["levels"])]


def grid_path(root: str, sid: str, power: float) -> str:
    return os.path.join(root, f"{sid}_{power:.3f}.npy")


def store(spec: dict, cache_root: str, device) -> Tuple[str, List[str]]:
    """(store root, slide ids) of the cohort, written if not there yet."""
    key = hashlib.sha256(json.dumps([VERSION, spec], sort_keys=True)
                         .encode()).hexdigest()[:16]
    root = os.path.join(cache_root, f"cohort-{key}")
    ids = slide_ids(spec)
    if os.path.isfile(os.path.join(root, "DONE")):
        return root, ids
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(spec["seed"])
    g = generator(spec["seed"], 7, device)
    dtype = np.dtype(spec["dtype"])
    for sid in ids:
        h = spec["base_hw"][0] + int(rng.integers(0, spec["jitter"]))
        w = spec["base_hw"][1] + int(rng.integers(0, spec["jitter"]))
        for lvl, power in enumerate(powers(spec)):
            gh, gw = h * 2 ** lvl, w * 2 ** lvl
            yy, xx = np.mgrid[0:gh, 0:gw]
            cy, cx = rng.uniform(0.3, 0.7) * gh, rng.uniform(0.3, 0.7) * gw
            r2 = ((yy - cy) / gh) ** 2 + ((xx - cx) / gw) ** 2
            tissue = torch.from_numpy(r2 <= np.quantile(r2, spec["tissue"]))
            grid = torch.randn((gh, gw, spec["dim"]), generator=g,
                               device=device) * 0.5 + 0.2
            grid = grid * tissue.to(device)[..., None]
            with open(grid_path(root, sid, power), "wb") as f:
                np.save(f, grid.to(getattr(torch, spec["dtype"])).cpu().numpy()
                        .astype(dtype, copy=False))
                f.flush()
                os.fsync(f.fileno())
    with open(os.path.join(root, "DONE"), "w") as f:
        json.dump(spec, f)
    return root, ids


def load_grids(root: str, sid: str, spec: dict) -> List[np.ndarray]:
    """One slide's grids, level 0 first."""
    return [np.load(grid_path(root, sid, p)) for p in powers(spec)]
