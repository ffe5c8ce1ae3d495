"""Compact per-level feature tables (counterpart of
`paths_tpu.engine.tables`).

A `LevelTable` stores only the non-background feature rows of a level plus
an index grid mapping (y, x) -> row (-1 = background), so the device-side
child gather is two lookups and the device holds tissue-sized data. Row
order is grid row-major over non-background cells, then row-major over
background cells: the order of the all-background fallback bags.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class LevelTable:
    """Batched compact features for one magnification level.

    fts     (B, M, D)   non-bg features first, zero rows after `count`
    locs    (B, M, 2)   grid coords (y, x) of each row
    count   (B,)        number of non-background rows per slide
    index   (B, H, W)   grid -> row, -1 where background or out of grid
    grid_hw (B, 2)      true (unpadded) grid dims per slide
    """

    fts: torch.Tensor
    locs: torch.Tensor
    count: torch.Tensor
    index: torch.Tensor
    grid_hw: torch.Tensor


def build_level_table(grid: np.ndarray, min_rows: int = 0) -> dict:
    """Host-side: dense (H, W, D) grid -> single-slide table dict (numpy).

    Background = all-zero feature vector, tested as sum == 0 (for f16
    grids, as "no entry is nonzero", so a live row cannot underflow to a
    zero sum)."""
    h, w, d = grid.shape
    flat = grid.reshape(-1, d)
    if flat.dtype == np.float16:
        bg = ~np.any(flat != 0, axis=1)
    else:
        bg = flat.sum(axis=1) == 0
    nz = np.flatnonzero(~bg)           # row-major order
    z = np.flatnonzero(bg)
    count = len(nz)

    m = max(count + min(len(z), max(min_rows - count, 0)), min_rows)
    order = np.concatenate([nz, z])[:m]

    fts = np.zeros((m, d), grid.dtype)
    locs = np.zeros((m, 2), np.int32)
    fts[: len(order)] = flat[order]
    locs[: len(order), 0] = order // w
    locs[: len(order), 1] = order % w

    index = np.full((h, w), -1, np.int32)
    index.reshape(-1)[nz] = np.arange(count, dtype=np.int32)

    return {"fts": fts, "locs": locs, "count": np.int32(count),
            "index": index, "grid_hw": np.array([h, w], np.int32)}


def stack_dtype(dtypes: Sequence[np.dtype]) -> np.dtype:
    """Dtype a batch of host feature arrays stacks at: the widest input."""
    return max({np.dtype(d) for d in dtypes}, key=lambda d: d.itemsize)


def stack_tables(tables: Sequence[dict], min_rows: int = 0,
                 pad_rows_to: Optional[int] = None,
                 pad_grid_to: Optional[tuple] = None,
                 dtype: torch.dtype = torch.float32,
                 device="cuda") -> LevelTable:
    """Pad single-slide tables to common shapes, stack, and place them on
    `device` with features cast to `dtype` there."""
    b = len(tables)
    m = max(max(t["fts"].shape[0] for t in tables), min_rows)
    if pad_rows_to is not None:
        m = max(m, pad_rows_to)
    h = max(t["index"].shape[0] for t in tables)
    w = max(t["index"].shape[1] for t in tables)
    if pad_grid_to is not None:
        h, w = max(h, pad_grid_to[0]), max(w, pad_grid_to[1])
    d = tables[0]["fts"].shape[1]

    fts = np.zeros((b, m, d), stack_dtype([t["fts"].dtype for t in tables]))
    locs = np.zeros((b, m, 2), np.int32)
    count = np.zeros((b,), np.int32)
    index = np.full((b, h, w), -1, np.int32)
    grid_hw = np.zeros((b, 2), np.int32)
    for i, t in enumerate(tables):
        mi = t["fts"].shape[0]
        hi, wi = t["index"].shape
        fts[i, :mi] = t["fts"]
        locs[i, :mi] = t["locs"]
        count[i] = t["count"]
        index[i, :hi, :wi] = t["index"]
        grid_hw[i] = t["grid_hw"]

    def put(a):
        return torch.from_numpy(a).to(device).long()

    return LevelTable(fts=torch.from_numpy(fts).to(device).to(dtype),
                      locs=put(locs), count=put(count), index=put(index),
                      grid_hw=put(grid_hw))


def bag_widths(top_k_patches, num_levels: int, n0: int):
    """Static patch-slot counts per level: level 0 has `n0` slots; level
    i+1 has 4*K_i (or 4*width_i when K_i = -1, the keep-all mode)."""
    widths = [n0]
    for i in range(num_levels - 1):
        k = top_k_patches[i]
        prev = widths[-1]
        widths.append(4 * (prev if k == -1 else min(k, prev)))
    return widths


def level0_bag_arrays(grid: np.ndarray, patch_size: int):
    """Host-side level-0 bag of ONE slide: every grid cell, background
    included. Returns (fts view (H*W, D), locs in pixels, n)."""
    h, w, d = grid.shape
    fts = grid.reshape(-1, d)
    ys, xs = np.divmod(np.arange(h * w, dtype=np.int32), w)
    locs = np.stack([ys, xs], axis=1) * patch_size
    return fts, locs, h * w
