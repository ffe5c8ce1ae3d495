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
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from paths_tpu_torch import native
from paths_tpu_torch.profiling import count


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

    Dispatches to the OpenMP C++ builder (`paths_tpu_torch.native`) when it
    is built and the grid is float32, else to `build_level_table_numpy`;
    both give the same table."""
    out = native.build_level_table_native(grid, min_rows)
    if out is not None:
        return out
    return build_level_table_numpy(grid, min_rows)


def build_level_table_numpy(grid: np.ndarray, min_rows: int = 0) -> dict:
    """`build_level_table` in numpy.

    Background = all-zero feature vector, tested as sum == 0 (for f16
    grids, as "no entry is nonzero", so a live row cannot underflow to a
    zero sum)."""
    h, w, d = grid.shape
    flat = grid.reshape(-1, d)
    if flat.dtype == np.float16:
        # a half is zero when its bits but the sign's are: an integer test,
        # several times faster than numpy's f16 compare
        bits = np.ascontiguousarray(flat).view(np.uint16)
        bg = ~np.any(bits & np.uint16(0x7FFF), axis=1)
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


_warned_mixed_dtypes: set = set()


def host_stack_dtype(dtypes: Sequence[np.dtype]) -> np.dtype:
    """Dtype a batch of host feature arrays stacks at: the widest input
    (whatever the batch order; a resumed preprocess run with a changed
    --store-dtype can mix f16 and f32 grids).

    The mixed-dtype warning fires once per process per dtype pair and names
    the lookup call site (stacklevel=2): the streaming engine calls this at
    every level of every batch. Collation needs no common dtype: each
    slide's rows cross at their own wire dtype."""
    uniq = {np.dtype(d) for d in dtypes}
    if len(uniq) > 1:
        key = tuple(sorted(map(str, uniq)))
        if key not in _warned_mixed_dtypes:
            _warned_mixed_dtypes.add(key)
            warnings.warn(
                f"feature batch mixes storage dtypes "
                f"{sorted(map(str, uniq))}; stacking at the widest. "
                "Re-preprocess with one --store-dtype to reclaim the f16 "
                "wire/RAM savings.", stacklevel=2)
    return max(uniq, key=lambda d: d.itemsize)


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name such as
    "bfloat16" (numpy has no bf16, so a config names it)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and hasattr(torch, dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def wire_dtype(host_dtype, target_dtype) -> torch.dtype:
    """Dtype feature arrays cross the host->device link at: the NARROWER of
    the storage dtype and the table dtype. An f16 store with f32 tables
    ships f16 and widens on the device; an f32 store with bf16 tables
    narrows on the host rather than shipping twice the bytes."""
    host = as_torch_dtype(host_dtype)
    if target_dtype is None:
        return host
    target = as_torch_dtype(target_dtype)
    return target if target.itemsize < host.itemsize else host


def host_rows(rows: np.ndarray, dtype) -> torch.Tensor:
    """A slide's feature rows as a CPU tensor at `dtype`: a view of the
    array where it is writable and at `dtype`, else a copy (a read-only
    memory-mapped grid is copied first; torch casts to bf16, which numpy
    cannot hold, rounding to nearest even)."""
    t = torch.from_numpy(rows if rows.flags.writeable else np.array(rows))
    return t.to(as_torch_dtype(dtype))


def small_host_array(shape, fill, device, dtype=torch.int32) -> torch.Tensor:
    """A host tensor of `fill` to stack a batch's small arrays in (indices,
    a mask), page-locked where the batch is bound for a card: a copy from
    pageable memory waits for all the work queued before it, the feature
    copies included, where one from page-locked memory returns at once."""
    return torch.full(shape, fill, dtype=dtype,
                      pin_memory=torch.device(device).type == "cuda")


def feature_source(rows: np.ndarray, wire: Optional[torch.Tensor], dtype):
    """What a slide's feature rows are copied from into a batch at `dtype`:
    their page-locked copy `wire` (`SlidePyramid.pin`) where there is one at
    `wire_dtype(storage, dtype)`, else the held array."""
    if wire is not None and wire.dtype == wire_dtype(rows.dtype, dtype):
        return wire
    return rows


def fill_rows(dst: torch.Tensor, i: int, src) -> None:
    """dst[i, :len(src)] = src: one slide's feature rows copied straight
    into its row of a batch on dst's device, and cast to dst's dtype there.

    `src` is the slide's array, which crosses at `wire_dtype(its dtype,
    dst's)`, or a CPU tensor of the rows at that dtype (`feature_source`).
    Counts the bytes that cross as `h2d_bytes`, and those copied to a card
    from page-locked memory, which do not wait for the host, also as
    `h2d_pinned_bytes`."""
    if isinstance(src, np.ndarray):
        src = host_rows(src, wire_dtype(src.dtype, dst.dtype))
    n = src.shape[0]
    if n:
        dst[i, :n].copy_(src, non_blocking=True)
    count("h2d_bytes", src.nbytes)
    if dst.is_cuda and src.is_pinned():
        count("h2d_pinned_bytes", src.nbytes)


def ship_at_wire_dtype(lk: dict, table_dtype, put) -> dict:
    """Place a host lookup dict (numpy arrays) on the device with its
    feature array crossing the link at `wire_dtype(storage, table_dtype)`
    and arriving at `table_dtype`. The host-side narrowing and the
    device-side widening are ONE paired dtype decision. `put` maps a dict
    of host tensors to device tensors."""
    want = as_torch_dtype(table_dtype)
    wd = wire_dtype(lk["fts"].dtype, want)
    host = {k: torch.from_numpy(v) for k, v in lk.items() if k != "fts"}
    fts = torch.from_numpy(lk["fts"])
    host["fts"] = fts if fts.dtype == wd else fts.to(wd)
    dev = put(host)
    if dev["fts"].dtype != want:
        dev = {**dev, "fts": dev["fts"].to(want)}
    return dev


def stack_tables(tables: Sequence[dict], min_rows: int = 0,
                 pad_rows_to: Optional[int] = None,
                 pad_grid_to: Optional[tuple] = None,
                 dtype: torch.dtype = torch.float32,
                 device="cuda") -> LevelTable:
    """Pad single-slide tables to common shapes, stack, and place them on
    `device`.

    The features are made zero on the device at `dtype`, and each slide's
    rows are copied into its row there (`fill_rows`): they cross at
    `wire_dtype(storage, dtype)` and are cast to `dtype` on arrival, and
    padding never crosses the link. A table's rows are copied from its
    page-locked "fts_wire" where it has one at the wire dtype
    (`feature_source`). The index arrays are stacked on the host and arrive
    as int64."""
    device = torch.device(device)
    b = len(tables)
    m = max(max(t["fts"].shape[0] for t in tables), min_rows)
    if pad_rows_to is not None:
        m = max(m, pad_rows_to)
    h = max(t["index"].shape[0] for t in tables)
    w = max(t["index"].shape[1] for t in tables)
    if pad_grid_to is not None:
        h, w = max(h, pad_grid_to[0]), max(w, pad_grid_to[1])
    d = tables[0]["fts"].shape[1]

    feats = torch.zeros((b, m, d), dtype=dtype, device=device)
    host = {k: small_host_array(shape, fill, device) for k, shape, fill in (
        ("locs", (b, m, 2), 0), ("count", (b,), 0), ("index", (b, h, w), -1),
        ("grid_hw", (b, 2), 0))}
    arr = {k: v.numpy() for k, v in host.items()}
    for i, t in enumerate(tables):
        mi = t["fts"].shape[0]
        hi, wi = t["index"].shape
        fill_rows(feats, i, feature_source(t["fts"], t.get("fts_wire"), dtype))
        arr["locs"][i, :mi] = t["locs"]
        arr["count"][i] = t["count"]
        arr["index"][i, :hi, :wi] = t["index"]
        arr["grid_hw"][i] = t["grid_hw"]
    count("h2d_bytes", sum(v.nbytes for v in host.values()))
    dev = {k: v.to(device, non_blocking=True).long() for k, v in host.items()}
    return LevelTable(fts=feats, **dev)


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
