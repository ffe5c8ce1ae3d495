"""Slides -> device-ready batches (counterpart of the serving part of
`paths_tpu.data.dataset`).

Only what serving needs is here: a label-free `SlideDataset`, its
`global_pads`, `collate_batch` and `collate_bag0`. Padded widths and buckets
are the JAX package's, so both packages collate a batch to the same shapes.
Labels, splits and metadata CSVs come with the training slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.data.slide import SlidePyramid
from paths_tpu_torch.engine.tables import bag_widths, stack_dtype, stack_tables
from paths_tpu_torch.models.batch import PatchBag


def _round_up(n: int, m: int) -> int:
    return m * ((n + m - 1) // m)


class SlideDataset:
    """The slides of a feature store, by id, without labels.

    :param cache_slides: keep materialized tables after a batch is
        collated (trade host RAM for repeat-request latency)."""

    def __init__(self, slide_ids: Sequence[str], config: Config,
                 store: FeatureStore, cache_slides: bool = True):
        self.config = config
        self.slide_ids = list(slide_ids)
        self.cache_slides = cache_slides
        mc = config.model_config
        # table row bounds for levels >= 1 do not depend on n0 when K != -1
        widths = bag_widths(config.top_k_patches, config.num_levels, 10**9)
        self.level_min_rows = [0] + widths[1:]
        self.slides = [SlidePyramid(
            sid, store, config.base_power, config.num_levels, mc.patch_size,
            level_min_rows=self.level_min_rows,
            magnification_factor=config.magnification_factor)
            for sid in self.slide_ids]
        self._global_pads: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.slides)

    def global_pads(self) -> dict:
        """Dataset-wide shape maxima: level-0 bag width, per-level table rows
        and grid dims. Collating every batch to these gives every batch of a
        width one shape."""
        if self._global_pads is not None:
            return self._global_pads
        n0 = 0
        rows = [0] * self.config.num_levels
        grid_hw = [(0, 0)] * self.config.num_levels
        for s in self.slides:
            n0 = max(n0, s.level0[2])
            for lvl, t in enumerate(s.tables, start=1):
                rows[lvl] = max(rows[lvl], t["fts"].shape[0])
                grid_hw[lvl] = (max(grid_hw[lvl][0], t["index"].shape[0]),
                                max(grid_hw[lvl][1], t["index"].shape[1]))
            if not self.cache_slides:
                s.unload()
        self._global_pads = {"n0": n0, "rows": rows, "grid_hw": grid_hw}
        return self._global_pads


def collate_batch(dataset: SlideDataset, indices: Sequence[int],
                  level0_bucket: int = 256, row_bucket: int = 256,
                  grid_bucket: int = 16, dtype: Optional[torch.dtype] = None,
                  pads: Optional[dict] = None, device="cuda"):
    """Collate slides into (PatchBag, [LevelTable]) on `device`.

    The level-0 width is the batch max rounded up to `level0_bucket`; table
    rows and grid dims round to `row_bucket` / `grid_bucket`. `pads` (a
    `global_pads()` dict) replaces batch maxima with dataset-wide maxima."""
    cfg = dataset.config
    if dtype is None:
        dtype = getattr(torch, cfg.table_dtype)
    slides = [dataset.slides[i] for i in indices]

    bag0 = collate_bag0(dataset, indices, level0_bucket=level0_bucket,
                        dtype=dtype, pads=pads, device=device)
    n0 = bag0.mask.shape[1]

    widths = bag_widths(cfg.top_k_patches, cfg.num_levels, n0)
    tables = []
    for lvl in range(1, cfg.num_levels):
        per = [s.tables[lvl - 1] for s in slides]
        max_rows = max(t["fts"].shape[0] for t in per)
        max_h = max(t["index"].shape[0] for t in per)
        max_w = max(t["index"].shape[1] for t in per)
        if pads is not None:
            max_rows = max(max_rows, pads["rows"][lvl])
            max_h = max(max_h, pads["grid_hw"][lvl][0])
            max_w = max(max_w, pads["grid_hw"][lvl][1])
        rows = _round_up(max(widths[lvl], max_rows), row_bucket)
        h = _round_up(max_h, grid_bucket)
        w = _round_up(max_w, grid_bucket)
        tables.append(stack_tables(per, min_rows=widths[lvl],
                                   pad_rows_to=rows, pad_grid_to=(h, w),
                                   dtype=dtype, device=device))

    if not dataset.cache_slides:
        for s in slides:
            s.unload()
    return bag0, tables


def collate_bag0(dataset: SlideDataset, indices: Sequence[int],
                 level0_bucket: int = 256, dtype: Optional[torch.dtype] = None,
                 pads: Optional[dict] = None, device="cuda") -> PatchBag:
    """Collate only the level-0 bag, on `device`."""
    cfg = dataset.config
    mc = cfg.model_config
    if dtype is None:
        dtype = getattr(torch, cfg.table_dtype)
    l0 = [dataset.slides[i].level0 for i in indices]
    b = len(l0)
    ds_dim, dp_dim = mc.ctx_dim()

    max_n0 = max(x[2] for x in l0)
    if pads is not None:
        max_n0 = max(max_n0, pads["n0"])
    n0 = _round_up(max_n0, level0_bucket)
    fts0 = np.zeros((b, n0, mc.patch_embed_dim),
                    stack_dtype([f.dtype for f, _, _ in l0]))
    locs0 = np.zeros((b, n0, 2), np.int32)
    mask0 = np.zeros((b, n0), bool)
    for i, (f, l, n) in enumerate(l0):
        fts0[i, :n] = f
        locs0[i, :n] = l
        mask0[i, :n] = True

    return PatchBag(
        fts=torch.from_numpy(fts0).to(device).to(dtype),
        locs=torch.from_numpy(locs0).to(device).long(),
        mask=torch.from_numpy(mask0).to(device),
        parent_inds=torch.arange(n0, device=device).expand(b, n0),
        ctx_slide=torch.zeros((b, 0, ds_dim), dtype=dtype, device=device),
        ctx_patch=torch.zeros((b, n0, 0, dp_dim), dtype=dtype, device=device))
