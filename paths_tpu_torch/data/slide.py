"""SlidePyramid: one slide's multi-level preprocessed features (counterpart
of `paths_tpu.data.slide`). Level 0 is the full cell bag (background
included); each level > 0 is pre-compacted into a table dict (see
`paths_tpu_torch.engine.tables`)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.engine.tables import build_level_table, level0_bag_arrays


class SlidePyramid:
    def __init__(self, slide_id: str, store: FeatureStore, base_power: float,
                 num_levels: int, patch_size: int,
                 level_min_rows: Optional[List[int]] = None,
                 magnification_factor: int = 2):
        """:param level_min_rows: minimum table rows per level; rows up to
        this bound include background cells so the all-background fallback
        can address them. Tables are built on first access."""
        self.slide_id = slide_id
        self.store = store
        self.base_power = base_power
        self.num_levels = num_levels
        self.patch_size = patch_size
        self.magnification_factor = magnification_factor
        self.level_min_rows = level_min_rows or [0] * num_levels
        self._level0 = None
        self._tables: Optional[List[dict]] = None

    def powers(self) -> List[float]:
        return [self.base_power * self.magnification_factor**i
                for i in range(self.num_levels)]

    def materialize(self) -> None:
        if self._tables is not None:
            return
        powers = self.powers()
        tables = []
        for lvl in range(1, self.num_levels):
            # asarray keeps the memory map: the builders only gather rows
            grid = np.asarray(self.store.load(self.slide_id, powers[lvl]))
            # a table never needs more fallback rows than the grid has cells
            min_rows = min(self.level_min_rows[lvl],
                           grid.shape[0] * grid.shape[1])
            tables.append(build_level_table(grid, min_rows=min_rows))
        self._tables = tables

    @property
    def level0(self):
        """(fts (N0, D), locs_pixels (N0, 2), n0)."""
        if self._level0 is None:
            grid0 = np.asarray(self.store.load(self.slide_id, self.powers()[0]))
            self._level0 = level0_bag_arrays(grid0, self.patch_size)
        return self._level0

    @property
    def tables(self) -> List[dict]:
        """Level tables for levels 1..num_levels-1."""
        self.materialize()
        return self._tables

    def unload(self) -> None:
        self._level0 = None
        self._tables = None
