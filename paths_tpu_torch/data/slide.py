"""SlidePyramid: one slide's multi-level preprocessed features (counterpart
of `paths_tpu.data.slide`). Level 0 is the full cell bag (background
included); each level > 0 is pre-compacted into a table dict (see
`paths_tpu_torch.engine.tables`)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.engine.tables import (
    as_torch_dtype,
    build_level_table,
    host_rows,
    level0_bag_arrays,
    wire_dtype,
)


def locked_bytes(nbytes: int) -> int:
    """The page-locked bytes torch's caching host allocator takes for a
    tensor of `nbytes`: a block rounded up to a power of two."""
    return 1 << (nbytes - 1).bit_length() if nbytes else 0


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
        self._reset_pins()

    def _reset_pins(self) -> None:
        # collations since the tables were loaded; the level-0 features'
        # page-locked copy (each table's is its "fts_wire"); the page-locked
        # bytes held, as the allocator takes them
        self.collations = 0
        self.level0_wire: Optional[torch.Tensor] = None
        self.pinned_bytes = 0

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

    def pin(self, table_dtype, budget: int) -> int:
        """Page-lock the held features of every level, each at its wire
        dtype for `table_dtype` (`wire_dtype`), where they fit in `budget`
        bytes: the level-0 rows as `level0_wire`, each table's as its
        "fts_wire". A copy from them to a card runs at the link's rate and
        does not wait for the host. They are never written again; where the
        wire dtype is the storage dtype the held array becomes a view of the
        page-locked copy, so the features sit in host RAM once.

        Returns the page-locked bytes (`locked_bytes` of each level); 0,
        leaving the slide pageable, where they would pass `budget` or no
        page-locked memory is to be had. Torch's page-locked allocator keeps
        a block that `unload` drops until the copies that read it have run.
        """
        rows = [self.level0[0]] + [t["fts"] for t in self.tables]
        dtypes = [wire_dtype(r.dtype, table_dtype) for r in rows]
        need = sum(locked_bytes(r.size * dt.itemsize)
                   for r, dt in zip(rows, dtypes))
        if need > budget:
            return 0
        try:
            wire = [torch.empty(r.shape, dtype=dt, pin_memory=True)
                    for r, dt in zip(rows, dtypes)]
        except RuntimeError:          # no page-locked memory to be had
            return 0
        held = []
        for r, w in zip(rows, wire):
            w.copy_(host_rows(r, w.dtype))
            held.append(w.numpy() if as_torch_dtype(r.dtype) == w.dtype else r)
        self._level0 = (held[0],) + tuple(self._level0[1:])
        self.level0_wire = wire[0]
        for t, h, w in zip(self._tables, held[1:], wire[1:]):
            t["fts"], t["fts_wire"] = h, w
        self.pinned_bytes = need
        return need

    def unload(self) -> None:
        self._level0 = None
        self._tables = None
        self._reset_pins()
