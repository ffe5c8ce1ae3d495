"""On-disk store of preprocessed per-level feature grids (counterpart of
`paths_tpu.data.feature_store`).

One array per (slide, magnification) named `{slide_id}_{power:.3f}`, shape
H x W x D, all-zero rows marking background. The native format is `.npy`
(memory-mappable); reference-format `.pt` grids are read with `torch.load`,
and a store created with `save_format="pt"` writes them. A store written by
either package is read by either package.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from paths_tpu_torch.config import power_str


class FeatureStore:
    def __init__(self, root: str, create: bool = False,
                 save_format: str = "npy"):
        if create:
            os.makedirs(root, exist_ok=True)
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"Preprocessing root directory '{root}' not found!")
        if save_format not in ("npy", "pt"):
            raise ValueError(f"save_format {save_format!r}: want npy or pt")
        self.root = root
        self.save_format = save_format

    def _base(self, slide_id: str, power: float) -> str:
        return os.path.join(self.root, f"{slide_id}_{power_str(power)}")

    def path(self, slide_id: str, power: float) -> Optional[str]:
        base = self._base(slide_id, power)
        for ext in (".npy", ".pt"):
            if os.path.isfile(base + ext):
                return base + ext
        return None

    def exists(self, slide_id: str, power: float) -> bool:
        return self.path(slide_id, power) is not None

    def dtype(self, slide_id: str, power: float) -> Optional[np.dtype]:
        """Stored dtype of an existing grid, read from the .npy header (no
        data load). None when absent or `.pt` (reference grids are f32)."""
        p = self.path(slide_id, power)
        if p is None or not p.endswith(".npy"):
            return None
        return np.load(p, mmap_mode="r").dtype

    def save(self, slide_id: str, power: float, grid: np.ndarray) -> str:
        if grid.ndim != 3:
            raise ValueError(f"grid must be H x W x D, got {grid.shape}")
        if grid.dtype not in (np.dtype(np.float32), np.dtype(np.float16)):
            raise ValueError(
                f"store_dtype must be float32 or float16, got {grid.dtype!r}")
        if self.save_format == "pt":
            # reference-consumable grids: a plain float32 tensor (f16 grids
            # are upcast)
            p = self._base(slide_id, power) + ".pt"
            torch.save(torch.from_numpy(
                np.ascontiguousarray(grid, dtype=np.float32)), p)
            return p
        p = self._base(slide_id, power) + ".npy"
        np.save(p, grid)
        return p

    def load(self, slide_id: str, power: float, mmap: bool = True) -> np.ndarray:
        p = self.path(slide_id, power)
        if p is None:
            raise FileNotFoundError(
                f"Pre-process load: '{self._base(slide_id, power)}.npy' not found!")
        if p.endswith(".npy"):
            return np.load(p, mmap_mode="r" if mmap else None)
        return torch.load(p, map_location="cpu", weights_only=True).numpy()
