"""On-disk store of preprocessed per-level feature grids (counterpart of
`paths_tpu.data.feature_store`).

One array per (slide, magnification) named `{slide_id}_{power:.3f}`, shape
H x W x D, all-zero rows marking background. `.npy` files are memory-mapped;
reference-format `.pt` grids are read with `torch.load`.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from paths_tpu_torch.config import power_str


class FeatureStore:
    def __init__(self, root: str, create: bool = False):
        if create:
            os.makedirs(root, exist_ok=True)
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"Preprocessing root directory '{root}' not found!")
        self.root = root

    def _base(self, slide_id: str, power: float) -> str:
        return os.path.join(self.root, f"{slide_id}_{power_str(power)}")

    def path(self, slide_id: str, power: float) -> Optional[str]:
        base = self._base(slide_id, power)
        for ext in (".npy", ".pt"):
            if os.path.isfile(base + ext):
                return base + ext
        return None

    def save(self, slide_id: str, power: float, grid: np.ndarray) -> str:
        if grid.ndim != 3:
            raise ValueError(f"grid must be H x W x D, got {grid.shape}")
        p = self._base(slide_id, power) + ".npy"
        np.save(p, grid)
        return p

    def load(self, slide_id: str, power: float) -> np.ndarray:
        p = self.path(slide_id, power)
        if p is None:
            raise FileNotFoundError(
                f"Pre-process load: '{self._base(slide_id, power)}.npy' not found!")
        if p.endswith(".npy"):
            return np.load(p, mmap_mode="r")
        return torch.load(p, map_location="cpu", weights_only=True).numpy()
