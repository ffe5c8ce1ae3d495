"""Synthetic slide pyramids (counterpart of `make_synthetic_store` in
`paths_tpu.data.synthetic`): the same numpy draws in the same order, so a
seed writes byte-identical stores from both packages.

Per-level H x W x D grids whose tissue region is a random blob with
background rows zeroed; each level doubles the grid.
"""
from __future__ import annotations

from typing import List

import numpy as np

from paths_tpu_torch.config import Config
from paths_tpu_torch.data.feature_store import FeatureStore


def synthetic_grid(rng: np.random.Generator, h: int, w: int, d: int,
                   tissue_fraction: float = 0.5) -> np.ndarray:
    """Random feature grid with a contiguous-ish tissue blob."""
    g = rng.normal(size=(h, w, d)).astype(np.float32) * 0.5 + 0.2
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    r2 = ((yy - cy) / h) ** 2 + ((xx - cx) / w) ** 2
    cutoff = np.quantile(r2, tissue_fraction)
    g[r2 > cutoff] = 0.0
    return g


def make_synthetic_store(root: str, config: Config, num_slides: int,
                         base_hw=(6, 8), seed: int = 0,
                         tissue_fraction: float = 0.5,
                         store_dtype=np.float32) -> List[str]:
    """Populate a FeatureStore with `num_slides` synthetic pyramids and
    return the slide ids."""
    store = FeatureStore(root, create=True)
    rng = np.random.default_rng(seed)
    d = config.model_config.patch_embed_dim
    ids = []
    for i in range(num_slides):
        sid = f"SYN-{i:04d}-01Z-00"
        ids.append(sid)
        h, w = base_hw
        h += int(rng.integers(0, 3))
        w += int(rng.integers(0, 3))
        for lvl, power in enumerate(config.power_levels()):
            grid = synthetic_grid(rng, h * 2**lvl, w * 2**lvl, d,
                                  tissue_fraction)
            store.save(sid, power, grid.astype(store_dtype, copy=False))
    return ids
