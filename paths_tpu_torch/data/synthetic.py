"""Synthetic slide pyramids and metadata (counterpart of
`paths_tpu.data.synthetic`): the same numpy draws in the same order, so a
seed writes byte-identical stores and CSVs from both packages.

Per-level H x W x D grids whose tissue region is a random blob with
background rows zeroed; each level doubles the grid. The signal store adds
a learnable per-slide risk along one feature direction, and its metadata
derives survival times from that risk.
"""
from __future__ import annotations

import os
import zipfile
from typing import List, Optional, Sequence

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


def signal_direction_z(rng: np.random.Generator, d: int, num_slides: int):
    """The (feature direction, standardized latent risk z) draw shared by
    `make_signal_store` and tests that need the exact z a store run would
    produce (e.g. label-ceiling checks) without building the grids."""
    direction = rng.normal(size=d).astype(np.float32)
    direction /= np.linalg.norm(direction)
    z = rng.normal(size=num_slides).astype(np.float32)
    z = (z - z.mean()) / max(z.std(), 1e-6)
    return direction, z


def make_signal_store(root: str, config: Config, num_slides: int,
                      base_hw=(6, 8), seed: int = 0,
                      tissue_fraction: float = 0.5,
                      signal_strength: float = 1.0,
                      size_jitter: int = 3,
                      store_dtype=np.float32):
    """A synthetic store where each slide carries a LEARNABLE risk
    signal: slide i's latent risk z_i shifts every tissue row of every
    level along one fixed feature direction. Paired with
    `make_signal_metadata`, which derives survival times from z, this
    lets an end-to-end training run show real generalization (val/test
    c-index well above chance) where no TCGA features are at hand.
    Returns (slide_ids, z) with z standardized across slides.

    `size_jitter` sets the cohort's size spread: base grid dims draw
    uniformly from [base, base + size_jitter) per axis, so e.g.
    base_hw=(6, 8), size_jitter=6 spans a ~3x range of patch counts —
    the shape of a real TCGA-BRCA cohort. `store_dtype=np.float16`
    mirrors a `--store-dtype float16` preprocess run (same RNG draws)."""
    store = FeatureStore(root, create=True)
    rng = np.random.default_rng(seed)
    d = config.model_config.patch_embed_dim
    direction, z = signal_direction_z(rng, d, num_slides)
    ids = []
    for i in range(num_slides):
        sid = f"SYN-{i:04d}-01Z-00"
        ids.append(sid)
        h = base_hw[0] + int(rng.integers(0, size_jitter))
        w = base_hw[1] + int(rng.integers(0, size_jitter))
        for lvl, power in enumerate(config.power_levels()):
            grid = synthetic_grid(rng, h * 2**lvl, w * 2**lvl, d,
                                  tissue_fraction)
            tissue = np.abs(grid).sum(-1) > 0
            grid[tissue] += signal_strength * z[i] * direction
            store.save(sid, power, grid.astype(store_dtype, copy=False))
    return ids, z


def make_signal_metadata(csv_path: str, slide_ids: Sequence[str],
                         z: np.ndarray, seed: int = 0,
                         censor_frac: float = 0.3,
                         subtypes: Optional[Sequence[str]] = None,
                         label_noise: float = 0.5) -> None:
    """Metadata whose survival times decrease with the latent risk z
    from `make_signal_store` (plus noise), with risk-independent random
    censoring — so c-index against the features' signal is meaningful.
    With `subtypes` (two class names), the oncotree code is also derived
    from z — thresholded at its median after adding `label_noise`-scaled
    gaussian noise — so a subtype run's AUC measures the same feature
    signal. `label_noise` bounds the achievable AUC: on small val/test
    splits a single noise-flipped label costs ~n_pairs/flip, so
    flagship-scale proofs use a lower value than the 0.5 default."""
    rng = np.random.default_rng(seed + 1)
    noise = 0.25 * rng.normal(size=len(slide_ids))
    months = 1.0 + 119.0 / (1.0 + np.exp(np.asarray(z) + noise))
    censored = rng.uniform(size=len(slide_ids)) < censor_frac
    observed = np.where(censored,
                        months * rng.uniform(0.3, 1.0, len(slide_ids)),
                        months)
    if subtypes is not None:
        if len(subtypes) != 2:
            raise ValueError(f"want two subtype names, got {subtypes}")
        codes = np.where(
            np.asarray(z) + label_noise * rng.normal(size=len(z)) > 0,
            subtypes[1], subtypes[0])
    else:
        codes = ["IDC"] * len(slide_ids)
    rows = ["case_id,slide_id,survival_months,censorship,oncotree_code"]
    for i, sid in enumerate(slide_ids):
        rows.append(f"CASE-{i:04d},{sid}.svs,{observed[i]:.2f},"
                    f"{int(censored[i])},{codes[i]}")
    _write_metadata(csv_path, "\n".join(rows) + "\n")


def make_synthetic_metadata(csv_path: str, slide_ids: Sequence[str],
                            seed: int = 0,
                            subtypes: Optional[Sequence[str]] = None) -> None:
    """Write a reference-format metadata CSV (zip-compressed when the path
    ends in .zip): case_id, slide_id, survival_months, censorship,
    oncotree_code."""
    rng = np.random.default_rng(seed)
    rows = ["case_id,slide_id,survival_months,censorship,oncotree_code"]
    for i, sid in enumerate(slide_ids):
        months = float(rng.uniform(1.0, 120.0))
        censor = int(rng.integers(0, 2))
        code = (subtypes[i % len(subtypes)] if subtypes else "IDC")
        rows.append(f"CASE-{i:04d},{sid}.svs,{months:.2f},{censor},{code}")
    _write_metadata(csv_path, "\n".join(rows) + "\n")


def _write_metadata(csv_path: str, data: str) -> None:
    if csv_path.endswith(".zip"):
        inner = os.path.basename(csv_path)[:-4]
        with zipfile.ZipFile(csv_path, "w") as z:
            z.writestr(inner, data)
    else:
        with open(csv_path, "w") as f:
            f.write(data)
