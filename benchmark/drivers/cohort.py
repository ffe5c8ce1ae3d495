"""What the PATHS cells' drivers share: the cohort store, the labels drawn
from the seed, the port's configuration and model, and the reference's
view of the cohort (each slide's grids on the device)."""
from __future__ import annotations

import copy
import os
from typing import Dict, List

import numpy as np
import torch

from benchmark.inputs import cohort as cohort_inputs
from benchmark.inputs.weights import paths_weights
from benchmark.reference import paths_model


def cohort_spec(run) -> dict:
    model = run.config["model"]
    return dict(run.traffic["cohort"],
                dim=model["model_config"]["patch_embed_dim"],
                levels=model["num_levels"], base_power=model["base_power"])


def program_config(run, store_root: str):
    """The port's `Config` of the configuration file's model, reading the
    cohort's store."""
    from paths_tpu_torch.config import Config

    model = copy.deepcopy(run.config["model"])
    model["preprocess_dir"] = store_root
    return Config(**model)


def labels(seed: int, n: int, nbins: int) -> Dict[str, np.ndarray]:
    """Survival bin, months and censorship per slide, from the seed."""
    rng = np.random.default_rng([int(seed), 0x1AB])
    return {"survival_bin": rng.integers(0, nbins, n).astype(np.int32),
            "survival": rng.uniform(1.0, 120.0, n).astype(np.float32),
            "censored": rng.integers(0, 2, n).astype(np.int32)}


def flat_numpy(weights: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in weights.items()}


def program_model(config, weights: Dict[str, torch.Tensor], device):
    """The port's model holding the weights, on `device`."""
    from paths_tpu_torch.convert import load_jax_flat
    from paths_tpu_torch.models.recursive import RecursiveModel

    return load_jax_flat(RecursiveModel(config), flat_numpy(weights)).to(device)


def reference_weights(run, dims, dtype) -> Dict[str, torch.Tensor]:
    """The same weights, drawn again from the seed, in `dtype`, as leaves
    that take gradients."""
    w = paths_weights(dims, run.seed, run.device)
    return {k: v.to(dtype).requires_grad_(True) for k, v in w.items()}


class RefCohort:
    """Each slide's grids as the reference reads them from the store's raw
    files: features in `dtype` and non-background masks, on the device."""

    def __init__(self, root: str, spec: dict, device, dtype):
        self.root, self.spec, self.device, self.dtype = root, spec, device, dtype
        self._cache: Dict[str, tuple] = {}

    def slide(self, sid: str):
        if sid not in self._cache:
            grids = [torch.from_numpy(g.astype(np.float32)).to(self.device)
                     for g in cohort_inputs.load_grids(self.root, sid, self.spec)]
            self._cache[sid] = ([g.to(self.dtype) for g in grids],
                                [(g != 0).any(-1) for g in grids])
        return self._cache[sid]

    def descend(self, p, dims, sid: str) -> List[paths_model.Result]:
        grids, nonbg = self.slide(sid)
        return paths_model.descend(p, dims, grids, nonbg)


def model_dir(run, config, weights) -> str:
    """A model directory for `ServingSession`: the configuration and the
    weights in the flat npz layout."""
    path = os.path.join(run.tmp, "model")
    config.save(path)
    np.savez(os.path.join(path, "model.npz"), **flat_numpy(weights))
    return path
