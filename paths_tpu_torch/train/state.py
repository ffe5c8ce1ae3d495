"""Model checkpoints in the JAX package's `model.npz` layout (counterpart of
the npz route of `paths_tpu.train.state`). A model directory written by
`paths_tpu` loads here unchanged. Optimizer state and the reference `.pt`
route come with the training slice."""
from __future__ import annotations

import os

import numpy as np

from paths_tpu_torch.convert import load_jax_flat, to_jax_flat
from paths_tpu_torch.models.recursive import RecursiveModel


def load_state(root_path: str, model: RecursiveModel) -> RecursiveModel:
    """Load `<root_path>/model.npz` into `model` (in place) and return it."""
    npz_path = os.path.join(root_path, "model.npz")
    if not os.path.isfile(npz_path):
        raise FileNotFoundError(f"{npz_path} not found")
    with np.load(npz_path) as z:
        return load_jax_flat(model, dict(z.items()))


def save_state(root_path: str, model: RecursiveModel) -> None:
    """Write the model's weights to `<root_path>/model.npz`."""
    os.makedirs(root_path, exist_ok=True)
    np.savez(os.path.join(root_path, "model.npz"), **to_jax_flat(model))
