"""Weight carry-over between the JAX package's params and the port's modules.

The JAX params flatten (`paths_tpu.train.state._flatten`, the layout of
`model.npz`) to keys such as `procs/0/agg/transformer/decoder/layers/1/
self_attn/q/w`. The port's module tree mirrors that tree, so each key maps
to one state-dict entry: `/` becomes `.`, a Linear's `w` (stored (in, out))
becomes `weight` in `nn.Linear`'s (out, in) layout, `b` becomes `bias`, a
LayerNorm's `scale` becomes `weight` (its `bias` keeps its name). This
module is the one place where weights are transposed. Head counts are not
stored; they come from the config.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.models.recursive import RecursiveModel

_LEAF = {"w": "weight", "b": "bias", "scale": "weight"}


def _torch_key(jax_key: str) -> str:
    *path, leaf = jax_key.split("/")
    return ".".join(path + [_LEAF.get(leaf, leaf)])


def load_jax_flat(model: torch.nn.Module,
                  flat: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Load a flat JAX params dict into `model` (the `RecursiveModel`, or
    any of its submodules with the matching part of the dict) in place and
    return it. Every key must match: a missing or extra parameter raises."""
    state = {}
    for key, arr in flat.items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        state[_torch_key(key)] = t.T if key.endswith("/w") else t
    model.load_state_dict(state, strict=True)
    return model


def from_jax_flat(flat: Dict[str, np.ndarray], config: Config) -> RecursiveModel:
    """A new CPU `RecursiveModel` for `config` holding the JAX params."""
    return load_jax_flat(RecursiveModel(config), flat)


def jax_keys(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter's name in `model` -> its key in the JAX package's flat
    params dict (a key ending in `/w` is a Linear weight, stored (in, out)
    on the JAX side)."""
    # a LayerNorm's weight and bias are `scale` and `bias` on the JAX side
    norms = {name for name, m in model.named_modules()
             if isinstance(m, torch.nn.LayerNorm)}
    keys = {}
    for name, _ in model.named_parameters():
        *path, leaf = name.split(".")
        if ".".join(path) in norms:
            leaf = {"weight": "scale"}.get(leaf, leaf)
        else:
            leaf = {"weight": "w", "bias": "b"}.get(leaf, leaf)
        keys[name] = "/".join(path + [leaf])
    return keys


def to_jax_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """A parameter-shaped array (a weight, or its optimizer moments) in the
    JAX layout of flat key `key`."""
    return np.ascontiguousarray(arr.T if key.endswith("/w") else arr)


def to_jax_flat(model: RecursiveModel) -> Dict[str, np.ndarray]:
    """The inverse of `from_jax_flat`: the model's weights as the JAX
    package's flat params dict."""
    keys = jax_keys(model)
    return {keys[name]: to_jax_layout(keys[name], p.detach().cpu().numpy())
            for name, p in model.named_parameters()}
