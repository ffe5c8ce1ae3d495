"""Checkpoints in the JAX package's npz and Orbax layouts, and the
reference's `model.pt` / `train_stats.pkl` (counterpart of
`paths_tpu.train.state`).

A model directory holds `model.npz` (the flat JAX params dict),
`opt.npz` (the optimizer state) and `train_stats.json` (the epoch to resume
from plus per-epoch metric histories); under `backend="orbax"` the params and
the optimizer state go to an Orbax checkpoint `orbax/` instead
(`train/orbax.py`). The optimizer state uses the keys of the JAX
package's optax state, `inject_hyperparams(adamw)` or, with a gradient-norm
clip (`config.clip_grad_norm`, passed as `clip_grad_norm`),
`inject_hyperparams(chain(clip_by_global_norm, adamw))`: the step count,
the hyperparameters, and AdamW's first and second moments (`mu`, `nu`) per
parameter key. So a model directory resumes in either package.

Reading follows the JAX package's order: `orbax/`, `model.npz`, else a
reference `model.pt` (the original PyTorch PATHS's `state_dict()`, mapped by
`paths_tpu_torch.convert`). Where both `orbax/` and `model.npz` are there,
the config's `checkpoint_backend` ("npz" or "orbax") decides, else the newer
of the two. The optimizer state comes from the Orbax tree when the weights
did and it holds one, else from `opt.npz`. Then `train_stats.json`, else a
reference `train_stats.pkl` (its integer epoch keys stay integers), else a
fresh `{"epoch": 1}`. Reading a JAX-written Orbax checkpoint needs the
host's libzstd (`paths_tpu_torch.native.zstd`).
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from paths_tpu_torch.convert import (
    jax_keys,
    load_jax_flat,
    load_torch_checkpoint,
    to_jax_flat,
    to_jax_layout,
)
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.train.orbax import read_orbax, write_orbax

# where optax keeps AdamW's count and moments inside the injected state
_ADAM_PREFIX = {False: ".inner_state/0/", True: ".inner_state/1/0/"}


def _newest(path: str) -> float:
    """The newest mtime of a file, or of any file under a directory."""
    if not os.path.isdir(path):
        return os.path.getmtime(path)
    return max((os.path.getmtime(os.path.join(r, f))
                for r, _, fs in os.walk(path) for f in fs),
               default=os.path.getmtime(path))


def _weights_file(root_path: str, checkpoint_backend: Optional[str]):
    """`orbax/`, `model.npz` or `model.pt`, in that order, or None. When
    both `orbax/` and `model.npz` are there, `checkpoint_backend` decides,
    else the newer (JAX's rule)."""
    orbax_dir = os.path.join(root_path, "orbax")
    npz_path = os.path.join(root_path, "model.npz")
    use_orbax = os.path.isdir(orbax_dir)
    if use_orbax and os.path.isfile(npz_path):
        if checkpoint_backend in ("npz", "orbax"):
            use_orbax = checkpoint_backend == "orbax"
        else:
            use_orbax = _newest(orbax_dir) >= _newest(npz_path)
        print(f"Both orbax/ and model.npz present in {root_path}; loading "
              f"{'orbax' if use_orbax else 'npz'}")
    if use_orbax:
        return orbax_dir
    for path in (npz_path, os.path.join(root_path, "model.pt")):
        if os.path.isfile(path):
            return path
    return None


def _f32(flat: dict) -> dict:
    """numpy f32 arrays from an Orbax tree's leaves (bfloat16 ones are
    torch tensors; the upcast is exact)."""
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in flat.items()}


def _read_weights(path: str, model: RecursiveModel):
    """Load the weights at `path` into `model`; returns the optimizer's
    flat state where the checkpoint holds one (Orbax), else None."""
    if os.path.isdir(path):
        params, opt = read_orbax(path)
        load_jax_flat(model, _f32(params))
        return None if opt is None else _f32(opt)
    if path.endswith(".pt"):
        print(f"Loading reference torch checkpoint {path}")
        load_torch_checkpoint(path, model)
        return None
    with np.load(path) as z:
        load_jax_flat(model, dict(z.items()))
    return None


def load_model(root_path: str, model: RecursiveModel,
               checkpoint_backend: Optional[str] = None) -> RecursiveModel:
    """Load `<root_path>/orbax`, `model.npz` or the reference `model.pt`
    into `model` (in place) and return it; raise if none is there.
    `checkpoint_backend` is the config's (see the module docstring)."""
    path = _weights_file(root_path, checkpoint_backend)
    if path is None:
        raise FileNotFoundError(
            f"none of orbax/, model.npz and model.pt in {root_path}")
    _read_weights(path, model)
    return model


def optimizer_to_jax_flat(model: RecursiveModel,
                          optimizer: torch.optim.Optimizer,
                          clip_grad_norm: Optional[float] = None) -> dict:
    """The AdamW state of `optimizer` (over `model`'s parameters) as the
    flat optax state dict of the JAX package, whose layout depends on
    whether the step clips (`clip_grad_norm`)."""
    group = optimizer.param_groups[0]
    prefix = _ADAM_PREFIX[bool(clip_grad_norm)]
    keys = jax_keys(model)
    f32 = np.float32
    flat = {}
    step = 0
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        if "step" in state:
            step = int(state["step"])
        for moment, torch_name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            arr = (state[torch_name].detach().cpu().numpy() if state
                   else np.zeros(tuple(p.shape), f32))
            key = f"{prefix}.{moment}/{keys[name]}"
            flat[key] = to_jax_layout(keys[name], arr)
    flat[".count"] = flat[f"{prefix}.count"] = np.asarray(step, np.int32)
    hyper = {"learning_rate": group["lr"],
             "weight_decay": group["weight_decay"]}
    if clip_grad_norm:
        hyper["max_norm"] = clip_grad_norm
    else:
        b1, b2 = group["betas"]
        hyper.update(b1=b1, b2=b2, eps=group["eps"], eps_root=0.0)
    for k, v in hyper.items():
        flat[f".hyperparams/{k}"] = np.asarray(v, f32)
    return flat


def load_optimizer_jax_flat(model: RecursiveModel,
                            optimizer: torch.optim.Optimizer, flat: dict,
                            clip_grad_norm: Optional[float] = None
                            ) -> torch.optim.Optimizer:
    """Load a flat optax AdamW state (see `optimizer_to_jax_flat`) into
    `optimizer` in place: moments, step count and learning rate. Every
    parameter's moments must be present with its shape."""
    prefix = _ADAM_PREFIX[bool(clip_grad_norm)]
    keys = jax_keys(model)
    step = int(flat[f"{prefix}.count"])
    for name, p in model.named_parameters():
        state = {"step": torch.tensor(float(step), dtype=torch.float32)}
        for moment, torch_name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            key = f"{prefix}.{moment}/{keys[name]}"
            if key not in flat:
                raise KeyError(f"optimizer checkpoint missing key {key}")
            arr = np.asarray(flat[key], np.float32)
            arr = arr.T if keys[name].endswith("/w") else arr
            if arr.shape != tuple(p.shape):
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{arr.shape} vs model {tuple(p.shape)}")
            state[torch_name] = torch.from_numpy(
                np.ascontiguousarray(arr)).to(p)
        optimizer.state[p] = state
    for group in optimizer.param_groups:
        group["lr"] = float(flat[".hyperparams/learning_rate"])
    return optimizer


def save_state(root_path: str, model: RecursiveModel,
               optimizer: Optional[torch.optim.Optimizer] = None,
               train_stats: Optional[dict] = None, *,
               clip_grad_norm: Optional[float] = None,
               backend: str = "npz") -> None:
    """Write `model.npz` and `opt.npz` (with an optimizer; its layout
    follows `clip_grad_norm`), or under `backend="orbax"` both into the
    Orbax checkpoint `orbax/`, and `train_stats.json` (with stats) into
    `root_path`."""
    print(f"Saving to {root_path}...")
    os.makedirs(root_path, exist_ok=True)
    opt = (None if optimizer is None
           else optimizer_to_jax_flat(model, optimizer, clip_grad_norm))
    if backend == "orbax":
        write_orbax(os.path.join(root_path, "orbax"), to_jax_flat(model), opt)
    else:
        np.savez(os.path.join(root_path, "model.npz"), **to_jax_flat(model))
        if opt is not None:
            np.savez(os.path.join(root_path, "opt.npz"), **opt)
    if train_stats is not None:
        with open(os.path.join(root_path, "train_stats.json"), "w") as f:
            json.dump(train_stats, f)


def load_state(root_path: str, model: RecursiveModel,
               optimizer: Optional[torch.optim.Optimizer] = None, *,
               clip_grad_norm: Optional[float] = None,
               checkpoint_backend: Optional[str] = None) -> Tuple:
    """Restore (model, optimizer, train_stats) from `root_path`, in place;
    the optimizer state is read in the layout that `clip_grad_norm` gives
    it. Missing files leave the passed-in values untouched; a fresh directory
    gives train_stats {"epoch": 1}. Integer epoch keys of the metric
    histories survive the JSON round trip. The weights and stats files are
    chosen as the module docstring says."""
    path = _weights_file(root_path, checkpoint_backend)
    opt = None
    if path is not None:
        opt = _read_weights(path, model)
    else:
        print(f"{os.path.join(root_path, 'model.npz')} not found, not loading "
              "model state!")
    opt_path = os.path.join(root_path, "opt.npz")
    from_orbax = path is not None and os.path.isdir(path)
    if optimizer is not None and not from_orbax and os.path.isfile(opt_path):
        with np.load(opt_path) as z:
            opt = dict(z.items())
    if optimizer is not None and opt is not None:
        load_optimizer_jax_flat(model, optimizer, opt, clip_grad_norm)

    stats_path = os.path.join(root_path, "train_stats.json")
    pkl_path = os.path.join(root_path, "train_stats.pkl")
    if os.path.isfile(stats_path):
        with open(stats_path) as f:
            train_stats = json.load(f)
        for k, v in train_stats.items():
            if isinstance(v, dict):
                train_stats[k] = {int(e): x for e, x in v.items()}
    elif os.path.isfile(pkl_path):
        # the reference pickles its stats dict (unpickling runs code: a model
        # directory is trusted input, as in the reference); resuming
        # continues from its epoch, and the next save writes
        # train_stats.json, read first from then on
        with open(pkl_path, "rb") as f:
            train_stats = pickle.load(f)
        print(f"Loaded reference train stats {pkl_path} "
              f"(epoch {train_stats.get('epoch')})")
    else:
        print("No train stats found, assuming first run")
        train_stats = {"epoch": 1}
    return model, optimizer, train_stats
