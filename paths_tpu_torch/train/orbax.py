"""Orbax checkpoints without JAX: the `<model dir>/orbax` directory that the
JAX package writes under `checkpoint_backend: "orbax"`
(`paths_tpu.train.state`), read and written with numpy.

    read_orbax(directory) -> (params_flat, opt_flat or None)
    write_orbax(directory, params_flat, opt_flat=None)

Both sides speak the JAX package's flat npz key space: params as
`procs/0/classification/w`, the optax state as `.count`,
`.hyperparams/learning_rate`, `.inner_state/0/.mu/<param key>` (AdamW alone)
or `.inner_state/1/0/.mu/<param key>` (behind a gradient-norm clip).

A checkpoint is `_METADATA` (JSON; `tree_metadata` maps each leaf's key path,
written as a tuple string such as "('params', 'procs', '0', ...)", to its
key types and value type) beside the arrays. An array is zarr v2
(`train/zarr.py`) named by its key path joined with dots. Orbax's default
(`use_ocdbt: true`, what JAX writes) keeps the arrays in an OCDBT store
(`train/ocdbt.py`), zstd-compressed, so reading it needs the host's libzstd.

The writer's format: `use_ocdbt: false`, one directory per array with one
uncompressed chunk, plus `_sharding` (each array on JAX's CPU device,
`_DEVICE_STR`) and `_CHECKPOINT_METADATA`. orbax-checkpoint 0.11 restores
that layout, so JAX's `load_state` reads the port's checkpoints, and writing
needs no libzstd. Its `tree_metadata` is the tree JAX saves, empty optax
states included (`hyperparams_states`, an empty dict; the stateless links of
the chain, None) and the head counts that JAX keeps in each attention's
params (`num_heads`, a leaf without arrays, None to Orbax), because Orbax
restores only into a template of the saved tree.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import time
from typing import Dict, Optional, Tuple

from paths_tpu_torch.train import ocdbt, zarr

# key types of `tree_metadata`: a sequence index, or a dict key / field
_SEQUENCE, _KEY = 1, 2
_ARRAY_TYPES = ("jax.Array", "np.ndarray")
# the empty states of the optax chains that `paths_tpu.train.loop.
# make_optimizer` builds, by whether the step clips: adamw is
# chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate), and the
# clip is a link of its own in front of it
_EMPTY_STATES = {
    False: (("inner_state", "1"), ("inner_state", "2")),
    True: (("inner_state", "0"), ("inner_state", "1", "1"),
           ("inner_state", "1", "2")),
}
_CLIP_PREFIX = ".inner_state/1/0/"
# the device every array's `_sharding` entry names; JAX's `load_state`
# restores into its own template's sharding, so no other device is needed
_DEVICE_STR = "TFRT_CPU_0"


def _opt_key(path) -> str:
    """An `opt_state` leaf's key path (after 'opt_state') as its flat npz
    key: a namedtuple field is spelt with a leading dot there. The fields
    are the injected state's (first) and, after the chain's indices,
    AdamW's; the rest is a params key or a hyperparameter name."""
    key = ["." + path[0]]
    rest = list(path[1:])
    if path[0] == "inner_state":
        i = 0
        while i < len(rest) and rest[i].isdigit():
            i += 1
        if i < len(rest):
            rest[i] = "." + rest[i]
    return "/".join(key + rest)


def _head_counts(keys) -> list:
    """Key paths of the `num_heads` leaf of every attention block among
    `keys` (the JAX package's `mha_init` puts one beside q, k, v and out)."""
    keys = set(keys)
    return [k[:-len("q/w")] + "num_heads" for k in keys
            if k.endswith("/q/w") and all(
                k[:-len("q/w")] + f"{n}/w" in keys for n in ("k", "v", "out"))]


def _opt_path(key: str) -> Tuple[str, ...]:
    return tuple(p[1:] if p.startswith(".") else p for p in key.split("/"))


def read_orbax(directory: str) -> Tuple[Dict, Optional[Dict]]:
    """(params_flat, opt_flat) of the Orbax checkpoint in `directory`;
    opt_flat is None where the checkpoint holds no `opt_state`. Arrays are
    numpy, except that bfloat16 leaves are torch tensors."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{directory}: zarr v3 checkpoints are not supported")
    if meta.get("use_ocdbt", True):
        store = ocdbt.read_store(directory)

        def get(key):
            return store.get(key.encode())
    else:
        def get(key):
            path = os.path.join(directory, key)
            if not os.path.isfile(path):
                return None
            with open(path, "rb") as f:
                return f.read()

    params, opt, has_opt = {}, {}, False
    for entry in meta["tree_metadata"].values():
        path = tuple(str(k["key"]) for k in entry["key_metadata"])
        value = entry["value_metadata"]
        has_opt |= path[0] == "opt_state"
        if value["value_type"] not in _ARRAY_TYPES:
            if not value.get("skip_deserialize"):
                raise ValueError(f"{path}: leaf type {value['value_type']!r} "
                                 "is not supported")
            continue
        arr = zarr.read_array(get, ".".join(path))
        if path[0] == "params":
            params["/".join(path[1:])] = arr
        elif path[0] == "opt_state":
            opt[_opt_key(path[1:])] = arr
        else:
            raise ValueError(f"{path}: not a params or opt_state leaf")
    return params, (opt if has_opt else None)


def _entry(path, value_metadata: dict) -> dict:
    return {"key_metadata": [{"key": p, "key_type": _SEQUENCE if p.isdigit()
                              else _KEY} for p in path],
            "value_metadata": value_metadata}


def _sort_key(path):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in path)


def write_orbax(directory: str, params_flat: Dict,
                opt_flat: Optional[Dict] = None) -> None:
    """Write `params_flat` (and `opt_flat`, an AdamW state in the layout of
    `train.state.optimizer_to_jax_flat`) as an Orbax checkpoint at
    `directory`, replacing what is there. Arrays are numpy or, for
    bfloat16, CPU torch tensors."""
    arrays = {("params",) + tuple(k.split("/")): v
              for k, v in params_flat.items()}
    none = {"value_type": "None", "skip_deserialize": True}
    empty = [(("params",) + tuple(k.split("/")), none)
             for k in _head_counts(params_flat)]
    if opt_flat is not None:
        arrays.update({("opt_state",) + _opt_path(k): v
                       for k, v in opt_flat.items()})
        clip = any(k.startswith(_CLIP_PREFIX) for k in opt_flat)
        empty.append((("opt_state", "hyperparams_states"),
                      {"value_type": "Dict", "skip_deserialize": True}))
        empty += [(("opt_state",) + p, none) for p in _EMPTY_STATES[clip]]
        empty += [(("opt_state",) + _opt_path(k), none)
                  for k in _head_counts(opt_flat)]

    tmp = directory.rstrip(os.sep) + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree, sharding = {}, {}
    leaves = [(p, None) for p in arrays] + empty
    for path, value_metadata in sorted(leaves, key=lambda e: _sort_key(e[0])):
        if value_metadata is None:
            arr = arrays[path]
            name = ".".join(path)
            zarr.write_array(tmp, name, arr)
            value_metadata = {"value_type": "jax.Array",
                              "skip_deserialize": False,
                              "write_shape": list(arr.shape)}
            sharding[base64.urlsafe_b64encode(name.encode()).decode()] = (
                json.dumps({"sharding_type": "SingleDeviceSharding",
                            "device_str": _DEVICE_STR}))
        tree[str(path)] = _entry(path, value_metadata)
    meta = {"tree_metadata": tree, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    now = time.time_ns()
    files = {
        "_METADATA": meta,
        "_sharding": sharding,
        "_CHECKPOINT_METADATA": {
            "item_handlers": "orbax.checkpoint._src.handlers."
                             "standard_checkpoint_handler."
                             "StandardCheckpointHandler",
            "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
            "custom_metadata": {}},
    }
    for name, obj in files.items():
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(obj, f)
    shutil.rmtree(directory, ignore_errors=True)
    os.replace(tmp, directory)
