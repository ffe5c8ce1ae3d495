"""Weight carry-over between the JAX package's params and the port's modules.

The JAX params flatten (`paths_tpu.train.state._flatten`, the layout of
`model.npz`) to keys such as `procs/0/agg/transformer/decoder/layers/1/
self_attn/q/w`. The port's module tree mirrors that tree, so each key maps
to one state-dict entry: `/` becomes `.`, a Linear's `w` (stored (in, out))
becomes `weight` in `nn.Linear`'s (out, in) layout, `b` becomes `bias`, a
LayerNorm's `scale` becomes `weight` (its `bias` keeps its name). This
module is the one place where weights are transposed. Head counts are not
stored; they come from the config.

The reference's own checkpoint, `model.pt` (`RecursiveModel.state_dict()` of
the original PyTorch PATHS), is read and written through that flat layout:
`reference_to_jax_flat` maps the reference's keys onto the flat JAX keys
(splitting `nn.MultiheadAttention`'s packed in-projection into q, k and v)
and `from_jax_flat` / `load_jax_flat` do the rest; the exporter goes the
other way from `to_jax_flat`. So a Linear weight is transposed by
`to_jax_layout` on the way in and on the way out, and nowhere else.

The patch encoders' ViT parameter tree (`paths_tpu.encoders.vit`) is carried
by `vit_from_jax` / `vit_to_jax`, a tree quantised for the int8 route
(`{"q", "s"}` leaves in place of the block matrices) included.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.encoders.vit import ViT, ViTSpec
from paths_tpu_torch.kernels import vit_int8
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


# segments of a flat JAX key renamed in the reference's key space
_REF_NAME = {"classification": "classification_layer", "agg": "global_agg",
             "cross_attn": "multihead_attn", "out": "out_proj",
             "lin1": "linear1", "lin2": "linear2"}
_REF_LEAF = {"w": "weight", "b": "bias", "scale": "weight"}
_ATTN = ("self_attn", "cross_attn")


def reference_key(jax_key: str):
    """(key of the reference `model.pt`, part) for a flat JAX key. `part` is
    0, 1 or 2 for the q, k or v third of a packed `in_proj_weight` /
    `in_proj_bias`, else None. The reference's MLPs are `nn.Sequential(Linear,
    ReLU, Linear)` (Linear j at index 2j), its LSTM gates `nn.Sequential(
    Linear, activation)` (the Linear at index 0), and its feed-forward Linears
    sit on the layer itself (`linear1`, `linear2`)."""
    *path, leaf = jax_key.split("/")
    out, part = [], None
    i = 0
    while i < len(path):
        seg = path[i]
        if seg == "layers" and path[i - 1] in ("importance_mlp", "hctx_mlp"):
            out.append(str(2 * int(path[i + 1])))
            i += 2
            continue
        if seg in ("q", "k", "v") and path[i - 1] in _ATTN:
            part = "qkv".index(seg)
        elif seg != "ff":
            out.append(_REF_NAME.get(seg, seg))
        i += 1
    if path[0] == "lstm":
        out.append("0")
    if part is not None:
        out.append("in_proj_weight" if leaf == "w" else "in_proj_bias")
    else:
        out.append(_REF_LEAF.get(leaf, leaf))
    return ".".join(out), part


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def reference_to_jax_flat(state_dict, keys) -> Dict[str, np.ndarray]:
    """A reference `model.pt` state dict (tensors or arrays) -> the flat JAX
    params dict over `keys` (the JAX keys of the model to load,
    `jax_keys(model).values()`). A key the model needs and the state dict
    lacks raises KeyError; keys the model does not need are ignored, as in
    the JAX package's loader."""
    flat = {}
    for key in keys:
        ref, part = reference_key(key)
        arr = _numpy(state_dict[ref])
        if part is not None:
            d = arr.shape[0] // 3
            arr = arr[part * d:(part + 1) * d]
        flat[key] = to_jax_layout(key, arr)
    return flat


def jax_flat_to_reference(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of `reference_to_jax_flat`: the reference's state dict
    (numpy arrays, Linear weights (out, in), q / k / v packed into the
    in-projection in that order)."""
    sd, packed = {}, {}
    for key, arr in flat.items():
        ref, part = reference_key(key)
        arr = to_jax_layout(key, arr)     # a transpose undoes itself
        if part is None:
            sd[ref] = arr
        else:
            packed.setdefault(ref, [None] * 3)[part] = arr
    for ref, parts in packed.items():
        sd[ref] = np.concatenate(parts, axis=0)
    return sd


def load_reference_state(model: RecursiveModel, state_dict) -> RecursiveModel:
    """Load a reference state dict into `model` in place and return it."""
    return load_jax_flat(model, reference_to_jax_flat(state_dict,
                                                      jax_keys(model).values()))


def recursive_from_torch(state_dict, config: Config) -> RecursiveModel:
    """A new CPU `RecursiveModel` for `config` holding a reference state
    dict (counterpart of `paths_tpu.convert.recursive_from_torch`)."""
    return load_reference_state(RecursiveModel(config), state_dict)


def load_torch_checkpoint(path: str, model: RecursiveModel) -> RecursiveModel:
    """Load a reference `model.pt` into `model` in place and return it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_reference_state(model, sd)


def recursive_to_torch(model: RecursiveModel) -> Dict[str, np.ndarray]:
    """The model's weights in the reference's key space: what
    `RecursiveModel.state_dict()` holds in the original PyTorch PATHS."""
    return jax_flat_to_reference(to_jax_flat(model))


def save_torch_checkpoint(path: str, model: RecursiveModel) -> None:
    """Write a `model.pt` that the reference loads with strict key
    matching: contiguous float32 CPU tensors, as `torch.save(
    model.state_dict())` writes them there."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in recursive_to_torch(model).items()}, path)


# JAX block key path -> (module attribute of `ViTBlock`, parameter, transposed)
_VIT_BLOCK = {
    ("norm1", "scale"): ("norm1", "weight", False),
    ("norm1", "bias"): ("norm1", "bias", False),
    ("attn", "qkv_w"): ("qkv", "weight", True),
    ("attn", "qkv_b"): ("qkv", "bias", False),
    ("attn", "proj_w"): ("proj", "weight", True),
    ("attn", "proj_b"): ("proj", "bias", False),
    ("norm2", "scale"): ("norm2", "weight", False),
    ("norm2", "bias"): ("norm2", "bias", False),
    ("mlp", "fc1_w"): ("fc1", "weight", True),
    ("mlp", "fc1_b"): ("fc1", "bias", False),
    ("mlp", "fc2_w"): ("fc2", "weight", True),
    ("mlp", "fc2_b"): ("fc2", "bias", False),
}


def _f32(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _slice(node, i: int):
    """Block i of a stacked tree: index every leaf's leading depth axis."""
    if isinstance(node, dict):
        return {k: _slice(v, i) for k, v in node.items()}
    return node[i]


def vit_from_jax(params: dict, spec: ViTSpec) -> ViT:
    """A new CPU `ViT` holding the JAX package's ViT parameter tree: leaves
    convertible to numpy, `blocks` a list of per-block dicts or one dict of
    arrays stacked along a leading depth axis, Linear weights (in, out), the
    patch-embedding conv kernel (P, P, 3, D). A block matrix quantised for
    the int8 route, `{"q": int8 (in, out), "s": f32 (out,)}`, becomes the
    Linear's `weight_q` (out, in) and `weight_s`. `spec` is the port's
    `ViTSpec` of the same architecture (the tree's own `spec` entry is not
    read)."""
    blocks = params["blocks"]
    if isinstance(blocks, dict):      # stacked: slice block i out of each leaf
        blocks = [_slice(blocks, i) for i in range(spec.depth)]
    if len(blocks) != spec.depth:
        raise ValueError(f"{len(blocks)} blocks, spec.depth {spec.depth}")
    p = spec.patch_size
    model = ViT(spec, pos_embed_rows=np.shape(params["pos_embed"])[0])
    with torch.no_grad():
        model.patch_embed.weight.copy_(
            _f32(params["patch_embed"]["w"]).reshape(p * p * 3, -1).T)
        model.patch_embed.bias.copy_(_f32(params["patch_embed"]["b"]))
        model.cls_token.copy_(_f32(params["cls_token"]))
        model.pos_embed.copy_(_f32(params["pos_embed"]))
        if spec.num_reg_tokens:
            model.reg_tokens.copy_(_f32(params["reg_tokens"]))
        model.norm.weight.copy_(_f32(params["norm"]["scale"]))
        model.norm.bias.copy_(_f32(params["norm"]["bias"]))
        for blk, src in zip(model.blocks, blocks):
            for (group, leaf), (attr, name, transposed) in _VIT_BLOCK.items():
                if isinstance(src[group][leaf], dict):     # int8 {"q", "s"}
                    wq = src[group][leaf]
                    q = torch.from_numpy(np.array(wq["q"], dtype=np.int8))
                    vit_int8.set_quantized(getattr(blk, attr),
                                           {"q": q.T, "s": _f32(wq["s"])})
                    continue
                t = _f32(src[group][leaf])
                getattr(getattr(blk, attr), name).copy_(t.T if transposed else t)
            if spec.layer_scale:
                blk.ls1.copy_(_f32(src["ls1"]))
                blk.ls2.copy_(_f32(src["ls2"]))
    return model


def vit_to_jax(model: ViT) -> dict:
    """The inverse of `vit_from_jax`: the JAX package's ViT parameter tree
    (list-of-blocks layout, numpy leaves) without its `spec` entry, which the
    caller adds from the JAX package's own `ViTSpec`. A quantised model gives
    `{"q": int8 (in, out), "s": f32 (out,)}` for its block matrices."""
    spec = model.spec
    p = spec.patch_size
    arr = lambda t: np.ascontiguousarray(t.detach().cpu().numpy())
    params = {
        "patch_embed": {
            "w": arr(model.patch_embed.weight.T).reshape(p, p, 3, -1),
            "b": arr(model.patch_embed.bias)},
        "cls_token": arr(model.cls_token),
        "pos_embed": arr(model.pos_embed),
        "norm": {"scale": arr(model.norm.weight), "bias": arr(model.norm.bias)},
        "blocks": [],
    }
    if spec.num_reg_tokens:
        params["reg_tokens"] = arr(model.reg_tokens)
    for blk in model.blocks:
        out: dict = {}
        for (group, leaf), (attr, name, transposed) in _VIT_BLOCK.items():
            lin = getattr(blk, attr)
            if name == "weight" and lin.weight is None:    # quantised
                out.setdefault(group, {})[leaf] = {"q": arr(lin.weight_q.T),
                                                   "s": arr(lin.weight_s)}
                continue
            t = getattr(lin, name)
            out.setdefault(group, {})[leaf] = arr(t.T if transposed else t)
        if spec.layer_scale:
            out["ls1"], out["ls2"] = arr(blk.ls1), arr(blk.ls2)
        params["blocks"].append(out)
    return params
