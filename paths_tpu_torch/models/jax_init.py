"""The JAX package's initial weights, drawn without JAX.

`paths_tpu.models.recursive.recursive_init(jax.random.PRNGKey(seed), config)`
draws every weight from JAX's default generator, Threefry-2x32 in its
partitionable form, along a fixed tree of `jax.random.split` calls.
`recursive_init_flat` walks the same tree with the same generator in numpy,
and `fresh_model` loads it: the port's one definition of a new model at a
seed. A run of the port's `train_loop` at seed s therefore starts from the
weights a JAX run at seed s starts from: uniform draws (every Linear, the
Xavier and torch defaults) bit for bit, the aggregators' normal special
tokens through XLA's f32 erfinv, equal to an ulp or two. Dropout streams
still differ between the packages.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from paths_tpu_torch.config import Config

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words (x1, x2) under `key`
    (two uint32 words), as `jax.random` computes it."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1 = np.asarray(x1, np.uint32) + ks[0]
    x2 = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3]
        x2 = x2 + np.uint32(i + 1)
    return x1, x2


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`'s two words for 0 <= seed < 2**32."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed}: want 0 <= seed < 2**32")
    return np.array([0, seed], np.uint32)


def _counter_bits(key: np.ndarray, n: int):
    return threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) uint32 keys."""
    b1, b2 = _counter_bits(key, num)
    return np.stack([b1, b2], axis=1)


def uniform(key: np.ndarray, shape, lo: float, hi: float) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, lo, hi)`, bit for bit: 23
    random mantissa bits make a float in [0, 1), scaled and shifted with one
    rounding (XLA fuses the multiply-add)."""
    b1, b2 = _counter_bits(key, math.prod(shape))
    bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
    unit = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(lo), np.float32(hi)
    scaled = (unit.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(shape)


# XLA's f32 erfinv (M. Giles' single-precision approximation): the
# polynomial's coefficients for w = -log1p(-x^2) below 5, and at or above
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """erfinv in f32 as XLA evaluates it, the Horner steps fused
    multiply-adds; equal to JAX's to an ulp or two (log1p's rounding)."""
    f32 = np.float32
    w = -np.log1p(-x * x)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(a), f32(b))
        p = (c.astype(np.float64) + p.astype(np.float64) * w).astype(f32)
    return p * x


def normal(key: np.ndarray, shape) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erfinv(u) for u
    uniform in (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(math.sqrt(2)) * _erfinv32(uniform(key, shape, lo, 1.0))


def _linear(key, fan_in: int, fan_out: int, init: str = "torch") -> dict:
    if init == "torch":
        kw, kb = split(key)
        bound = 1.0 / math.sqrt(fan_in)
        return {"w": uniform(kw, (fan_in, fan_out), -bound, bound),
                "b": uniform(kb, (fan_out,), -bound, bound)}
    a = math.sqrt(6.0 / (fan_in + fan_out))   # xavier weight, zero bias
    return {"w": uniform(key, (fan_in, fan_out), -a, a),
            "b": np.zeros(fan_out, np.float32)}


def _mlp(key, dims: List[int]) -> dict:
    keys = split(key, len(dims) - 1)
    return {"layers": [_linear(k, dims[i], dims[i + 1])
                       for i, k in enumerate(keys)]}


def _norm(dim: int) -> dict:
    return {"scale": np.ones(dim, np.float32), "bias": np.zeros(dim, np.float32)}


def _mha(key, dim: int) -> dict:
    return {name: _linear(k, dim, dim, "xavier")
            for name, k in zip(("q", "k", "v", "out"), split(key, 4))}


def _ff(key, dim: int, ff_dim: int) -> dict:
    k1, k2 = split(key)
    return {"lin1": _linear(k1, dim, ff_dim, "xavier"),
            "lin2": _linear(k2, ff_dim, dim, "xavier")}


def _transformer(key, dim: int, layers: int) -> dict:
    keys = split(key, 2 * layers)
    encoder = []
    for k in keys[:layers]:
        ka, kf = split(k)
        encoder.append({"self_attn": _mha(ka, dim), "ff": _ff(kf, dim, 4 * dim),
                        "norm1": _norm(dim), "norm2": _norm(dim)})
    decoder = []
    for k in keys[layers:]:
        ks, kc, kf = split(k, 3)
        decoder.append({"self_attn": _mha(ks, dim), "cross_attn": _mha(kc, dim),
                        "ff": _ff(kf, dim, 4 * dim), "norm1": _norm(dim),
                        "norm2": _norm(dim), "norm3": _norm(dim)})
    return {"encoder": {"layers": encoder, "norm": _norm(dim)},
            "decoder": {"layers": decoder, "norm": _norm(dim)}}


def _processor(key, config: Config, depth: int) -> dict:
    mc = config.model_config
    kc, ki, kh, ka = split(key, 4)
    d = mc.patch_embed_dim
    cls_in = (mc.trans_dim * (depth + 1) if mc.slide_ctx_mode == "concat"
              else mc.trans_dim)
    kp, kt, ks = split(ka, 3)
    params = {
        "classification": _linear(kc, cls_in, config.num_logits()),
        "importance_mlp": _mlp(ki, [d, mc.importance_mlp_hidden_dim, 1]),
        "agg": {"proj_in": _linear(kp, d, mc.trans_dim),
                "transformer": _transformer(kt, mc.trans_dim, mc.trans_layers),
                "special_token": normal(ks, (mc.trans_dim,))},
    }
    if not mc.lstm:
        params["hctx_mlp"] = _mlp(kh, [d, mc.hierarchical_ctx_mlp_hidden_dim, d])
    return params


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for name, value in items:
        key = f"{prefix}{name}"
        if isinstance(value, (dict, list)):
            _flatten(value, key + "/", out)
        else:
            out[key] = value


def recursive_init_flat(config: Config, seed: int) -> Dict[str, np.ndarray]:
    """JAX's `recursive_init(PRNGKey(seed), config)` as the flat params dict
    of the JAX package's `model.npz` (f32)."""
    mc = config.model_config
    keys = split(prng_key(seed), config.num_levels + 1)
    tree = {"procs": [_processor(keys[i], config, i)
                      for i in range(config.num_levels)]}
    if mc.lstm:
        d, hid = mc.patch_embed_dim, mc.hierarchical_ctx_mlp_hidden_dim
        kf, kr, km, ko, kc = split(keys[-1], 5)
        tree["lstm"] = {"forget_gate": _linear(kf, 2 * d, hid),
                        "remember_gate": _linear(kr, 2 * d, hid),
                        "remember_map": _linear(km, 2 * d, hid),
                        "out_select_gate": _linear(ko, 2 * d, d),
                        "mem_to_out": _linear(kc, hid, d)}
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return flat


def fresh_model(config: Config, seed: int):
    """A new CPU `RecursiveModel` for `config` holding JAX's seed-`seed`
    initial weights. The module tree is built on the meta device, so no
    other weights are drawn first."""
    from paths_tpu_torch.convert import load_jax_flat
    from paths_tpu_torch.models.recursive import RecursiveModel

    with torch.device("meta"):
        model = RecursiveModel(config)
    return load_jax_flat(model.to_empty(device="cpu"),
                         recursive_init_flat(config, seed))
