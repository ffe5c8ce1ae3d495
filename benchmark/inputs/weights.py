"""Weights drawn from the run's seed on the device, in a few large calls.

Both sides get the same numbers: the program loads them through its own
loaders, the reference reads this dict (or draws it again from the seed).
The ViT's values lie on the bf16 grid, so the program's bf16 copies of them
are exact and the float32 reference starts from the very same weights.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import paths_model, uni


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use of the seed (`stream` tells the
    uses apart)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def vit_weights(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """UNI's weights (timm layout, `reference.uni.vit_specs`), float32 on
    `device`, each value a bf16 number."""
    specs = uni.vit_specs(dims)
    total = sum(math.prod(s) for s, _ in specs.values())
    normal = torch.randn(total, generator=generator(seed, 1, device),
                         device=device)
    unif = torch.rand(total, generator=generator(seed, 2, device),
                      device=device)
    out, at = {}, 0
    for name, (shape, init) in specs.items():
        n = math.prod(shape)
        z, u = normal[at: at + n].view(shape), unif[at: at + n].view(shape)
        at += n
        if init == "trunc":
            v = (z * 0.02).clamp(-0.04, 0.04)
        elif init == "bias":
            v = z * 0.02
        elif init == "scale":
            v = 1.0 + 0.1 * z
        else:   # layerscale
            v = 0.25 + 0.75 * u
        out[name] = v.bfloat16().float()
    return out


def paths_weights(dims: paths_model.Dims, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """The PATHS model's weights (`reference.paths_model.param_specs`),
    float32 on `device`: every Linear uniform in +-1/sqrt(fan_in), special
    tokens standard normal, LayerNorms 1 and 0."""
    specs = paths_model.param_specs(dims)
    total = sum(math.prod(s) for s, _, _ in specs.values())
    unif = torch.rand(total, generator=generator(seed, 3, device),
                      device=device)
    normal = torch.randn(total, generator=generator(seed, 4, device),
                         device=device)
    out, at = {}, 0
    for name, (shape, init, fan_in) in specs.items():
        n = math.prod(shape)
        u, z = unif[at: at + n].view(shape), normal[at: at + n].view(shape)
        at += n
        if init == "uniform":
            bound = 1.0 / math.sqrt(fan_in)
            out[name] = (2.0 * u - 1.0) * bound
        elif init == "normal":
            out[name] = z.clone()
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
