"""A timm state dict drawn from the run's seed on the device, in a few
large calls, with `inputs.weights.vit_weights`'s inits and every value on
the bf16 grid: the program loads it through its own converter, the
reference reads it as it is."""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.inputs.weights import generator


def timm_weights(specs: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device` for each (shape, init) of `specs`
    (`reference.virchow2.vit_specs`): "trunc" truncated normal (std 0.02,
    cut at 2 std), "bias" normal 0.02, "scale" 1 + 0.1 z, "layerscale"
    uniform in [0.25, 1]."""
    total = sum(math.prod(s) for s, _ in specs.values())
    normal = torch.randn(total, generator=generator(seed, 5, device),
                         device=device)
    unif = torch.rand(total, generator=generator(seed, 6, device),
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
