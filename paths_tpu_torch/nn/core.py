"""Layer building blocks (counterpart of `paths_tpu.nn.core`).

Weights live in `nn.Linear`'s (out, in) layout. The JAX package stores
(in, out); the transpose is made once, in `paths_tpu_torch.convert`.

Initialisation mirrors torch defaults (uniform in ±1/sqrt(fan_in) for
weight and bias) and, for transformer blocks, Xavier-uniform weights with
zero biases, drawn from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def make_linear(in_features: int, out_features: int, *, init: str = "torch",
                generator: Optional[torch.Generator] = None) -> nn.Linear:
    """An `nn.Linear` initialised from `generator` ("torch": uniform
    ±1/sqrt(fan_in) weight and bias; "xavier": Xavier-uniform weight, zero
    bias)."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        if init == "torch":
            bound = 1.0 / math.sqrt(in_features)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
        elif init == "xavier":
            a = math.sqrt(6.0 / (in_features + out_features))
            lin.weight.uniform_(-a, a, generator=generator)
            lin.bias.zero_()
        else:
            raise ValueError(init)
    return lin


def linear_apply(lin: nn.Linear, x: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`x @ W^T + b`, with all three cast to `compute_dtype` when given."""
    w, b = lin.weight, lin.bias
    if compute_dtype is not None:
        x, w, b = x.to(compute_dtype), w.to(compute_dtype), b.to(compute_dtype)
    return F.linear(x, w, b)


class MLP(nn.Module):
    """Stack of Linear layers with ReLU between them (`mlp_apply`)."""

    def __init__(self, dims: Sequence[int], *, init: str = "torch",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            make_linear(dims[i], dims[i + 1], init=init, generator=generator)
            for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = linear_apply(layer, x, compute_dtype)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return x


class LayerNorm(nn.LayerNorm):
    """LayerNorm with eps 1e-5, normalising in f32 whatever the input type."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)
