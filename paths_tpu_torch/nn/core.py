"""Layer building blocks (counterpart of `paths_tpu.nn.core`).

Weights live in `nn.Linear`'s (out, in) layout. The JAX package stores
(in, out); the transpose is made once, in `paths_tpu_torch.convert`.

Initialisation mirrors torch defaults (uniform in ±1/sqrt(fan_in) for
weight and bias) and, for transformer blocks, Xavier-uniform weights with
zero biases, drawn from an explicit `torch.Generator`. Dropout draws its
masks from an explicit generator too.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def wide(x: torch.Tensor) -> torch.Tensor:
    """x in the type the plain paths sum in: f32 for f32 and narrower types
    (XLA's `preferred_element_type=f32`), f64 for f64 (so a model run in f64
    on the CPU is f64 throughout, the yardstick of an f32 rounding gap)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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


def affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`x @ w^T + b` with the JAX package's rounding points (`x @ w + b`):
    in f32 one `F.linear`; in a narrower dtype the product is rounded to
    that dtype before the bias is added, where `F.linear` adds the bias
    before its one rounding (in bf16 an ulp apart on about a quarter of the
    outputs)."""
    if x.dtype == torch.float32:
        return F.linear(x, w, b)
    return F.linear(x, w) + b


def linear_apply(lin: nn.Linear, x: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`x @ W^T + b` (`affine`), with all three cast to `compute_dtype`
    when given."""
    w, b = lin.weight, lin.bias
    if compute_dtype is not None:
        x, w, b = x.to(compute_dtype), w.to(compute_dtype), b.to(compute_dtype)
    return affine(x, w, b)


class _Logistic(torch.autograd.Function):
    """JAX's logistic in a narrow dtype: y = 1 / (1 + exp(-x)), XLA's
    expansion, and JAX's gradient g * (y * (1 - y)), each op rounded to the
    dtype."""

    @staticmethod
    def value(x):
        return torch.reciprocal(torch.exp(-x) + 1)

    @staticmethod
    def forward(ctx, x):
        y = _Logistic.value(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


class _Tanh(torch.autograd.Function):
    """JAX's tanh in a narrow dtype: the gradient as JAX's reverse mode
    transposes its rule (g + g y)(1 - y): e = g (1 - y), then e + e y, each
    op rounded to the dtype (torch's rounds once)."""

    value = staticmethod(torch.tanh)

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        e = g * (1 - y)
        return e + e * y


def _narrow(fn, x: torch.Tensor) -> torch.Tensor:
    """`fn` as an autograd Function where a gradient is wanted, else its
    value alone (plain operations, which `torch.export` traces)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return fn.apply(x)
    return fn.value(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as the JAX package's programs compute it: in f32
    `torch.sigmoid`; in a narrower dtype 1 / (1 + exp(-x)) with each op
    rounded to that dtype, XLA's expansion of the logistic (torch's bf16
    sigmoid rounds once and differs from it on about 30% of inputs, which
    moves importance ties and so the top-K), with JAX's gradient rule."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return _narrow(_Logistic, x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """`jnp.tanh`: torch's in f32; in a narrower dtype with JAX's gradient
    rule and its rounding points."""
    if x.dtype == torch.float32:
        return torch.tanh(x)
    return _narrow(_Tanh, x)


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
    """LayerNorm with eps 1e-5, normalising in f32 (f64 for f64 inputs)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(wide(x), self.normalized_shape, wide(self.weight),
                         wide(self.bias), self.eps)
        return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None,
            training: bool = False, shard=None) -> torch.Tensor:
    """Inverted dropout (`paths_tpu.nn.core.dropout`): in training with
    rate > 0, keep each element with probability 1 - rate and scale the
    survivors by 1 / (1 - rate); otherwise return `x`. The mask comes from
    `generator`, which lives on x's device (`F.dropout` takes none).

    `shard` = (index, size) says that x is block `index` of `size` equal
    blocks of a sequence-parallel group's tensor: `size` masks of x's shape
    are drawn in turn and block `index`'s is kept, so the ranks of the group
    draw as much from their generators, their masks make one mask of the
    whole tensor, and no rank holds more than its own block's."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = 1.0 - rate
    index, size = shard if shard is not None else (0, 1)
    for i in range(size):
        draw = torch.rand(x.shape, generator=generator, device=x.device)
        if i == index:
            mask = draw < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
