"""Image preprocessing transforms for the encoder zoo (counterpart of
`paths_tpu.encoders.transforms`).

Per-encoder parameters: timm's resize / centre crop / normalise for UNI and
Virchow2, resize(224) with mean/std 0.5 for the Kaiko models, identity for the
resnets. They run as `torch` ops on (B, H, W, 3) float tensors in [0, 1], on
the tensor's device; the resize is two matrix products.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    size: int = 224                 # final square side
    crop_pct: float = 0.875         # resize shorter side to size/crop_pct
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD
    method: str = "bicubic"
    identity: bool = False


UNI_TRANSFORM = TransformSpec(size=224, crop_pct=1.0)
VIRCHOW2_TRANSFORM = TransformSpec(size=224, crop_pct=1.0,
                                   mean=IMAGENET_MEAN, std=IMAGENET_STD)
KAIKO_TRANSFORM = TransformSpec(size=224, crop_pct=1.0,
                                mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                                method="bilinear")
IDENTITY_TRANSFORM = TransformSpec(identity=True)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel, a = -0.5, on x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_out, n_in) float32 linear map of an antialiased resize along one
    axis, equal to the one the JAX package extracts from `jax.image.resize`:
    output i samples the input at (i + 0.5) n_in / n_out - 0.5 through a
    triangle (`bilinear`) or Keys cubic (`bicubic`) kernel that is widened by
    max(n_in / n_out, 1) when shrinking, each row normalised to sum 1."""
    if method not in _KERNELS:
        raise ValueError(f"resize method {method!r}: want one of "
                         f"{tuple(_KERNELS)}")
    inv_scale = np.float32(n_in) / np.float32(n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5))
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float32)[None, :])
    w = _KERNELS[method]((x / kernel_scale).astype(np.float32)).astype(np.float32)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0).astype(np.float32)


def matmul_resize(images: torch.Tensor, nh: int, nw: int,
                  method: str) -> torch.Tensor:
    """(B, H, W, C) -> (B, nh, nw, C) as two matrix products with the
    matrices of `_resize_matrix`."""
    _, h, w, _ = images.shape
    out = images
    if nh != h:
        mh = torch.from_numpy(_resize_matrix(h, nh, method)).to(
            device=images.device, dtype=images.dtype)
        out = torch.einsum("oh,bhwc->bowc", mh, out)
    if nw != w:
        mw = torch.from_numpy(_resize_matrix(w, nw, method)).to(
            device=images.device, dtype=images.dtype)
        out = torch.einsum("pw,bhwc->bhpc", mw, out)
    return out


def apply_transform(images: torch.Tensor, spec: TransformSpec) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> (B, size, size, 3) normalised."""
    if spec.identity:
        return images
    _, h, w, _ = images.shape
    resize_to = int(round(spec.size / spec.crop_pct))
    # resize the shorter side to resize_to, preserving aspect
    if h <= w:
        nh, nw = resize_to, max(int(round(w * resize_to / h)), resize_to)
    else:
        nw, nh = resize_to, max(int(round(h * resize_to / w)), resize_to)
    if (nh, nw) != (h, w):
        images = matmul_resize(images, nh, nw, spec.method)
    y0 = (images.shape[1] - spec.size) // 2
    x0 = (images.shape[2] - spec.size) // 2
    images = images[:, y0:y0 + spec.size, x0:x0 + spec.size]
    mean = torch.tensor(spec.mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(spec.std, dtype=images.dtype, device=images.device)
    return (images - mean) / std
