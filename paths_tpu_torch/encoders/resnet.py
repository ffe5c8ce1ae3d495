"""Inference-mode ResNet-18/50 feature extractors (counterpart of
`paths_tpu.encoders.resnet`).

The encoder zoo offers torchvision resnets with the classifier removed as
baseline patch encoders. Encoders are frozen at preprocess time, so
BatchNorm becomes an affine transform folded from the running statistics
(eval semantics): `resnet_from_torchvision` converts a torchvision state
dict, `resnet_apply` runs the forward.

The forward rounds where the JAX package's does: each convolution's output
(accumulated in f32 by the library's convolution) is rounded to the compute
dtype, each folded BatchNorm is computed in f32 and rounded back, ReLU and
the residual sum run in the compute dtype, and the global mean is taken in
f32 and rounded to the compute dtype once. The BatchNorm scale is not folded
into the convolution weights: that would move the bf16 results. The
convolutions are `F.conv2d` (the JAX package runs XLA convolutions here,
outside any Pallas kernel), in channels-last layout, which is the layout the
preprocessing pipeline hands over (NHWC uint8).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

RESNET18_LAYERS = (2, 2, 2, 2)      # BasicBlock
RESNET50_LAYERS = (3, 4, 6, 3)      # Bottleneck
ARCHS = {"resnet18": RESNET18_LAYERS, "resnet50": RESNET50_LAYERS}
BN_EPS = 1e-5


class ConvBN(nn.Module):
    """A bias-free convolution (OIHW weight) and its folded BatchNorm
    (per-channel f32 scale and bias)."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)
        self._cast: dict = {}

    def weight_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight in `dtype` and channels-last layout, cast once."""
        w = self._cast.get(dtype)
        if w is None:
            w = self.weight.to(dtype).contiguous(
                memory_format=torch.channels_last)
            self._cast[dtype] = w
        return w

    def _apply(self, fn, *args, **kwargs):   # .to() / .cuda(): drop the copies
        self._cast = {}
        return super()._apply(fn, *args, **kwargs)


class ResNet(nn.Module):
    """A converted torchvision resnet: `stem`, then `stages[s][b]` blocks,
    each a ModuleDict of ConvBN (`conv1`, `conv2`[, `conv3`][,
    `downsample`])."""

    def __init__(self, arch: str, stem: ConvBN, stages):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"arch {arch!r}: want one of {sorted(ARCHS)}")
        self.arch = arch
        self.stem = stem
        self.stages = nn.ModuleList(nn.ModuleList(nn.ModuleDict(b) for b in s)
                                    for s in stages)
        self.requires_grad_(False)

    @property
    def out_dim(self) -> int:
        return 2048 if self.arch == "resnet50" else 512


def _fold_bn(g, prefix: str) -> tuple:
    """(scale, bias) of BatchNorm `prefix` from its running statistics, in
    f32 numpy, as the JAX package folds them."""
    w, b = g(f"{prefix}.weight"), g(f"{prefix}.bias")
    mean, var = g(f"{prefix}.running_mean"), g(f"{prefix}.running_var")
    scale = w / np.sqrt(var + BN_EPS)
    return scale, b - mean * scale


def resnet_from_torchvision(sd: Mapping[str, np.ndarray],
                            arch: str = "resnet50") -> ResNet:
    """A new CPU `ResNet` from a torchvision state dict of numpy arrays.
    Only the convolution and BatchNorm keys are read: the classifier
    (`fc.*`, which the encoder zoo replaces with Identity) and
    `num_batches_tracked` are dropped."""
    if arch not in ARCHS:
        raise ValueError(f"arch {arch!r}: want one of {sorted(ARCHS)}")
    g = lambda k: np.asarray(sd[k], dtype=np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    def conv_bn(conv_key: str, bn_prefix: str) -> ConvBN:
        scale, bias = _fold_bn(g, bn_prefix)
        return ConvBN(t(g(conv_key)), t(scale), t(bias))

    bottleneck = arch == "resnet50"
    stages = []
    for s, n in enumerate(ARCHS[arch], start=1):
        stage = []
        for b in range(n):
            p = f"layer{s}.{b}"
            ks = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")
            blk = {k: conv_bn(f"{p}.{k}.weight", f"{p}.bn{k[-1]}") for k in ks}
            if f"{p}.downsample.0.weight" in sd:
                blk["downsample"] = conv_bn(f"{p}.downsample.0.weight",
                                            f"{p}.downsample.1")
            stage.append(blk)
        stages.append(stage)
    return ResNet(arch, conv_bn("conv1.weight", "bn1"), stages)


def _conv(x: torch.Tensor, cb: ConvBN, stride: int) -> torch.Tensor:
    """Convolution with torch's symmetric padding (k-1)//2, then the folded
    BatchNorm in f32, rounded back to x's dtype."""
    w = cb.weight_as(x.dtype)
    y = F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)
    return (y.float() * cb.scale[:, None, None]
            + cb.bias[:, None, None]).to(x.dtype)


def _basic_block(x, blk, stride):
    y = torch.relu(_conv(x, blk["conv1"], stride))
    y = _conv(y, blk["conv2"], 1)
    idn = _conv(x, blk["downsample"], stride) if "downsample" in blk else x
    return torch.relu(y + idn)


def _bottleneck_block(x, blk, stride):
    y = torch.relu(_conv(x, blk["conv1"], 1))
    y = torch.relu(_conv(y, blk["conv2"], stride))
    y = _conv(y, blk["conv3"], 1)
    idn = _conv(x, blk["downsample"], stride) if "downsample" in blk else x
    return torch.relu(y + idn)


def resnet_apply(model: ResNet, images: torch.Tensor,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) float images on the model's device -> (B, 512 | 2048)
    float32 globally average-pooled features, without gradients."""
    block = _bottleneck_block if model.arch == "resnet50" else _basic_block
    with torch.no_grad():
        # NHWC -> an NCHW view in channels-last memory: no copy
        x = images.permute(0, 3, 1, 2).to(compute_dtype)
        x = torch.relu(_conv(x, model.stem, 2))
        x = F.max_pool2d(x, 3, 2, 1)          # pads with -inf, as in JAX
        for s, stage in enumerate(model.stages):
            for b, blk in enumerate(stage):
                x = block(x, blk, 2 if (s > 0 and b == 0) else 1)
        return x.float().mean(dim=(2, 3)).to(compute_dtype).float()
