"""Encoder factory (counterpart of `paths_tpu.encoders.registry`): name ->
(encode_fn, dim, transform).

Weights: there is no network access at run time; pass `weights_path` (a torch
state_dict file of a timm ViT or a torchvision resnet) or, for a ViT, get a
randomly initialised encoder of the right architecture (shape tests and
throughput runs; real runs need real weights). The resnets need a weight
file.

    encode, dim, transform = from_name("UNI", weights_path="uni.pt")
    fts = encode(images_bhwc)      # uint8 or [0, 1] float -> (B, dim) float32

"virchow2" is the published Virchow2 (`encoders.vit.VIRCHOW2`): ViT-H/14 at
224 px, width 1280, 32 blocks of 16 heads of 80, LayerScale, 4 register
tokens, timm's packed SwiGLU (fc1 1280 -> 6832 = 2 x 3416, fc2 3416 -> 1280,
held zero-padded to 3456), 2560-d features (cls token and patch-token
mean). Its weights file is timm's state dict as published. On a card its
head_dim 80 runs on "fused" and "fused1" (#4 and #6); "int8" (#8) and
"flash" (#1) take head_dim 64 only and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from paths_tpu_torch.encoders import transforms as T
from paths_tpu_torch.encoders import vit
from paths_tpu_torch.encoders.convert_vit import vit_from_torch_file
from paths_tpu_torch.encoders.resnet import resnet_apply, resnet_from_torchvision
from paths_tpu_torch.encoders.transforms import TransformSpec, apply_transform
from paths_tpu_torch.kernels import vit_int8
from paths_tpu_torch.parallel.mesh import place_replicas

_VIT_SPECS = {
    "uni": (vit.UNI, T.UNI_TRANSFORM),
    "virchow2": (vit.VIRCHOW2, T.VIRCHOW2_TRANSFORM),
    "kaiko-vits16": (vit.KAIKO_VITS16, T.KAIKO_TRANSFORM),
    "kaiko-vits8": (vit.KAIKO_VITS8, T.KAIKO_TRANSFORM),
    "kaiko-vitb16": (vit.KAIKO_VITB16, T.KAIKO_TRANSFORM),
    "kaiko-vitb8": (vit.KAIKO_VITB8, T.KAIKO_TRANSFORM),
    "kaiko-vitl14": (vit.KAIKO_VITL14, T.KAIKO_TRANSFORM),
}


def _to_float01(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [0, 1]."""
    if not images.is_floating_point():
        return images.float() / 255.0
    return images.float()


def _resolve_block_impl(impl: str, device: torch.device) -> str:
    """'auto' -> the fused block kernels on a CUDA device, the plain route
    on an explicitly requested CPU."""
    if impl != "auto":
        return impl
    return "fused" if device.type == "cuda" else "xla"


def from_name(name: str, weights_path: Optional[str] = None,
              compute_dtype: torch.dtype = torch.bfloat16, seed: int = 0,
              fast_math: bool = False, block_impl: str = "auto",
              device: str = "cuda", mesh=None) -> Tuple[Callable, int, TransformSpec]:
    """:return: (encode_fn taking (B, H, W, 3) uint8 or [0, 1] float images
    on `device` -> (B, dim) float32 features, feature dim, transform spec).

    :param fast_math: tanh GELU instead of timm's exact erf GELU.
    :param block_impl: "auto" (the fused block kernels on a CUDA device, the
        plain route on the CPU), "fused", "fused1" (the whole block in one
        launch), "flash", "xla" or "int8" (int8 projections with dynamic
        activation scales; the block matrices are quantised once here, on the
        host, and their float copies dropped). The resnets take no block
        route: their convolutions are the library's.
    :param device: where the weights live and the encode runs; "cuda" unless
        the caller asks for the CPU.
    :param mesh: a data mesh (`parallel.mesh.make_mesh`): the encoder is
        built (and, for "int8", quantised) once on the host, its weights are
        copied to each mesh device, and the first element is a list of
        encode functions, one per mesh device, as `process_slides(mesh=)`
        takes them; `device` is then unused.
    """
    name = name.lower()
    devices = [torch.device(device)] if mesh is None else mesh.devices
    if name in ("resnet50", "resnet18"):
        if not weights_path:
            raise ValueError(
                "resnet encoders require a torchvision state_dict file "
                "(random-init conv nets are not useful even for smoke tests "
                "that care about magnitudes)")
        host = _load_resnet(weights_path, name)

        def bind_resnet(rmodel):
            def encode_resnet(images: torch.Tensor) -> torch.Tensor:
                x = apply_transform(_to_float01(images), T.IDENTITY_TRANSFORM)
                return resnet_apply(rmodel, x, compute_dtype=compute_dtype)
            return encode_resnet

        encoders = [bind_resnet(m) for m in place_replicas(host, devices)]
        return (encoders if mesh is not None else encoders[0], host.out_dim,
                T.IDENTITY_TRANSFORM)
    if name not in _VIT_SPECS:
        raise ValueError(f"Invalid patch encoder '{name}'.")
    spec, tspec = _VIT_SPECS[name]
    impl = _resolve_block_impl(block_impl, devices[0])
    vit.check_block_impl(impl)
    if fast_math:
        spec = dataclasses.replace(spec, gelu="tanh")
    if weights_path:
        model = vit_from_torch_file(weights_path, spec)
    else:
        model = vit.vit_init(seed, spec)
    if impl == "int8":
        vit_int8.quantize_vit_blocks(model)    # once, on the host

    def bind(vmodel):
        def encode(images: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                x = apply_transform(_to_float01(images), tspec)
                return vit.vit_apply(vmodel, x, compute_dtype=compute_dtype,
                                     block_impl=impl)
        return encode

    encoders = [bind(m) for m in place_replicas(model, devices)]
    return encoders if mesh is not None else encoders[0], spec.out_dim, tspec


def _load_resnet(path: str, arch: str):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return resnet_from_torchvision({k: v.numpy() for k, v in sd.items()}, arch)
