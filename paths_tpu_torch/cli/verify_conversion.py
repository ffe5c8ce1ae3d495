"""Certify a dropped-in torch encoder checkpoint before preprocessing a
cohort (counterpart of `paths_tpu.cli.verify_conversion`): convert it, and
prove forward parity against the torch oracle.

A user with a real UNI / Virchow2 / Kaiko / resnet state_dict runs

    python -m paths_tpu_torch.cli.verify_conversion --model UNI --weights uni.pt

and gets (1) a strict state_dict load into a torch mirror with timm /
torchvision key layout (`encoders.torch_mirror`): any key or shape mismatch
fails loudly; and (2) the max-abs / max-rel error between the mirror's
forward and the port's converted encoder on N random images, checked against
a tolerance. Both sides consume identical pre-transformed tensors, so the
number isolates weight-conversion error and the converted encoder's route.

The side under test runs on `--device` (the card unless the caller asks for
the CPU) through `--block-impl` (as `encoders.registry.from_name`; `auto` is
the fused block kernels on a card), in f32 with TF32 off, as does the mirror.
Covers every timm pos-embed layout (inferred from the checkpoint's
`pos_embed` row count) and the Virchow2 SwiGLU hidden padding
(`encoders.convert_vit._convert_mlp`).
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from paths_tpu_torch.encoders import vit
from paths_tpu_torch.encoders.convert_vit import vit_from_timm
from paths_tpu_torch.encoders.registry import _VIT_SPECS, _resolve_block_impl
from paths_tpu_torch.encoders.resnet import resnet_apply, resnet_from_torchvision
from paths_tpu_torch.encoders.torch_mirror import (
    TorchResNet18,
    TorchResNet50,
    timm_vit_mirror,
)
from paths_tpu_torch.kernels import vit_int8


def _vit_pos_layout(sd, spec) -> str:
    rows = sd["pos_embed"].shape[1]
    n = spec.num_patches
    if rows == n:
        return "patch"
    if rows == n + 1:
        return "cls"
    if rows == n + 1 + spec.num_reg_tokens:
        return "all"
    raise ValueError(
        f"pos_embed has {rows} rows; expected {n} (no_embed_class), "
        f"{n + 1} (cls+patches) or {n + 1 + spec.num_reg_tokens} "
        f"(all tokens) for {spec}")


@contextlib.contextmanager
def _full_f32():
    """f32 products without TF32 passes on a card, restored afterwards so
    callers chaining other stages keep their own settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _load_strict(mirror, sd_t, name, ignore=()) -> None:
    missing, unexpected = mirror.load_state_dict(sd_t, strict=False)
    missing = [k for k in missing if not any(s in k for s in ignore)]
    if missing or unexpected:
        raise ValueError(
            f"state_dict does not match the {name} architecture: "
            f"missing={sorted(missing)} unexpected={sorted(unexpected)}")


def verify_vit(name: str, sd: dict, images: np.ndarray,
               compute_dtype="float32", spec=None, block_impl: str = "auto",
               device: str = "cuda") -> dict:
    """Returns {"max_abs", "max_rel", "pos_layout", "out_torch",
    "out_port"}; raises on key/shape mismatch. `spec` overrides the
    registry lookup (tests exercise custom layouts on small specs)."""
    dev = torch.device(device)
    if spec is None:
        spec, _ = _VIT_SPECS[name]
    layout = _vit_pos_layout(sd, spec)
    impl = _resolve_block_impl(block_impl, dev)
    vit.check_block_impl(impl)

    mirror = timm_vit_mirror(spec, pos_layout=layout).eval()
    _load_strict(mirror, {k: torch.as_tensor(np.asarray(v))
                          for k, v in sd.items()}, name)
    model = vit_from_timm({k: np.asarray(v) for k, v in sd.items()}, spec)
    if impl == "int8":
        vit_int8.quantize_vit_blocks(model)
    x = torch.as_tensor(images)
    with _full_f32(), torch.no_grad():
        mirror = mirror.to(dev)
        out_t = mirror(x.permute(0, 3, 1, 2).to(dev)).cpu().numpy()
        del mirror
        out_p = vit.vit_apply(model.to(dev), x.to(dev),
                              compute_dtype=getattr(torch, compute_dtype),
                              block_impl=impl).cpu().numpy()
    return _errors(out_t, out_p) | {"pos_layout": layout}


def verify_resnet(name: str, sd: dict, images: np.ndarray,
                  compute_dtype="float32", device: str = "cuda") -> dict:
    dev = torch.device(device)
    mirror = (TorchResNet50() if name == "resnet50" else TorchResNet18()).eval()
    # torchvision checkpoints carry fc.* (the encoder zoo replaces fc with
    # Identity) and num_batches_tracked
    _load_strict(mirror, {k: torch.as_tensor(np.asarray(v))
                          for k, v in sd.items() if not k.startswith("fc.")},
                 name, ignore=("num_batches_tracked",))
    model = resnet_from_torchvision({k: np.asarray(v) for k, v in sd.items()},
                                    name)
    x = torch.as_tensor(images)
    with _full_f32(), torch.no_grad():
        out_t = mirror.to(dev)(x.permute(0, 3, 1, 2).to(dev)).cpu().numpy()
        out_p = resnet_apply(model.to(dev), x.to(dev),
                             compute_dtype=getattr(torch, compute_dtype)
                             ).cpu().numpy()
    return _errors(out_t, out_p)


def _errors(out_t: np.ndarray, out_p: np.ndarray) -> dict:
    abs_err = np.abs(out_p - out_t)
    denom = np.maximum(np.abs(out_t), 1e-6)
    return {"max_abs": float(abs_err.max()),
            "max_rel": float((abs_err / denom).max()),
            "out_torch": out_t, "out_port": out_p}


def run(model: str, weights: str, n_images: int = 4, seed: int = 0,
        tol: float = 1e-3, compute_dtype: str = "float32",
        block_impl: str = "auto", device: str = "cuda") -> dict:
    """Load, convert, compare; returns the error dict (CLI-independent so
    tests drive it directly)."""
    name = model.lower()
    sd = torch.load(weights, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}

    rng = np.random.default_rng(seed)
    if name in _VIT_SPECS:
        spec, _ = _VIT_SPECS[name]
        images = rng.uniform(-1.5, 1.5, (n_images, spec.img_size,
                                         spec.img_size, 3)).astype(np.float32)
        res = verify_vit(name, sd, images, compute_dtype,
                         block_impl=block_impl, device=device)
    elif name in ("resnet50", "resnet18"):
        images = rng.uniform(-1.5, 1.5, (n_images, 224, 224, 3)).astype(
            np.float32)
        res = verify_resnet(name, sd, images, compute_dtype, device=device)
    else:
        raise ValueError(f"Unknown encoder '{model}'")
    res["ok"] = res["max_abs"] <= tol
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", required=True,
                        help="UNI / Virchow2 / kaiko-vits16 / ... / resnet50")
    parser.add_argument("--weights", required=True,
                        help="torch state_dict file (timm ViT or "
                             "torchvision resnet layout)")
    parser.add_argument("--images", type=int, default=4,
                        help="number of random probe images")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tol", type=float, default=1e-3,
                        help="max-abs forward error to certify (f32)")
    parser.add_argument("--block-impl", type=str, default="auto",
                        choices=("auto",) + vit.BLOCK_IMPLS,
                        help="route of the converted ViT's blocks, as "
                             "encoders.registry.from_name: auto = the fused "
                             "CUDA block kernels on a card, plain torch on "
                             "the CPU")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where both forwards run (cuda, or cpu on "
                             "request)")
    args = parser.parse_args(argv)

    res = run(args.model, args.weights, n_images=args.images, seed=args.seed,
              tol=args.tol, block_impl=args.block_impl, device=args.device)
    layout = res.get("pos_layout", "-")
    print(f"{args.model}: pos_layout={layout} "
          f"max_abs_err={res['max_abs']:.3e} max_rel_err={res['max_rel']:.3e} "
          f"over {args.images} images -> "
          f"{'OK' if res['ok'] else f'FAIL (tol {args.tol})'}")
    if not res["ok"]:
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
