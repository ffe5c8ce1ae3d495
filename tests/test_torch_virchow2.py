"""The published Virchow2 in the port, on the CPU: its spec, and a small
spec of its shape (head_dim 80, 4 register tokens, 261 tokens, timm's packed
SwiGLU with fc1 twice fc2's width and the branch zero-padded for kernel #6,
LayerScale, the class token joined with the patch-token mean) held to the
plain reference `benchmark/reference/virchow2.py` on seeded random weights
in timm's layout, loaded through the port's converter.

Port and reference both compute in f32 from the same f32 weights and differ
only in summation order (and the port's zero padding, which adds exact
zeros): 1e-4 absolute on features of O(1), as the encoder parity tests hold
a whole forward.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import glu_vit
from benchmark.reference import uni as ref_uni
from benchmark.reference import virchow2 as ref
from paths_tpu_torch.encoders import convert_vit
from paths_tpu_torch.encoders import registry
from paths_tpu_torch.encoders import vit

ATOL = 1e-4
# two blocks of width 160, 2 heads of 80, branch 40 (fc1 80 rows) held as 128
SMALL = vit.ViTSpec(img_size=224, patch_size=14, embed_dim=160, depth=2,
                    num_heads=2, mlp_ratio=0.5, layer_scale=True, swiglu=True,
                    glu_width=40, num_reg_tokens=4, pool="token+mean")


def _dims(spec: vit.ViTSpec) -> dict:
    return dict(img_size=spec.img_size, patch_size=spec.patch_size,
                embed_dim=spec.embed_dim, depth=spec.depth,
                num_heads=spec.num_heads, glu_width=spec.glu_width,
                reg_tokens=spec.num_reg_tokens)


def _timm_state(spec: vit.ViTSpec, seed: int) -> dict:
    """A timm-layout state dict of the spec: every tensor random, of the
    size trained weights have (matrices about 1 / sqrt(fan-in), norms and
    LayerScale near 1), so that no term hides behind a zero or a 1e-5."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init) in ref.vit_specs(_dims(spec)).items():
        if init == "trunc":
            fan_in = math.prod(shape[1:]) if len(shape) > 1 and shape[0] > 1 \
                else 1
            v = rng.normal(size=shape) * (fan_in ** -0.5 if fan_in > 1 else 0.5)
        elif init == "bias":
            v = 0.1 * rng.normal(size=shape)
        else:                       # LayerNorm scale, LayerScale
            v = 1.0 + 0.1 * rng.normal(size=shape)
        out[name] = v.astype(np.float32)
    return out


def _images(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 224, 224, 3)).astype(np.float32))


def _reference(sd: dict, spec: vit.ViTSpec, x: torch.Tensor) -> torch.Tensor:
    w = {k: torch.from_numpy(v) for k, v in sd.items()}
    with torch.no_grad():
        return ref.vit_forward(w, dict(_dims(spec), num_heads=spec.num_heads), x)


def test_published_spec():
    """`from_name("virchow2")`'s spec is the published model's: 16 heads of
    80, LayerScale, fc1 6832 = 2 x 3416 and fc2 3416 in timm's layout,
    held as 2 x 3456, 261 tokens, 2560 out; 631.2 M parameters published,
    636.2 M held."""
    spec, tspec = registry._VIT_SPECS["virchow2"]
    assert spec is vit.VIRCHOW2
    assert (spec.embed_dim, spec.depth, spec.num_heads, spec.head_dim) == \
        (1280, 32, 16, 80)
    assert spec.layer_scale and spec.swiglu and spec.pool == "token+mean"
    assert (spec.mlp_hidden, spec.mlp_hidden_padded) == (3416, 3456)
    assert 2 * spec.mlp_hidden == 6832 == round(spec.embed_dim * spec.mlp_ratio)
    assert spec.num_patches + 1 + spec.num_reg_tokens == 261
    assert spec.out_dim == 2560 and tspec.size == 224
    dims = dict(_dims(spec), mlp_ratio=spec.mlp_ratio)
    published = ref.vit_specs(dims)
    assert published["blocks.0.mlp.fc1.weight"][0] == (6832, 1280)
    assert published["blocks.0.mlp.fc2.weight"][0] == (1280, 3416)
    assert published["pos_embed"][0] == (1, 261, 1280)
    n_published = sum(math.prod(s) for s, _ in published.values())
    with torch.device("meta"):
        model = vit.ViT(spec)
    assert tuple(model.blocks[0].fc1.weight.shape) == (6912, 1280)
    assert tuple(model.blocks[0].fc2.weight.shape) == (1280, 3456)
    n_held = sum(p.numel() for p in model.parameters())
    assert n_published == 631_239_424
    assert n_held - n_published == 32 * (2 * 40 * 1281 + 1280 * 40)
    # operations a patch, as the benchmark counts them: 340 GFLOP
    assert abs(glu_vit.flops_per_image(dims) / 1e9 - 340.1) < 0.1


@pytest.mark.parametrize("bad", [dict(glu_width=3000),
                                 dict(swiglu=False, glu_width=3416)])
def test_glu_width_must_be_half_of_fc1(bad):
    with pytest.raises(ValueError, match="glu_width"):
        dataclasses.replace(vit.VIRCHOW2, **bad)


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_small_virchow2_matches_reference(route):
    """The plain route and the fused route's plain versions at head_dim 80
    against the reference, from a timm state dict through the converter."""
    sd = _timm_state(SMALL, seed=1)
    model = convert_vit.vit_from_timm(sd, SMALL)
    x = _images(3, seed=2)
    got = vit.vit_apply(model, x, torch.float32, route)
    want = _reference(sd, SMALL, x)
    assert got.shape == want.shape == (3, 320)
    d = SMALL.embed_dim
    # O(1) in both halves: the bar has teeth on each
    assert want[:, :d].abs().max() > 0.5 and want[:, d:].abs().max() > 0.05
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_padding_is_zero_and_exact():
    """The converter pads each branch with zeros, and `vit_init` of a
    `glu_width` spec draws none there; the padded rows change nothing."""
    sd = _timm_state(SMALL, seed=3)
    model = convert_vit.vit_from_timm(sd, SMALL)
    h, hp = SMALL.mlp_hidden, SMALL.mlp_hidden_padded
    for m in (model, vit.vit_init(0, SMALL)):
        blk = m.blocks[1]
        assert not blk.fc1.weight[h:hp].any() and not blk.fc1.weight[hp + h:].any()
        assert not blk.fc1.bias[h:hp].any() and not blk.fc2.weight[:, h:].any()
    blk, raw = model.blocks[0], sd["blocks.0.mlp.fc1.weight"]
    np.testing.assert_array_equal(blk.fc1.weight[:h].numpy(), raw[:h])
    np.testing.assert_array_equal(blk.fc1.weight[hp: hp + h].numpy(), raw[h:])


def test_timm_file_converts_and_runs(tmp_path):
    """A state dict in timm's Virchow2 layout (fc1 (2h, d), fc2 (d, h),
    `reg_token`, a 261-row `pos_embed`, `ls{1,2}.gamma`) saved with torch
    loads through `vit_from_torch_file` and `from_name`, and encodes uint8
    patches as the reference does after Virchow2's transform."""
    sd = _timm_state(SMALL, seed=4)
    path = str(tmp_path / "virchow2.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    assert vit.VIRCHOW2.num_reg_tokens == sd["reg_token"].shape[1]
    model = convert_vit.vit_from_torch_file(path, SMALL)
    assert model.pos_embed.shape == (261, 160)
    np.testing.assert_array_equal(model.blocks[1].ls2.numpy(),
                                  sd["blocks.1.ls2.gamma"])
    px = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, 256, 256, 3), np.uint8))
    x = ref_uni.transform(px, 224).float()
    torch.testing.assert_close(vit.vit_apply(model, x, torch.float32, "xla"),
                               _reference(sd, SMALL, x), atol=ATOL, rtol=0)
    specs = dict(registry._VIT_SPECS, virchow2=(SMALL, registry.T.VIRCHOW2_TRANSFORM))
    real = registry._VIT_SPECS
    registry._VIT_SPECS = specs
    try:
        encode, dim, _ = registry.from_name("virchow2", weights_path=path,
                                            compute_dtype=torch.float32,
                                            device="cpu", block_impl="fused")
    finally:
        registry._VIT_SPECS = real
    assert dim == 320
    # the port's transform against the reference's (both antialiased
    # bicubic, ImageNet mean and std) adds its f32 rounding
    torch.testing.assert_close(encode(px), _reference(sd, SMALL, x),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad", ["fc2", "layerscale"])
def test_converter_refuses_the_wrong_layout(bad):
    """fc2 at the packed width (what the converter made of Virchow2 before
    the published spec), or LayerScale for a spec without it, raise."""
    sd = _timm_state(SMALL, seed=6)
    spec = SMALL
    if bad == "fc2":
        sd["blocks.0.mlp.fc2.weight"] = np.zeros((160, 80), np.float32)
    else:
        spec = dataclasses.replace(SMALL, layer_scale=False)
    with pytest.raises(ValueError):
        convert_vit.vit_from_timm(sd, spec)
