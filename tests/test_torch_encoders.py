"""The port's patch encoders against the JAX package on the CPU: resize
matrices, transforms, `vit_init`, `vit_apply` on the xla, fused and flash
routes (`fused1` and `int8` have their own files), the weight converters
and the registry. Inputs and weights come from numpy with a seed
and go through both packages; f32 compute, so tolerances are tight (1e-4 on
O(1) features for a whole forward, 1e-6 for the resize weights).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers_encoders import TimmViT
from paths_tpu.encoders import convert_vit as jconvert
from paths_tpu.encoders import transforms as jtransforms
from paths_tpu.encoders import vit as jvit
from paths_tpu.kernels import vit_fused as jvf
from paths_tpu_torch import convert
from paths_tpu_torch.encoders import convert_vit as tconvert
from paths_tpu_torch.encoders import registry as tregistry
from paths_tpu_torch.encoders import transforms as ttransforms
from paths_tpu_torch.encoders import vit as tvit

SPECS = {
    "plain": dict(),
    "layerscale": dict(layer_scale=True),
    "swiglu_registers": dict(swiglu=True, num_reg_tokens=4, pool="token+mean"),
}


def small_specs(**kw):
    base = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                mlp_ratio=2.0)
    base.update(kw)
    return jvit.ViTSpec(**base), tvit.ViTSpec(**base)


def _randomised(params, seed):
    """JAX params with every leaf (biases, norms, LayerScale too) random, so
    that no term of the forward is hidden behind a zero or a 1e-5."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, np.ndarray):
            return node
        if key in ("scale", "ls1", "ls2"):
            return (1.0 + 0.1 * rng.normal(size=node.shape)).astype(np.float32)
        if node.ndim == 1 or key in ("cls_token", "reg_tokens"):
            return (0.1 * rng.normal(size=node.shape)).astype(np.float32)
        return node
    return walk(params)


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            if k != "spec":
                yield from _tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("n_in,n_out,method", [
    (256, 224, "bicubic"), (256, 224, "bilinear"), (100, 224, "bicubic"),
    (64, 64, "bicubic"), (300, 32, "bilinear")])
def test_resize_matrix_matches_jax(n_in, n_out, method):
    want = jtransforms._resize_matrix(n_in, n_out, method)
    got = ttransforms._resize_matrix(n_in, n_out, method)
    assert got.shape == (n_out, n_in) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["UNI_TRANSFORM", "VIRCHOW2_TRANSFORM",
                                  "KAIKO_TRANSFORM", "IDENTITY_TRANSFORM"])
def test_apply_transform_matches_jax(name):
    jspec, tspec = getattr(jtransforms, name), getattr(ttransforms, name)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    imgs = np.random.default_rng(0).uniform(size=(2, 256, 300, 3)).astype(np.float32)
    want = np.asarray(jtransforms.apply_transform(jnp.asarray(imgs), jspec))
    got = ttransforms.apply_transform(torch.from_numpy(imgs), tspec).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_zoo_specs_match_jax():
    """Every spec but Virchow2 equals the JAX package's. The JAX package's
    VIRCHOW2 (20 heads of 64, branches of 6832 held as 6912, no LayerScale)
    is not the published model and is not edited; the port's is published
    Virchow2, held to its published integers."""
    for name in ("UNI", "KAIKO_VITS16", "KAIKO_VITS8", "KAIKO_VITB16",
                 "KAIKO_VITB8", "KAIKO_VITL14"):
        j, t = getattr(jvit, name), getattr(tvit, name)
        own = dataclasses.asdict(t)
        assert own.pop("glu_width") == 0, name
        assert dataclasses.asdict(j) == own, name
        assert (j.mlp_hidden_padded, j.out_dim, j.num_patches) == \
            (t.mlp_hidden_padded, t.out_dim, t.num_patches)
    v = tvit.VIRCHOW2
    assert (v.num_heads, v.head_dim, v.mlp_hidden, v.mlp_hidden_padded) == \
        (16, 80, 3416, 3456)
    assert v.layer_scale and v.num_patches + 1 + v.num_reg_tokens == 261
    assert v.out_dim == 2560


@pytest.mark.parametrize("shape", sorted(SPECS))
def test_vit_init_bit_equal_to_jax(shape):
    jspec, tspec = small_specs(**SPECS[shape])
    want = dict(_tree_leaves(jvit.vit_init(7, jspec)))
    got = dict(_tree_leaves(convert.vit_to_jax(tvit.vit_init(7, tspec))))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        assert np.array_equal(got[key], arr), key


@pytest.mark.parametrize("shape", sorted(SPECS))
@pytest.mark.parametrize("route", ["xla", "fused", "flash"])
def test_vit_apply_matches_jax(monkeypatch, shape, route):
    """Each route of the port against JAX's plain route, and the fused route
    also against JAX's fused route (Pallas in interpret mode)."""
    monkeypatch.setattr(jvf, "INTERPRET", True)
    jspec, tspec = small_specs(**SPECS[shape])
    params = _randomised(jvit.vit_init(3, jspec), seed=4)
    model = convert.vit_from_jax(params, tspec)
    imgs = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.float32, route)
    assert got.dtype == torch.float32 and got.shape == (3, tspec.out_dim)
    refs = ["xla"] + (["fused"] if route == "fused" else [])
    for ref in refs:
        want = np.asarray(jvit.vit_apply(params, jnp.asarray(imgs),
                                         compute_dtype=jnp.float32,
                                         attn_impl=ref))
        assert np.abs(want).max() > 0.5      # O(1) features: the bar has teeth
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("rows", ["patches", "cls+patches", "all"])
def test_pos_embed_layouts_match_jax(rows):
    jspec, tspec = small_specs(num_reg_tokens=2)
    params = _randomised(jvit.vit_init(1, jspec), seed=2)
    n = {"patches": 16, "cls+patches": 17, "all": 19}[rows]
    params["pos_embed"] = params["pos_embed"][:n]
    model = convert.vit_from_jax(params, tspec)
    imgs = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_apply(params, jnp.asarray(imgs),
                                     compute_dtype=jnp.float32))
    got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.float32, "xla")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_vit_apply_bf16_close_to_jax():
    """bf16 compute: the two frameworks round at the same places but sum in
    other orders; 5e-2 on O(1) features is the JAX tests' own bf16 bar."""
    jspec, tspec = small_specs(layer_scale=True)
    params = _randomised(jvit.vit_init(3, jspec), seed=4)
    model = convert.vit_from_jax(params, tspec)
    imgs = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_apply(params, jnp.asarray(imgs),
                                     compute_dtype=jnp.bfloat16))
    for route in ("xla", "fused"):
        got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.bfloat16, route)
        assert np.abs(got.numpy() - want).max() < 5e-2, route


@pytest.mark.parametrize("stacked", [False, True])
def test_converter_round_trip(stacked):
    jspec, tspec = small_specs(**SPECS["swiglu_registers"], layer_scale=True)
    params = _randomised(jvit.vit_init(0, jspec), seed=1)
    src = jvit.stack_vit_blocks(params) if stacked else params
    back = convert.vit_to_jax(convert.vit_from_jax(src, tspec))
    want, got = dict(_tree_leaves(params)), dict(_tree_leaves(back))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert np.array_equal(got[key], arr), key


@pytest.mark.parametrize("shape", sorted(SPECS))
def test_vit_from_timm_matches_jax_converter(shape, tmp_path):
    """A timm-layout state dict through both converters: the same weights
    (SwiGLU gate and value halves zero-padded alike) and the same features
    as the torch mirror of timm's forward."""
    jspec, tspec = small_specs(**SPECS[shape], mlp_ratio=1.5)
    torch.manual_seed(0)
    mirror = TimmViT(jspec.img_size, jspec.patch_size, jspec.embed_dim,
                     jspec.depth, jspec.num_heads, jspec.mlp_hidden,
                     layer_scale=jspec.layer_scale, swiglu=jspec.swiglu,
                     reg_tokens=jspec.num_reg_tokens, pool=jspec.pool).eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    want = dict(_tree_leaves(jconvert.vit_from_timm(sd, jspec)))
    model = tconvert.vit_from_timm(sd, tspec)
    got = dict(_tree_leaves(convert.vit_to_jax(model)))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert np.array_equal(got[key], arr), key
    if tspec.swiglu:
        assert tspec.mlp_hidden_padded > tspec.mlp_hidden
        assert model.blocks[0].fc1.weight.shape[0] == 2 * tspec.mlp_hidden_padded

    path = str(tmp_path / "timm.pt")
    torch.save({"model": mirror.state_dict()}, path)
    loaded = tconvert.vit_from_torch_file(path, tspec)
    imgs = np.random.default_rng(0).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out_t = mirror(torch.tensor(imgs.transpose(0, 3, 1, 2))).numpy()
    out = tvit.vit_apply(loaded, torch.from_numpy(imgs), torch.float32, "fused")
    np.testing.assert_allclose(out.numpy(), out_t, rtol=0, atol=1e-4)


def test_from_name_shapes_and_routes():
    encode, dim, tspec = tregistry.from_name(
        "kaiko-vits16", compute_dtype=torch.float32, device="cpu", seed=0)
    assert dim == 384 and tspec == ttransforms.KAIKO_TRANSFORM
    imgs = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3), np.uint8)
    out = encode(torch.from_numpy(imgs))
    assert out.shape == (2, 384) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    # uint8 and the same images as [0, 1] floats encode alike
    again = encode(torch.from_numpy(imgs.astype(np.float32) / 255.0))
    torch.testing.assert_close(out, again, atol=1e-5, rtol=0)
    # "auto" on an explicitly requested CPU is the plain route
    assert tregistry._resolve_block_impl("auto", torch.device("cpu")) == "xla"
    assert tregistry._resolve_block_impl("auto", torch.device("cuda")) == "fused"
    assert tregistry._resolve_block_impl("flash", torch.device("cuda")) == "flash"


@pytest.mark.parametrize("impl", ["fused", "fused1", "int8"])
def test_from_name_patch8_routes_on_cpu(impl):
    """A patch-8 Kaiko model (785 tokens) through each kernel route on the
    CPU: the routes' plain versions take it without raising and launch no
    kernel; fused and fused1 agree with the plain route to f32 summation
    order, int8 to its quantisation error (the bars of the routes' other
    tests)."""
    from paths_tpu_torch.kernels import vit_fused as tvf
    from paths_tpu_torch.kernels import vit_int8 as tvi

    wrappers = (tvf.fused_attn_block, tvf.fused_mlp_block, tvf.fused_block,
                tvi.fused_attn_block_i8, tvi.fused_mlp_block_i8)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 256, 256, 3), np.uint8))
    feats = {}
    for route in (impl, "xla"):
        encode, dim, _ = tregistry.from_name(
            "kaiko-vits8", compute_dtype=torch.float32, device="cpu", seed=0,
            block_impl=route)
        before = [f.launches for f in wrappers]
        feats[route] = encode(imgs)
        assert [f.launches for f in wrappers] == before
    got, want = feats[impl], feats["xla"]
    assert dim == 384 and got.shape == (1, 384) and torch.isfinite(got).all()
    if impl == "int8":
        cos = torch.nn.functional.cosine_similarity(got, want).item()
        assert (got - want).norm() <= 0.1 * want.norm() and cos >= 0.99, cos
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kwargs,err", [
    (dict(name="resnet50"), ValueError),
    (dict(name="resnet18"), ValueError),
    (dict(name="UNI", block_impl="mosaic"), ValueError),
    (dict(name="no-such-encoder"), ValueError),
])
def test_from_name_refusals(kwargs, err):
    with pytest.raises(err) as info:
        tregistry.from_name(device="cpu", **kwargs)
    if kwargs["name"].startswith("resnet"):
        # the resnets need a torchvision weight file
        assert "state_dict file" in str(info.value)
