"""The plain version of the port's whole-block kernel (#7, `fused_block`)
against the JAX package's single Pallas kernel in interpret mode, and the
`fused1` route of `vit_apply` against JAX's, on the same numpy inputs.

f32: atol 3e-5 on O(1) activations, the JAX tests' own bar for this kernel
(both sides compute in f32 and differ in summation order and in erf's
implementation, 1.5e-7). bf16: both round at the same places (P after the
division, each head's P V, x after the attention half), so they differ by
single roundings that a later product may amplify: 2 bf16 ulps of the
largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoders import _randomised, small_specs
from paths_tpu.encoders import vit as jvit
from paths_tpu.kernels import vit_fused as jvf
from paths_tpu_torch import convert
from paths_tpu_torch.encoders import vit as tvit
from paths_tpu_torch.kernels import vit_fused as tvf

F32_ATOL = 3e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jvf, "INTERPRET", True)


def _blocks(d, hidden, seed, ls, jd, td):
    """One block's random parameters as (JAX tree, port tree): matrices in
    the compute dtype, (in, out) for JAX and (out, in) for the port."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    raw = {"norm1": {"scale": 1.0 + 0.1 * f(d), "bias": 0.1 * f(d)},
           "attn": {"qkv_w": f(d, 3 * d, scale=d ** -0.5), "qkv_b": 0.1 * f(3 * d),
                    "proj_w": f(d, d, scale=d ** -0.5), "proj_b": 0.1 * f(d)},
           "norm2": {"scale": 1.0 + 0.1 * f(d), "bias": 0.1 * f(d)},
           "mlp": {"fc1_w": f(d, hidden, scale=d ** -0.5), "fc1_b": 0.1 * f(hidden),
                   "fc2_w": f(hidden, d, scale=hidden ** -0.5),
                   "fc2_b": 0.1 * f(d)}}
    if ls:
        raw["ls1"], raw["ls2"] = 1.0 + 0.1 * f(d), 1.0 + 0.1 * f(d)

    def jleaf(k, v):
        return jnp.asarray(v, jd if k.endswith("_w") else jnp.float32)

    def tleaf(k, v):
        t = torch.from_numpy(v)
        return t.T.contiguous().to(td) if k.endswith("_w") else t

    def build(leaf):
        return {g: ({k: leaf(k, v) for k, v in grp.items()}
                    if isinstance(grp, dict) else leaf(g, grp))
                for g, grp in raw.items()}
    return build(jleaf), build(tleaf)


# (B, D) of each (N, heads) case: 785 tokens are the patch-8 Kaiko models'
WIDTHS = {17: (3, 32), 5: (3, 32), 785: (1, 128)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ls", [True, False])
@pytest.mark.parametrize("exact_gelu", [True, False])
@pytest.mark.parametrize("n,heads", [(17, 2), (5, 4), (785, 2)])
def test_block_plain_matches_pallas(dtype, ls, exact_gelu, n, heads):
    jd, td = DTYPES[dtype]
    b, d = WIDTHS[n]
    jb, tb = _blocks(d, 64, seed=n, ls=ls, jd=jd, td=td)
    x = np.random.default_rng(1).normal(size=(b, n, d)).astype(np.float32)
    want = np.asarray(jvf.fused_block(
        jnp.asarray(x, jd), jb, num_heads=heads, exact_gelu=exact_gelu,
        num_chunks=2).astype(jnp.float32))
    got = tvf.fused_block(torch.from_numpy(x).to(td), tb, num_heads=heads,
                          exact_gelu=exact_gelu)
    assert got.dtype == td and got.shape == (b, n, d)
    tol = F32_ATOL if dtype == "float32" else \
        2 * 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_block_rounds_where_its_own_kernel_does():
    """In bf16 the one-launch block is not the attention block followed by
    the MLP block: P is normalised before it is rounded. The two plain
    versions must differ somewhere, and stay within bf16's reach."""
    _, tb = _blocks(32, 64, seed=2, ls=True, jd=jnp.bfloat16, td=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 17, 32)).astype(np.float32)).bfloat16()
    one = tvf.fused_block_reference(x, tb, num_heads=2)
    at, ml = tb["attn"], tb["mlp"]
    two = tvf.fused_mlp_block_reference(
        tvf.fused_attn_block_reference(
            x, tb["norm1"]["scale"], tb["norm1"]["bias"], at["qkv_w"],
            at["qkv_b"], at["proj_w"], at["proj_b"], tb["ls1"], num_heads=2),
        tb["norm2"]["scale"], tb["norm2"]["bias"], ml["fc1_w"], ml["fc1_b"],
        ml["fc2_w"], ml["fc2_b"], tb["ls2"])
    diff = (one.float() - two.float()).abs().max().item()
    assert 0 < diff <= 4 * 2.0 ** -8 * two.float().abs().max().item()


@pytest.mark.parametrize("shape", ["plain", "layerscale", "tanh"])
def test_vit_apply_fused1_matches_jax(shape):
    """The fused1 route against JAX's fused1 route (the single Pallas kernel
    in interpret mode) and JAX's plain route: O(1) features, atol 1e-4 for a
    whole f32 forward as for the other routes."""
    kw = {"plain": {}, "layerscale": dict(layer_scale=True),
          "tanh": dict(gelu="tanh")}[shape]
    jspec, tspec = small_specs(**kw)
    params = _randomised(jvit.vit_init(3, jspec), seed=4)
    model = convert.vit_from_jax(params, tspec)
    imgs = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.float32, "fused1")
    assert got.dtype == torch.float32 and got.shape == (3, tspec.out_dim)
    for ref in ("fused1", "xla"):
        want = np.asarray(jvit.vit_apply(params, jnp.asarray(imgs),
                                         compute_dtype=jnp.float32,
                                         attn_impl=ref))
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_fused1_on_swiglu_takes_the_fused_pair(monkeypatch):
    """A SwiGLU spec has no one-launch kernel: `fused1` goes through the
    attention block and the packed-SwiGLU block, as in the JAX package."""
    jspec, tspec = small_specs(swiglu=True, num_reg_tokens=4, pool="token+mean")
    params = _randomised(jvit.vit_init(3, jspec), seed=4)
    model = convert.vit_from_jax(params, tspec)
    imgs = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    calls = []
    for name in ("fused_block", "fused_attn_block", "fused_swiglu_mlp_block"):
        fn = getattr(tvf, name)
        monkeypatch.setattr(tvf, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.float32, "fused1")
    assert calls == ["fused_attn_block", "fused_swiglu_mlp_block"] * tspec.depth
    want = np.asarray(jvit.vit_apply(params, jnp.asarray(imgs),
                                     compute_dtype=jnp.float32,
                                     attn_impl="fused1"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_fused1_bf16_close_to_jax():
    jspec, tspec = small_specs(layer_scale=True)
    params = _randomised(jvit.vit_init(3, jspec), seed=4)
    model = convert.vit_from_jax(params, tspec)
    imgs = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_apply(params, jnp.asarray(imgs),
                                     compute_dtype=jnp.bfloat16,
                                     attn_impl="fused1"))
    got = tvit.vit_apply(model, torch.from_numpy(imgs), torch.bfloat16, "fused1")
    assert np.abs(got.numpy() - want).max() < 5e-2


def test_cpu_call_launches_nothing():
    before = tvf.fused_block.launches
    _, tb = _blocks(64, 64, seed=0, ls=False, jd=jnp.float32, td=torch.float32)
    tvf.fused_block(torch.zeros(1, 4, 64), tb, num_heads=1)
    assert tvf.fused_block.launches == before
