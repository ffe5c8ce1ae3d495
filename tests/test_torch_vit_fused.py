"""The plain versions of the port's fused ViT block kernels (#4 attention
block, #5 GELU MLP block, #6 packed-SwiGLU MLP block) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

f32: atol 3e-5 on O(1) activations, the JAX tests' own bar (both sides
compute in f32 and differ in summation order and in erf's implementation,
1.5e-7). bf16: both round at the same places, so they differ by single
roundings that a later product may amplify: 2 bf16 ulps of the largest
output (2 * 2^-8 * max|out|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paths_tpu.kernels import vit_fused as jvf
from paths_tpu_torch.kernels import vit_fused as tvf

F32_ATOL = 3e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jvf, "INTERPRET", True)


def _inputs(b, n, d, hidden, packed, seed, ls):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    p = dict(x=f(b, n, d), ns=1.0 + 0.1 * f(d), nb=0.1 * f(d),
             qkv_w=f(d, 3 * d, scale=d ** -0.5), qkv_b=0.1 * f(3 * d),
             proj_w=f(d, d, scale=d ** -0.5), proj_b=0.1 * f(d),
             fc1_w=f(d, packed * hidden, scale=d ** -0.5),
             fc1_b=0.1 * f(packed * hidden),
             fc2_w=f(hidden, d, scale=hidden ** -0.5), fc2_b=0.1 * f(d),
             ls=(1.0 + 0.1 * f(d)) if ls else None)
    return p


def _bf16(a):
    """numpy f32 -> the same values snapped to the bf16 grid."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _j(a, dtype):
    return None if a is None else jnp.asarray(a, dtype)


def _t(a, dtype, transpose=False):
    if a is None:
        return None
    t = torch.from_numpy(a)
    return (t.T.contiguous() if transpose else t).to(dtype)


def _tol(dtype, want):
    if dtype == "float32":
        return F32_ATOL
    return 2 * 2.0 ** -8 * float(np.abs(want).max())


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# (B, D) of each (N, heads) case: 785 tokens are the patch-8 Kaiko models'
WIDTHS = {17: (3, 32), 5: (3, 32), 785: (1, 128)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ls", [True, False])
@pytest.mark.parametrize("n,heads", [(17, 2), (5, 4), (785, 2)])
def test_attn_block_plain_matches_pallas(dtype, ls, n, heads):
    jd, td = DTYPES[dtype]
    b, d = WIDTHS[n]
    p = _inputs(b, n, d, 64, 1, seed=n, ls=ls)
    want = np.asarray(jvf.fused_attn_block(
        _j(p["x"], jd), _j(p["ns"], jnp.float32), _j(p["nb"], jnp.float32),
        _j(p["qkv_w"], jd), _j(p["qkv_b"], jnp.float32), _j(p["proj_w"], jd),
        _j(p["proj_b"], jnp.float32), _j(p["ls"], jnp.float32),
        num_heads=heads).astype(jnp.float32))
    got = tvf.fused_attn_block(
        _t(p["x"], td), _t(p["ns"], torch.float32), _t(p["nb"], torch.float32),
        _t(p["qkv_w"], td, True), _t(p["qkv_b"], torch.float32),
        _t(p["proj_w"], td, True), _t(p["proj_b"], torch.float32),
        _t(p["ls"], torch.float32), num_heads=heads)
    assert got.dtype == td and got.shape == (b, n, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ls", [True, False])
@pytest.mark.parametrize("exact_gelu", [True, False])
def test_mlp_block_plain_matches_pallas(dtype, ls, exact_gelu):
    jd, td = DTYPES[dtype]
    p = _inputs(2, 13, 32, 64, 1, seed=3, ls=ls)
    want = np.asarray(jvf.fused_mlp_block(
        _j(p["x"], jd), _j(p["ns"], jnp.float32), _j(p["nb"], jnp.float32),
        _j(p["fc1_w"], jd), _j(p["fc1_b"], jnp.float32), _j(p["fc2_w"], jd),
        _j(p["fc2_b"], jnp.float32), _j(p["ls"], jnp.float32),
        exact_gelu=exact_gelu, num_chunks=2).astype(jnp.float32))
    got = tvf.fused_mlp_block(
        _t(p["x"], td), _t(p["ns"], torch.float32), _t(p["nb"], torch.float32),
        _t(p["fc1_w"], td, True), _t(p["fc1_b"], torch.float32),
        _t(p["fc2_w"], td, True), _t(p["fc2_b"], torch.float32),
        _t(p["ls"], torch.float32), exact_gelu=exact_gelu)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ls", [True, False])
@pytest.mark.parametrize("num_chunks,hidden", [(1, 256), (2, 256), (1, 96), (2, 96)],
                         ids=["1", "2", "1-h96", "2-h96"])
def test_swiglu_block_plain_matches_pallas(dtype, ls, num_chunks, hidden):
    """The JAX kernel's `num_chunks` is a TPU tuning knob: the port's result
    must not depend on it. A hidden width of 96 is no multiple of the CUDA
    kernel's 64-unit gate/value tiles."""
    jd, td = DTYPES[dtype]
    p = _inputs(2, 13, 32, hidden, 2, seed=4, ls=ls)
    want = np.asarray(jvf.fused_swiglu_mlp_block(
        _j(p["x"], jd), _j(p["ns"], jnp.float32), _j(p["nb"], jnp.float32),
        _j(p["fc1_w"], jd), _j(p["fc1_b"], jnp.float32), _j(p["fc2_w"], jd),
        _j(p["fc2_b"], jnp.float32), _j(p["ls"], jnp.float32),
        num_chunks=num_chunks).astype(jnp.float32))
    got = tvf.fused_swiglu_mlp_block(
        _t(p["x"], td), _t(p["ns"], torch.float32), _t(p["nb"], torch.float32),
        _t(p["fc1_w"], td, True), _t(p["fc1_b"], torch.float32),
        _t(p["fc2_w"], td, True), _t(p["fc2_b"], torch.float32),
        _t(p["ls"], torch.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype, want))


def test_cpu_calls_launch_nothing():
    before = (tvf.fused_attn_block.launches, tvf.fused_mlp_block.launches,
              tvf.fused_swiglu_mlp_block.launches)
    p = _inputs(1, 4, 64, 64, 1, seed=0, ls=False)
    tvf.fused_mlp_block(
        _t(p["x"], torch.float32), _t(p["ns"], torch.float32),
        _t(p["nb"], torch.float32), _t(p["fc1_w"], torch.float32, True),
        _t(p["fc1_b"], torch.float32), _t(p["fc2_w"], torch.float32, True),
        _t(p["fc2_b"], torch.float32), None)
    assert before == (tvf.fused_attn_block.launches,
                      tvf.fused_mlp_block.launches,
                      tvf.fused_swiglu_mlp_block.launches)


class _FakeCuda:
    """Stands in for a CUDA tensor in the wrappers' checks, which run
    before anything touches the card."""

    def __init__(self, t, device="cuda:0"):
        self._t = t
        self.device = torch.device(device)

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.mark.parametrize("make,err", [
    (lambda: torch.zeros(2, 5, 64, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(5, 64), ValueError),
    (lambda: torch.zeros(2, 5, 48), ValueError),
    (lambda: torch.zeros(2, 5, 128)[:, :, ::2], ValueError),
    (lambda: torch.zeros(2, 5, 64, requires_grad=True), RuntimeError),
])
def test_wrapper_refuses_bad_x(make, err):
    with pytest.raises(err):
        tvf._check_x(_FakeCuda(make()))


def test_wrapper_refuses_other_devices_and_bad_weights():
    x = _FakeCuda(torch.zeros(2, 5, 64))
    with pytest.raises(ValueError, match="no fused ViT kernel"):
        tvf._check_x(_FakeCuda(torch.zeros(2, 5, 64), device="meta"))
    with pytest.raises(ValueError, match="is on"):
        tvf._check_weight(x, "qkv_w", torch.zeros(192, 64), (192, 64))
    with pytest.raises(TypeError, match="compute dtype"):
        tvf._check_weight(x, "qkv_w", _FakeCuda(torch.zeros(
            192, 64, dtype=torch.bfloat16)), (192, 64))
    with pytest.raises(ValueError, match="layout"):
        tvf._check_weight(x, "qkv_w", _FakeCuda(torch.zeros(64, 192)),
                          (192, 64))
    with pytest.raises(ValueError, match="float vector"):
        tvf._vector(x, "ls", _FakeCuda(torch.zeros(63)), 64)
