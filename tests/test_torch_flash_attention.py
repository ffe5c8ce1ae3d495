"""The port's masked flash-attention forward against the JAX Pallas kernel.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in the Pallas interpreter. Both compute in f32 on the CPU, where
the two only differ in summation order: 1e-5 absolute bounds that on O(1)
outputs, and on gradients relative to the largest one (they sum up to N
terms). The CUDA kernels themselves are checked on a card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paths_tpu.kernels.flash_attention as fa
from paths_tpu_torch.kernels import flash_attention as tfa

TOL = 1e-5  # f32 on the CPU, different summation order


def _inputs(b, h, nq, nk, d, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("nq,nk,lengths", [
    (37, 45, [45, 1, 20]),     # Nq != Nk, no multiple of any block
    (45, 45, [1, 45, 33]),     # self-attention shape, ragged
    (81, 81, [81, 5, 2]),      # a deeper level's width (4K + 1)
])
def test_plain_flash_matches_pallas_interpret(monkeypatch, nq, nk, lengths):
    monkeypatch.setattr(fa, "INTERPRET", True)
    q, k, v, ln = _inputs(3, 2, nq, nk, 32, lengths)
    want_out, want_lse = fa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        block_q=16, block_k=16)
    out, lse = tfa.masked_flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ln))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL)


def test_padded_query_rows_are_normalised_not_zeroed():
    """Rows at or past the length attend over the valid keys, like the JAX
    kernel and its reference."""
    q, k, v, ln = _inputs(1, 1, 8, 8, 32, [3])
    out, _ = tfa.flash_attention_reference(*map(torch.from_numpy, (q, k, v, ln)))
    assert np.abs(out.numpy()[0, 0, 5:]).min() > 0
    want = fa._attn_reference(*map(jnp.asarray, (q, k, v, ln)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("bad", ["dtype", "contig", "head_dim", "lengths",
                                 "grad"])
def test_argument_checks_raise(bad):
    q, k, v, ln = map(torch.from_numpy, _inputs(2, 2, 8, 8, 32, [8, 3]))
    if bad == "dtype":
        q = q.bfloat16()       # bf16 is supported, but not mixed with f32
    elif bad == "contig":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "head_dim":
        q, k, v = (t[..., :16].contiguous() for t in (q, k, v))
    elif bad == "lengths":
        ln = ln.long()
    else:
        q.requires_grad_(True)
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        tfa._check(q, k, v, ln)


def test_wrapper_counts_only_kernel_launches():
    """The CPU route is the plain version: it launches nothing."""
    before = tfa.masked_flash_attention_fwd.launches
    q, k, v, ln = map(torch.from_numpy, _inputs(1, 1, 4, 4, 32, [4]))
    tfa.masked_flash_attention_fwd(q, k, v, ln)
    assert tfa.masked_flash_attention_fwd.launches == before


def _grad_close(got, want):
    want = np.asarray(want)
    tol = TOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("nq,nk,lengths", [
    (37, 45, [45, 1, 0]),      # Nq != Nk, length 0 and 1
    (81, 81, [81, 5, 2]),      # a deeper level's width (4K + 1)
])
def test_plain_backward_matches_pallas_interpret(monkeypatch, nq, nk, lengths):
    """The port's backward (plain versions on the CPU) against the JAX
    `_flash_backward` kernels and `jax.vjp(masked_flash_attention)`, both
    in the interpreter; keys at or past the length get exactly zero."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    q, k, v, ln = _inputs(3, 2, nq, nk, 32, lengths)
    dout = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jln, jdo = map(jnp.asarray, (q, k, v, ln, dout))
    out, lse = fa._flash_forward(jq, jk, jv, jln, block_q=16, block_k=16)
    want = fa._flash_backward(jq, jk, jv, jln, out, lse, jdo, block_q=16,
                              block_k=16)
    _, vjp = jax.vjp(lambda a, b, c: fa.masked_flash_attention(
        a, b, c, jln, 16, 16), jq, jk, jv)
    want_vjp = vjp(jdo)
    got = tfa.masked_flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, ln)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(dout))
    for g, w, wv in zip(got, want, want_vjp):
        _grad_close(g, w)
        _grad_close(g, wv)
    for i, n in enumerate(lengths):
        assert not got[1][i, :, n:].any() and not got[2][i, :, n:].any()
        if n == 0:
            assert not got[0][i].any()


def test_function_matches_autograd_through_plain_forward():
    """`masked_flash_attention` on the CPU (both directions on the plain
    versions) against autograd through the plain forward; `lengths` gets
    no gradient and double backward raises."""
    q, k, v, ln = map(torch.from_numpy, _inputs(3, 2, 29, 33, 32, [33, 1, 0]))
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    grads = []
    for fn in (tfa.masked_flash_attention,
               lambda *a: tfa.flash_attention_reference(*a)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, ln)
        out.backward(dout)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        _grad_close(g, w.numpy())

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.masked_flash_attention(*leaves, ln)
    (gq,) = torch.autograd.grad(out, leaves[0], dout, create_graph=True)
    with pytest.raises(RuntimeError):
        gq.sum().backward()


# ------------------------------------------------------------- bf16 rounding
# In bf16 the TPU kernels round P to bf16 before P V (against the running max
# at the end of each `block_k`-key block) and dS to bf16 before dS K and
# dS^T Q; the port's plain versions round at the same points. What is left
# is f32 summation order and the two libraries' exp, which move a rounding
# only where a value lies within a few f32 ulps of a bf16 boundary: at most
# BF16_SHARE of the elements may differ at all. Where one P flips, its row's
# outputs move by that P's bf16 step times |v| / l, which is small against
# the row's largest output but not against an output near zero: so a
# difference is held to one bf16 ulp of the largest Pallas output of its row.
BF16_SHARE = 1e-3


def _ulp(w: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |w| (f32 tensor): 2^(e - 8) for |w| in [2^(e-1), 2^e)."""
    return torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)


def _bf16(x):
    """(jax bf16 array, torch bf16 tensor) of one f32 numpy array."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("n,block_k", [(197, 256), (261, 256), (600, 256),
                                       (600, 512)],
                         ids=["one-block", "two-blocks", "three-blocks",
                              "two-blocks-512"])
def test_plain_bf16_forward_rounds_as_pallas(monkeypatch, n, block_k):
    """The plain bf16 forward against `_flash_forward` in interpret mode at
    head_dim 64, ragged lengths (1 among them), one or several key blocks."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    q, k, v, ln = _inputs(3, 2, n, n, 64, [n, 1, 2 * n // 5], seed=n)
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want_out, want_lse = fa._flash_forward(jq, jk, jv, jnp.asarray(ln),
                                           block_k=block_k)
    out, lse = tfa.masked_flash_attention_fwd(tq, tk, tv, torch.from_numpy(ln),
                                              block_k)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = _f32(want_out)
    diff = (out.float() - want).abs()
    share = (diff > 0).float().mean().item()
    worst = (diff / _ulp(want.abs().amax(-1, keepdim=True))).max().item()
    print(f"N {n} block_k {block_k}: {share:.5f} of the outputs differ, worst "
          f"{worst:.3g} ulps of its row's largest output")
    assert share <= BF16_SHARE and worst <= 1.0, (share, worst)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=TOL,
                               rtol=1e-6)


def test_plain_bf16_forward_block_k_places_the_rounding():
    """Where the keys' largest score lies past the first key block, the
    block sets the max P is rounded against: the outputs differ with
    block_k, the lse does not; in f32 block_k changes nothing."""
    q, k, v, ln = _inputs(2, 2, 40, 300, 64, [300, 290], seed=3)
    k[:, :, 280] *= 4.0          # the largest scores in the second block
    args = [torch.from_numpy(t) for t in (q, k, v, ln)]
    bf = [t.bfloat16() for t in args[:3]] + args[3:]
    one, lse_one = tfa.flash_attention_reference(*bf, block_k=512)
    two, lse_two = tfa.flash_attention_reference(*bf, block_k=256)
    assert not torch.equal(one, two)
    torch.testing.assert_close(lse_one, lse_two, atol=TOL, rtol=0)
    f_one = tfa.flash_attention_reference(*args, block_k=512)
    f_two = tfa.flash_attention_reference(*args, block_k=64)
    for a, b in zip(f_one, f_two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,d", [(81, 32), (257, 32)])
def test_plain_bf16_backward_rounds_as_pallas(monkeypatch, n, d):
    """The plain bf16 backward against `_flash_backward` in interpret mode,
    from the Pallas forward's out and lse, at the training path's shapes (the
    flagship's head_dim 32, N 81 and 257). With one valid key the softmax is
    constant, so dq and dk are 0 in exact arithmetic and both sides give f32
    rounding noise there: those rows are held to 1e-5 of zero on both sides;
    every other element is counted. One dS that rounds the other way moves a
    whole row of dq and of dk, so the share grows with N and D (0.04-0.06%
    at N 81, D 64 against 0 at D 32 here)."""
    monkeypatch.setattr(fa, "INTERPRET", True)
    lengths = [n, 1, 2 * n // 5]
    q, k, v, ln = _inputs(3, 2, n, n, d, lengths, seed=n)
    dout = np.random.default_rng(n + 1).normal(size=q.shape).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = map(_bf16, (q, k, v, dout))
    jln = jnp.asarray(ln)
    out, lse = fa._flash_forward(jq, jk, jv, jln)
    want = fa._flash_backward(jq, jk, jv, jln, out, lse, jdo)
    got = tfa.masked_flash_attention_bwd(
        tq, tk, tv, torch.from_numpy(ln), _f32(out).bfloat16(), _f32(lse), tdo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float(), _f32(w)
        if name != "dv":
            assert g[1].abs().max() <= 1e-5 and w[1].abs().max() <= 1e-5
            g, w = g[[0, 2]], w[[0, 2]]
        share = (g != w).float().mean().item()
        print(f"N {n} D {d} {name}: {share:.5f} of the elements differ")
        assert share <= BF16_SHARE, (name, share)
