"""The port's masked flash-attention forward against the JAX Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX kernel
runs in the Pallas interpreter. Both compute in f32 on the CPU, where the
two only differ in summation order: 1e-5 absolute bounds that on O(1)
outputs. The CUDA kernel itself is checked on a card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""
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
