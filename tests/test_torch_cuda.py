"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The file
imports neither JAX nor `paths_tpu`, so it runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version both compute in f32 (TF32 off) and differ only in
summation order: 2e-5 absolute on O(1) outputs (bf16 I/O adds the final
rounding of the output).
"""
import numpy as np
import pytest
import torch

from paths_tpu_torch.kernels import flash_attention as tfa
from paths_tpu_torch.nn.attention import MultiheadAttention

TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, nq, nk, d, lengths, device, dtype=torch.float32):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
               .to(device, dtype) for n in (nq, nk, nk))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(257, 257, 32), (81, 81, 32),
                                     (37, 45, 32), (130, 130, 64)])
def test_flash_kernel_matches_plain(card, nq, nk, d):
    q, k, v, ln = _inputs(4, 4, nq, nk, d, [nk, 1, nk // 2, 33], card)
    before = tfa.masked_flash_attention_fwd.launches
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
    torch.cuda.synchronize()
    assert tfa.masked_flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_flash_kernel_bf16_matches_plain(card, d):
    """bf16 in and out, f32 inside: the two differ by the final rounding to
    bf16, within torch's bf16 tolerance."""
    q, k, v, ln = _inputs(4, 4, 257, 257, d, [257, 1, 100, 33], card,
                          torch.bfloat16)
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_raises_instead_of_falling_back(card):
    q, k, v, ln = _inputs(1, 1, 8, 8, 16, [8], card)
    with pytest.raises(ValueError):
        tfa.masked_flash_attention_fwd(q, k, v, ln)
    q, k, v, ln = _inputs(1, 1, 8, 8, 32, [8], card)
    with pytest.raises(RuntimeError):
        tfa.masked_flash_attention_fwd(q.requires_grad_(True), k, v, ln)


@pytest.mark.cuda
def test_mha_kernel_route_matches_plain_route(card):
    mha = MultiheadAttention(128, 4, generator=torch.Generator().manual_seed(0))
    mha = mha.to(card).requires_grad_(False)
    x = torch.randn(8, 81, 128, generator=torch.Generator().manual_seed(1)).to(card)
    valid = torch.arange(81, device=card)[None] < torch.tensor(
        [81, 1, 40, 7, 81, 2, 60, 33], device=card)[:, None]
    before = tfa.masked_flash_attention_fwd.launches
    got = mha(x, x, x, key_valid=valid, impl="pallas")
    assert tfa.masked_flash_attention_fwd.launches == before + 1
    want = mha(x, x, x, key_valid=valid, impl="xla")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
