"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The file
imports neither JAX nor `paths_tpu`, so it runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version both compute in f32 (TF32 off) and differ only in
summation order: 2e-5 absolute on O(1) outputs (bf16 I/O adds the final
rounding of the output). Gradients sum up to N terms of O(1), so the
backward is held to 1e-5 relative to the largest plain gradient.
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


# bf16: kernel and plain version round P to bf16 at the same points (against
# the running max at the end of each `block_k` block), so an output differs
# only where f32 summation order or the kernel's fast exp flips one of those
# roundings: that moves its row by at most a bf16 step of that P times
# |v| / l, which can exceed torch's elementwise tolerance on an output near
# zero. An output is therefore held to torch's bf16 tolerance or 2 bf16 ulps
# of its row's largest output (the ViT kernels' bf16 bar, per row), and at
# most FLASH_BF16_CHANGED of the outputs may differ at all (a kernel that
# rounds P elsewhere differs in about a third of them).
FLASH_BF16_CHANGED = 0.01


def _bf16_changed(got, want):
    return (got.float() != want.float()).float().mean().item()


def _flash_bf16_close(out, ref):
    diff = (out.float() - ref.float()).abs()
    row = ref.float().abs().amax(-1, keepdim=True)
    ulp = torch.ldexp(torch.ones_like(row), torch.frexp(row).exponent - 8)
    allowed = torch.maximum(1e-5 + 1.6e-2 * ref.float().abs(), 2 * ulp)
    assert (diff <= allowed).all(), (diff - allowed).max().item()
    assert _bf16_changed(out, ref) <= FLASH_BF16_CHANGED, _bf16_changed(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_flash_kernel_bf16_matches_plain(card, d):
    """bf16 in and out, P rounded to bf16 before P V as the TPU kernel
    rounds it, everything else f32: held by `_flash_bf16_close`."""
    q, k, v, ln = _inputs(4, 4, 257, 257, d, [257, 1, 100, 33], card,
                          torch.bfloat16)
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _flash_bf16_close(out, ref_out)
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
@pytest.mark.parametrize("n,block_k", [(197, 256), (261, 256), (785, 256),
                                       (785, 512), (197, 512)])
def test_flash_kernel_bf16_at_vit_shapes(card, n, block_k):
    """The ViT flash route's shapes (head_dim 64; UNI, Virchow2 and Kaiko-B/8
    token counts) with one key block or several, lengths 0, 1 and N."""
    q, k, v, ln = _inputs(4, 4, n, n, 64, [n, 1, 0, n // 3], card,
                          torch.bfloat16)
    before = tfa.masked_flash_attention_fwd.launches
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln, block_k)
    torch.cuda.synchronize()
    assert tfa.masked_flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln, block_k)
    _flash_bf16_close(out, ref_out)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    assert out[2].abs().max().item() == 0.0      # length 0: no valid key


@pytest.mark.cuda
@pytest.mark.parametrize("n", [81, 257])
def test_flash_kernel_f32_lengths_0_1_n(card, n):
    """The flagship's f32 shapes (head_dim 32) with lengths 0, 1 and N, and
    query rows past Nq's last full tile."""
    q, k, v, ln = _inputs(3, 4, n, n, 32, [0, 1, n], card)
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln, 128)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln, 128)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=0)
    assert out[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_kernel_refusals(card):
    """head_dim 48, mixed dtypes and a block_k that is no multiple of the
    kernel's 64-key tile raise; nothing falls back."""
    q, k, v, ln = _inputs(1, 2, 16, 16, 48, [16], card, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.masked_flash_attention_fwd(q, k, v, ln)
    q, k, v, ln = _inputs(1, 2, 16, 16, 64, [16], card, torch.bfloat16)
    with pytest.raises(TypeError):
        tfa.masked_flash_attention_fwd(q, k.float(), v, ln)
    with pytest.raises(ValueError, match="block_k"):
        tfa.masked_flash_attention_fwd(q, k, v, ln, 96)


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


def _bwd_inputs(b, h, nq, nk, d, lengths, device, dtype=torch.float32):
    """Forward through the kernel, plus a random upstream gradient."""
    q, k, v, ln = _inputs(b, h, nq, nk, d, lengths, device, dtype)
    out, lse = tfa.masked_flash_attention_fwd(q, k, v, ln)
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, h, nq, d)).astype(np.float32)).to(device, dtype)
    return q, k, v, ln, out, lse, dout


def _grad_close(got, want, rel=1e-5, rtol=0.0):
    scale = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), atol=rel * scale,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(257, 257, 32), (81, 81, 32),
                                     (37, 45, 32), (130, 130, 64),
                                     (70, 33, 64)])
def test_flash_backward_kernels_match_plain(card, nq, nk, d):
    """Lengths 0, 1, N and ragged; Nq != Nk; keys at or past the length get
    exactly zero dk/dv; the launch counters move by one each."""
    lengths = [nk, 1, 0, nk // 2, 7]
    args = _bwd_inputs(5, 4, nq, nk, d, lengths, card)
    before = (tfa.masked_flash_attention_bwd_dq.launches,
              tfa.masked_flash_attention_bwd_dkv.launches)
    got = tfa.masked_flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert (tfa.masked_flash_attention_bwd_dq.launches,
            tfa.masked_flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                             before[1] + 1)
    want = tfa.flash_attention_backward_reference(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g).all()
        _grad_close(g, w)
    dq, dk, dv = got
    for i, n in enumerate(lengths[1:], start=1):
        assert dk[i, :, n:].abs().max().item() == 0.0
        assert dv[i, :, n:].abs().max().item() == 0.0
    assert dq[2].abs().max().item() == 0.0     # length 0: no valid key


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64])
def test_flash_backward_kernels_bf16_match_plain(card, d):
    """bf16 in and out, f32 inside: the two differ by the final rounding to
    bf16 (rtol 1.6e-2, torch's bf16 default) and by summation order."""
    args = _bwd_inputs(4, 4, 129, 129, d, [129, 1, 0, 50], card,
                       torch.bfloat16)
    got = tfa.masked_flash_attention_bwd(*args)
    want = tfa.flash_attention_backward_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _grad_close(g, w, rel=1e-4, rtol=1.6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(81, 32), (257, 32), (129, 64)])
def test_flash_backward_bf16_rounds_ds_as_plain(card, n, d):
    """Kernels #2 and #3 round dS to bf16 before dS k and dS^T q, as the
    plain versions and the TPU kernels do (dv takes P unrounded): at most
    FLASH_BF16_CHANGED of the gradients differ at all. With one valid key
    dq and dk are 0 in exact arithmetic and both sides give rounding noise:
    that row is held to 1e-4 of zero instead."""
    args = _bwd_inputs(4, 4, n, n, d, [n, 1, 0, n // 3], card, torch.bfloat16)
    got = tfa.masked_flash_attention_bwd(*args)
    want = tfa.flash_attention_backward_reference(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if name != "dv":
            assert g[1].abs().max().item() <= 1e-4, name
            g, w = g[[0, 2, 3]], w[[0, 2, 3]]
        assert _bf16_changed(g, w) <= FLASH_BF16_CHANGED, name


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(32, torch.float32), (64, torch.float32),
                                     (64, torch.bfloat16)])
def test_flash_backward_is_deterministic(card, d, dtype):
    """No atomics: two calls give bitwise-equal gradients."""
    args = _bwd_inputs(8, 4, 257, 257, d, [257, 1, 100, 33, 0, 256, 2, 7],
                       card, dtype)
    first = tfa.masked_flash_attention_bwd(*args)
    second = tfa.masked_flash_attention_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# kernels #2 and #3 work in tiles of 32 rows (query rows or keys) and 32
# streamed rows: these shapes leave a ragged tile on each side
@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,d", [(31, 31, 32), (33, 33, 32), (95, 95, 32),
                                     (257, 257, 32), (33, 95, 32),
                                     (95, 31, 64), (257, 33, 64)])
def test_flash_backward_tiling(card, nq, nk, d):
    """N no multiple of 32, Nq != Nk with a ragged tail on either side, and
    lengths 0, 1, 2, 31, 32, 33 and N (capped at Nk): each gradient against
    the plain versions, dk and dv exactly 0 at keys past the length, dq
    exactly 0 for length 0."""
    lengths = [min(n, nk) for n in (0, 1, 2, 31, 32, 33, nk)]
    args = _bwd_inputs(len(lengths), 2, nq, nk, d, lengths, card)
    got = tfa.masked_flash_attention_bwd(*args)
    want = tfa.flash_attention_backward_reference(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        _grad_close(g, w)
    dq, dk, dv = got
    for i, n in enumerate(lengths):
        if n < nk:
            assert dk[i, :, n:].abs().max().item() == 0.0
            assert dv[i, :, n:].abs().max().item() == 0.0
    assert dq[0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(32, torch.float32), (64, torch.bfloat16)])
def test_flash_backward_never_reads_keys_past_the_length(card, d, dtype):
    """Padded bag rows may hold anything: with NaN in k and v past the
    length (and the forward's out and lse from the zero-filled inputs), the
    backward kernels' results equal those of the zero-filled run."""
    lengths = [95, 1, 0, 33, 40]
    q, k, v, ln, out, lse, dout = _bwd_inputs(5, 2, 95, 95, d, lengths, card,
                                              dtype)
    past = (torch.arange(95, device=card)[None, :]
            >= ln[:, None])[:, None, :, None]
    k_nan, v_nan = k.masked_fill(past, float("nan")), v.masked_fill(past, float("nan"))
    clean = tfa.masked_flash_attention_bwd(q, k, v, ln, out, lse, dout)
    dirty = tfa.masked_flash_attention_bwd(q, k_nan, v_nan, ln, out, lse, dout)
    for a, b in zip(dirty, clean):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(81, 32), (257, 32), (129, 64)])
def test_flash_backward_one_key_rows_give_exactly_zero(card, n, d):
    """In f32 a row of length 1 has dq and dk 0 in exact arithmetic, and the
    kernels give exactly 0: the forward's out is that key's v to the bit,
    so dP and delta are the same products summed in the same order, and dS
    = P (dP - delta) is exactly 0."""
    args = _bwd_inputs(3, 4, n, n, d, [1, n, 1], card)
    dq, dk, dv = tfa.masked_flash_attention_bwd(*args)
    for g in (dq, dk):
        assert g[0].abs().max().item() == 0.0 and g[2].abs().max().item() == 0.0
    assert dv[0, :, 0].abs().max().item() > 0.0


@pytest.mark.cuda
def test_mha_kernel_route_gradients_match_plain_route(card):
    """Under requires_grad the kernel route goes through the autograd
    Function (forward kernel once, both backward kernels once) and agrees
    with autograd through the plain route on the output, the input's
    gradient and every weight's gradient."""
    grads = {}
    for impl in ("pallas", "xla"):
        mha = MultiheadAttention(128, 4,
                                 generator=torch.Generator().manual_seed(0))
        mha = mha.to(card)
        x = torch.randn(8, 81, 128,
                        generator=torch.Generator().manual_seed(1)).to(card)
        x.requires_grad_(True)
        valid = torch.arange(81, device=card)[None] < torch.tensor(
            [81, 1, 40, 7, 81, 2, 60, 33], device=card)[:, None]
        before = [f.launches for f in (tfa.masked_flash_attention_fwd,
                                       tfa.masked_flash_attention_bwd_dq,
                                       tfa.masked_flash_attention_bwd_dkv)]
        y = mha(x, x, x, key_valid=valid, impl=impl)
        (y * torch.linspace(-1, 1, 128, device=card)).sum().backward()
        after = [f.launches for f in (tfa.masked_flash_attention_fwd,
                                      tfa.masked_flash_attention_bwd_dq,
                                      tfa.masked_flash_attention_bwd_dkv)]
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1, 1] if impl == "pallas" else [0, 0, 0])
        grads[impl] = {"y": y.detach(), "x": x.grad,
                       **{n: p.grad for n, p in mha.named_parameters()}}
    for name, want in grads["xla"].items():
        torch.testing.assert_close(grads["pallas"][name], want, atol=1e-4,
                                   rtol=0, msg=name)


# ----------------------------------------------------- fused ViT block kernels
# f32: kernel and plain version both accumulate in f32 (TF32 off) over up to
# 6912 terms in different orders: 1e-4 absolute on O(1)..O(10) outputs. bf16:
# both round at the same places, so they differ by single bf16 roundings of
# intermediates and of the output: 2 bf16 ulps of the largest output.
from paths_tpu_torch.kernels import vit_fused as tvf  # noqa: E402

VIT_F32_ATOL = 1e-4
VIT_SHAPES = [  # (B, N, D, heads, hidden): ragged small, UNI, Virchow2,
    # Kaiko-S/16, Kaiko-B/8 (785 tokens), and a length that is no multiple of
    # any tile
    (3, 50, 128, 2, 512), (2, 197, 1024, 16, 4096), (2, 261, 1280, 20, 6912),
    (2, 197, 384, 6, 1536), (2, 785, 768, 12, 3072), (3, 131, 128, 2, 512)]


def _vit_args(b, n, d, hidden, packed, dtype, device, ls=True):
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.normal(size=s) * scale).astype(np.float32)).to(device)
    return dict(
        x=f(b, n, d).to(dtype), ns=1.0 + 0.1 * f(d), nb=0.1 * f(d),
        qkv_w=f(3 * d, d, scale=d ** -0.5).to(dtype), qkv_b=0.1 * f(3 * d),
        proj_w=f(d, d, scale=d ** -0.5).to(dtype), proj_b=0.1 * f(d),
        fc1_w=f(packed * hidden, d, scale=d ** -0.5).to(dtype),
        fc1_b=0.1 * f(packed * hidden),
        fc2_w=f(d, hidden, scale=hidden ** -0.5).to(dtype), fc2_b=0.1 * f(d),
        ls=(1.0 + 0.1 * f(d)) if ls else None)


def _vit_close(got, want, dtype):
    tol = VIT_F32_ATOL if dtype == torch.float32 else \
        2 * 2.0 ** -8 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_attn_kernel_matches_plain(card, shape, dtype):
    b, n, d, heads, hidden = shape
    p = _vit_args(b, n, d, hidden, 1, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["qkv_b"], p["proj_w"],
            p["proj_b"], p["ls"])
    before = tvf.fused_attn_block.launches
    got = tvf.fused_attn_block(*args, num_heads=heads)
    torch.cuda.synchronize()
    assert tvf.fused_attn_block.launches == before + 1
    _vit_close(got, tvf.fused_attn_block_reference(*args, num_heads=heads), dtype)
    assert torch.equal(got, tvf.fused_attn_block(*args, num_heads=heads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact_gelu", [True, False])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_mlp_kernel_matches_plain(card, shape, exact_gelu, dtype):
    b, n, d, heads, hidden = shape
    p = _vit_args(b, n, d, hidden, 1, dtype, card, ls=exact_gelu)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    before = tvf.fused_mlp_block.launches
    got = tvf.fused_mlp_block(*args, exact_gelu=exact_gelu)
    torch.cuda.synchronize()
    assert tvf.fused_mlp_block.launches == before + 1
    _vit_close(got, tvf.fused_mlp_block_reference(*args, exact_gelu=exact_gelu),
               dtype)
    assert torch.equal(got, tvf.fused_mlp_block(*args, exact_gelu=exact_gelu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_swiglu_kernel_matches_plain(card, shape, dtype):
    b, n, d, heads, hidden = shape
    p = _vit_args(b, n, d, hidden, 2, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    before = tvf.fused_swiglu_mlp_block.launches
    got = tvf.fused_swiglu_mlp_block(*args)
    torch.cuda.synchronize()
    assert tvf.fused_swiglu_mlp_block.launches == before + 1
    _vit_close(got, tvf.fused_swiglu_mlp_block_reference(*args), dtype)
    assert torch.equal(got, tvf.fused_swiglu_mlp_block(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swiglu,shape", [
    # hidden 160: a multiple of 32 but not of the 64 hidden units of a gated
    # fc1 tile, so the last tile's gate and value boxes run past H
    (True, (3, 131, 128, 2, 160)),
    # D 4096: a (16, D) f32 accumulator in shared memory would take 256 KB,
    # more than a block has; the GEMMs do not depend on D
    (False, (2, 20, 4096, 64, 512)), (True, (2, 20, 4096, 64, 512))],
    ids=["swiglu-h160", "gelu-d4096", "swiglu-d4096"])
def test_vit_mlp_kernels_at_ragged_hidden_and_wide_d(card, swiglu, shape, dtype):
    b, n, d, heads, hidden = shape
    p = _vit_args(b, n, d, hidden, 2 if swiglu else 1, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    kernel, plain = (tvf.fused_swiglu_mlp_block, tvf.fused_swiglu_mlp_block_reference) \
        if swiglu else (tvf.fused_mlp_block, tvf.fused_mlp_block_reference)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _vit_close(got, plain(*args), dtype)
    assert torch.equal(got, kernel(*args))


@pytest.mark.cuda
def test_vit_kernels_refuse_what_they_do_not_take(card):
    p = _vit_args(2, 20, 128, 256, 1, torch.float32, card)
    attn = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["qkv_b"], p["proj_w"],
            p["proj_b"], p["ls"])
    with pytest.raises(ValueError, match="head_dim"):
        tvf.fused_attn_block(*attn, num_heads=4)
    with pytest.raises(TypeError, match="compute dtype"):
        tvf.fused_attn_block(p["x"].bfloat16(), *attn[1:], num_heads=2)
    with pytest.raises(ValueError, match="is on"):
        tvf.fused_attn_block(p["x"], p["ns"], p["nb"], p["qkv_w"].cpu(),
                             *attn[4:], num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        tvf.fused_attn_block(p["x"].transpose(0, 1), *attn[1:], num_heads=2)
    # 785 tokens (the patch-8 Kaiko models): taken, and held to the plain
    # version
    long = _vit_args(1, 785, 128, 256, 1, torch.float32, card)
    _vit_close(tvf.fused_attn_block(long["x"], *attn[1:], num_heads=2),
               tvf.fused_attn_block_reference(long["x"], *attn[1:], num_heads=2),
               torch.float32)
    with pytest.raises(ValueError, match="layout"):
        tvf.fused_mlp_block(p["x"], p["ns"], p["nb"], p["fc1_w"].T.contiguous(),
                            p["fc1_b"], p["fc2_w"], p["fc2_b"], p["ls"])
    with pytest.raises(ValueError, match="multiple of 32"):
        tvf.fused_mlp_block(p["x"], p["ns"], p["nb"], p["fc1_w"][:250],
                            p["fc1_b"][:250], p["fc2_w"][:, :250].contiguous(),
                            p["fc2_b"], p["ls"])


# ------------------------------------------------- head_dim 80 (Virchow2)
# (B, N, D, heads, hidden): Virchow2 as published (16 heads of 80, each
# SwiGLU branch 3416 held as 3456, 261 tokens), and a ragged small case
VIT_HD80_SHAPES = [(2, 261, 1280, 16, 3456), (3, 131, 320, 4, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VIT_HD80_SHAPES)
def test_vit_head_dim_80_kernels_match_plain(card, shape, dtype):
    """#4 at head_dim 80 and #6 at Virchow2's held width against their plain
    versions, one launch each, bitwise repeatable; the kernels that take
    head_dim 64 only (#7, #8, #1) refuse it."""
    b, n, d, heads, hidden = shape
    assert d // heads == 80
    p = _vit_args(b, n, d, hidden, 2, dtype, card)
    attn = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["qkv_b"], p["proj_w"],
            p["proj_b"], p["ls"])
    mlp = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
           p["fc2_b"], p["ls"])
    for kernel, plain, args, kw in (
            (tvf.fused_attn_block, tvf.fused_attn_block_reference, attn,
             dict(num_heads=heads)),
            (tvf.fused_swiglu_mlp_block, tvf.fused_swiglu_mlp_block_reference,
             mlp, {})):
        before = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        _vit_close(got, plain(*args, **kw), dtype)
        assert torch.equal(got, kernel(*args, **kw))
    with pytest.raises(ValueError, match="head_dim 80"):
        tvf.fused_block(p["x"], {"attn": {}, "mlp": {}}, num_heads=heads)
    with pytest.raises(ValueError, match="head_dim 80"):
        tvi.fused_attn_block_i8(p["x"], None, None, None, None, None, None,
                                num_heads=heads)
    q = p["x"].view(b, n, heads, 80).transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="head_dim 80"):
        tfa.masked_flash_attention_fwd(
            q, q, q, torch.full((b,), n, dtype=torch.int32, device=card))


# sha256 of kernel #4's output at UNI's shape (2 images, 197 tokens, 16
# heads of 64) on `_vit_args`' inputs, as the kernel gave it before it took
# head_dim 80 (an H100 with CUDA 12.8): the head-dim-64 instantiation is
# bitwise the earlier kernel
VIT_ATTN_HD64_SHA256 = {
    "float32": "f2ddb5cbf74d8997ba2b40405f293ed3e5e18508f41d79becde11eb138b2ff39",
    "bfloat16": "ce0f9faa5c654aceada3643f257eea9f7d2006640dc1646b852267005d2150a8"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attn_head_dim_64_bitwise_as_before(card, dtype):
    import hashlib

    p = _vit_args(2, 197, 1024, 4096, 1, dtype, card)
    got = tvf.fused_attn_block(p["x"], p["ns"], p["nb"], p["qkv_w"],
                               p["qkv_b"], p["proj_w"], p["proj_b"], p["ls"],
                               num_heads=16)
    raw = got.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    assert hashlib.sha256(raw).hexdigest() == \
        VIT_ATTN_HD64_SHA256[str(dtype).split(".")[1]]


# ------------------------------------------------- the whole block, one launch
def _block_tree(p, ls=True):
    tree = {"norm1": {"scale": p["ns"], "bias": p["nb"]},
            "attn": {k: p[k] for k in ("qkv_w", "qkv_b", "proj_w", "proj_b")},
            "norm2": {"scale": p["ns"].flip(0), "bias": p["nb"].flip(0)},
            "mlp": {k: p[k] for k in ("fc1_w", "fc1_b", "fc2_w", "fc2_b")}}
    if ls:
        tree["ls1"], tree["ls2"] = p["ls"], p["ls"].flip(0)
    return tree


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact_gelu", [True, False])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_block_kernel_matches_plain(card, shape, exact_gelu, dtype):
    """Kernel #7 at a ragged small shape and the encoders' shapes: one launch,
    none of the two-kernel route's; bitwise repeatable."""
    b, n, d, heads, hidden = shape
    p = _vit_args(b, n, d, hidden, 1, dtype, card, ls=exact_gelu)
    tree = _block_tree(p, ls=exact_gelu)
    before = (tvf.fused_block.launches, tvf.fused_attn_block.launches,
              tvf.fused_mlp_block.launches)
    got = tvf.fused_block(p["x"], tree, num_heads=heads, exact_gelu=exact_gelu)
    torch.cuda.synchronize()
    assert (tvf.fused_block.launches, tvf.fused_attn_block.launches,
            tvf.fused_mlp_block.launches) == (before[0] + 1, *before[1:])
    _vit_close(got, tvf.fused_block_reference(p["x"], tree, num_heads=heads,
                                              exact_gelu=exact_gelu), dtype)
    assert torch.equal(got, tvf.fused_block(p["x"], tree, num_heads=heads,
                                            exact_gelu=exact_gelu))


@pytest.mark.cuda
def test_vit_block_kernel_refusals(card):
    p = _vit_args(2, 20, 128, 256, 1, torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        tvf.fused_block(p["x"], _block_tree(p), num_heads=4)
    # 785 tokens and a width of 2048 are taken now (K and V stream in key
    # tiles; no tile of the block depends on D) and held to the plain version
    for shape, heads in (((1, 785, 128), 2), ((1, 20, 2048), 32)):
        q = _vit_args(*shape, 256, 1, torch.float32, card)
        _vit_close(tvf.fused_block(q["x"], _block_tree(q), num_heads=heads),
                   tvf.fused_block_reference(q["x"], _block_tree(q),
                                             num_heads=heads), torch.float32)
    tree = _block_tree(p)
    tree["mlp"] = dict(tree["mlp"], fc1_w=p["fc1_w"].bfloat16())
    with pytest.raises(TypeError, match="compute dtype"):
        tvf.fused_block(p["x"], tree, num_heads=2)


# -------------------------------------------------------- int8 block kernels
# Integer sums are exact and the LayerNorm before a quantisation is evaluated
# in f64, so kernel and plain version agree to f32 summation order except
# where a context or hidden value lands on the other side of a rounding
# boundary: that moves one int8 code and with it the row's outputs by up to
# one output quantum (`attn_output_quantum`, `mlp_output_quantum`) per code.
# Rows within the tight bar (1e-4 f32, 2 bf16 ulps): all but I8_FLIP_SHARE;
# no row beyond I8_LOOSE_QUANTA quanta; in bf16, where an output's ulp is
# above a quantum, at most I8_BF16_CHANGED of the output elements differ at
# all (both round the same f32 values).
from paths_tpu_torch.kernels import vit_int8 as tvi  # noqa: E402

I8_FLIP_SHARE = 0.02
I8_LOOSE_QUANTA = 8.0
I8_BF16_CHANGED = 0.01


def _i8_args(b, n, d, hidden, packed, dtype, device, ls=True):
    p = _vit_args(b, n, d, hidden, packed, dtype, device, ls)
    for k in ("qkv_w", "proj_w", "fc1_w", "fc2_w"):
        wq = tvi.quantize_weight(p[k].float().cpu())
        p[k] = {"q": wq["q"].to(device), "s": wq["s"].to(device)}
    return p


def _i8_close(got, want, dtype, quantum):
    tight = VIT_F32_ATOL if dtype == torch.float32 else \
        2 * 2.0 ** -8 * want.float().abs().max().item()
    diff = (got.float() - want.float()).abs()
    rows = diff.flatten(0, -2).amax(-1)
    share = (rows > tight).float().mean().item()
    worst = rows.max().item()
    assert share <= I8_FLIP_SHARE, (share, worst, tight)
    assert worst <= max(tight, I8_LOOSE_QUANTA * quantum), (worst, quantum)
    if dtype == torch.bfloat16:
        changed = (diff > 0).float().mean().item()
        assert changed <= I8_BF16_CHANGED, changed


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_attn_i8_kernel_matches_plain(card, shape, dtype):
    b, n, d, heads, hidden = shape
    p = _i8_args(b, n, d, hidden, 1, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["proj_w"], p["qkv_b"],
            p["proj_b"], p["ls"])
    before = tvi.fused_attn_block_i8.launches
    got = tvi.fused_attn_block_i8(*args, num_heads=heads)
    torch.cuda.synchronize()
    assert tvi.fused_attn_block_i8.launches == before + 1
    _i8_close(got, tvi.fused_attn_block_i8_reference(*args, num_heads=heads),
              dtype, tvi.attn_output_quantum(*args))
    assert torch.equal(got, tvi.fused_attn_block_i8(*args, num_heads=heads))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact_gelu,num_chunks", [(True, 1), (True, 2),
                                                   (False, 1)])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_mlp_i8_kernel_matches_plain(card, shape, exact_gelu, num_chunks,
                                         dtype):
    b, n, d, heads, hidden = shape
    p = _i8_args(b, n, d, hidden, 1, dtype, card, ls=exact_gelu)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    kw = dict(exact_gelu=exact_gelu, num_chunks=num_chunks)
    before = tvi.fused_mlp_block_i8.launches
    got = tvi.fused_mlp_block_i8(*args, **kw)
    torch.cuda.synchronize()
    assert tvi.fused_mlp_block_i8.launches == before + 1
    _i8_close(got, tvi.fused_mlp_block_i8_reference(*args, **kw), dtype,
              tvi.mlp_output_quantum(*args, exact_gelu=exact_gelu))
    assert torch.equal(got, tvi.fused_mlp_block_i8(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_chunks", [1, 2])
@pytest.mark.parametrize("shape", VIT_SHAPES)
def test_vit_swiglu_i8_kernel_matches_plain(card, shape, num_chunks, dtype):
    b, n, d, heads, hidden = shape
    p = _i8_args(b, n, d, hidden, 2, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    before = tvi.fused_swiglu_mlp_block_i8.launches
    got = tvi.fused_swiglu_mlp_block_i8(*args, num_chunks=num_chunks)
    torch.cuda.synchronize()
    assert tvi.fused_swiglu_mlp_block_i8.launches == before + 1
    _i8_close(got, tvi.fused_swiglu_mlp_block_i8_reference(
        *args, num_chunks=num_chunks), dtype,
        tvi.mlp_output_quantum(*args, swiglu=True))
    assert torch.equal(got, tvi.fused_swiglu_mlp_block_i8(
        *args, num_chunks=num_chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,num_chunks", [
    # chunks of 64 hidden columns: each ends inside a 128-column slab of the
    # fc2 GEMM, between two of its k32 steps
    ((3, 50, 128, 2, 512), 8),
    # 4500 rows: no multiple of the wrapper's row slab (MLP_SLAB_ROWS)
    ((3, 1500, 128, 2, 512), 1), ((3, 1500, 128, 2, 512), 2)],
    ids=["chunk64", "ragged-slab", "ragged-slab-2chunks"])
def test_vit_swiglu_i8_kernel_chunks_and_slabs(card, shape, num_chunks, dtype):
    b, n, d, heads, hidden = shape
    assert num_chunks == 8 or (b * n) % tvi.MLP_SLAB_ROWS
    p = _i8_args(b, n, d, hidden, 2, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    before = tvi.fused_swiglu_mlp_block_i8.launches
    got = tvi.fused_swiglu_mlp_block_i8(*args, num_chunks=num_chunks)
    torch.cuda.synchronize()
    assert tvi.fused_swiglu_mlp_block_i8.launches == before + 1
    _i8_close(got, tvi.fused_swiglu_mlp_block_i8_reference(
        *args, num_chunks=num_chunks), dtype,
        tvi.mlp_output_quantum(*args, swiglu=True))
    assert torch.equal(got, tvi.fused_swiglu_mlp_block_i8(
        *args, num_chunks=num_chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,exact_gelu,num_chunks", [
    # chunks of 64 hidden columns: each ends inside a 128-column slab of the
    # fc2 GEMM, between two of its k32 steps
    ((3, 50, 128, 2, 512), True, 8),
    # 4500 rows: no multiple of the wrapper's row slab (MLP_SLAB_ROWS)
    ((3, 1500, 128, 2, 512), True, 1), ((3, 1500, 128, 2, 512), True, 2),
    ((3, 1500, 128, 2, 512), False, 1)],
    ids=["chunk64", "ragged-slab", "ragged-slab-2chunks", "ragged-slab-tanh"])
def test_vit_mlp_i8_kernel_chunks_and_slabs(card, shape, exact_gelu,
                                            num_chunks, dtype):
    """Kernel #9 runs the pieces its plain version repeats to the bit, so the
    two are equal bit for bit, across chunks and row slabs."""
    b, n, d, heads, hidden = shape
    assert num_chunks == 8 or (b * n) % tvi.MLP_SLAB_ROWS
    p = _i8_args(b, n, d, hidden, 1, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
            p["fc2_b"], p["ls"])
    kw = dict(exact_gelu=exact_gelu, num_chunks=num_chunks)
    before = tvi.fused_mlp_block_i8.launches
    got = tvi.fused_mlp_block_i8(*args, **kw)
    torch.cuda.synchronize()
    assert tvi.fused_mlp_block_i8.launches == before + 1
    assert torch.equal(got, tvi.fused_mlp_block_i8_reference(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swiglu,shape", [
    # D 2048: LayerNorm rows longer than the LN-quant pass keeps in registers
    (False, (2, 20, 2048, 32, 512)), (True, (2, 20, 2048, 32, 512)),
    # hidden 12352: a span longer than the quantiser keeps in registers
    (True, (2, 20, 128, 2, 12352))], ids=["attn-d2048", "swiglu-d2048", "swiglu-h12352"])
def test_vit_i8_kernels_at_long_rows(card, swiglu, shape, dtype):
    b, n, d, heads, hidden = shape
    p = _i8_args(b, n, d, hidden, 2 if swiglu else 1, dtype, card)
    if swiglu:
        args = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
                p["fc2_b"], p["ls"])
        got = tvi.fused_swiglu_mlp_block_i8(*args)
        want = tvi.fused_swiglu_mlp_block_i8_reference(*args)
        quantum = tvi.mlp_output_quantum(*args, swiglu=True)
    else:
        args = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["proj_w"], p["qkv_b"],
                p["proj_b"], p["ls"])
        got = tvi.fused_attn_block_i8(*args, num_heads=heads)
        want = tvi.fused_attn_block_i8_reference(*args, num_heads=heads)
        quantum = tvi.attn_output_quantum(*args)
    torch.cuda.synchronize()
    _i8_close(got, want, dtype, quantum)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attn_i8_memory_at_785_tokens(card, dtype):
    """At Kaiko-B/8's 785 tokens one call allocates its output and the
    scratch that the wrapper documents (codes, qkv in the compute dtype, the
    f32 context): no K/V scratch, which took 2 x 788 rows x 72 values per
    (image, head)."""
    b, n, d, heads = 4, 785, 768, 12
    p = _i8_args(b, n, d, 3072, 1, dtype, card)
    args = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["proj_w"], p["qkv_b"],
            p["proj_b"], p["ls"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tvi.fused_attn_block_i8(*args, num_heads=heads)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    allowed = got.numel() * got.element_size() + \
        tvi.attn_i8_scratch_bytes(b, n, d, dtype)
    old_kv = b * heads * 2 * 788 * 72 * got.element_size()
    assert peak <= allowed + (1 << 20) < allowed + old_kv, (peak, allowed)
    _i8_close(got, tvi.fused_attn_block_i8_reference(*args, num_heads=heads),
              dtype, tvi.attn_output_quantum(*args))


@pytest.mark.cuda
def test_vit_i8_kernels_refuse_what_they_do_not_take(card):
    p = _i8_args(2, 20, 128, 256, 1, torch.float32, card)
    f = _vit_args(2, 20, 128, 256, 1, torch.float32, card)
    attn = (p["x"], p["ns"], p["nb"], p["qkv_w"], p["proj_w"], p["qkv_b"],
            p["proj_b"], p["ls"])
    with pytest.raises(ValueError, match="head_dim"):
        tvi.fused_attn_block_i8(*attn, num_heads=4)
    with pytest.raises(TypeError, match="quantized weight"):
        tvi.fused_attn_block_i8(p["x"], p["ns"], p["nb"], f["qkv_w"],
                                *attn[4:], num_heads=2)
    # 785 tokens: K and V stream in key tiles, the result is held to the
    # plain version
    long = _i8_args(1, 785, 128, 256, 1, torch.float32, card)
    args = (long["x"], *attn[1:])
    _i8_close(tvi.fused_attn_block_i8(*args, num_heads=2),
              tvi.fused_attn_block_i8_reference(*args, num_heads=2),
              torch.float32, tvi.attn_output_quantum(*args))
    mlp = (p["x"], p["ns"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
           p["fc2_b"], p["ls"])
    with pytest.raises(TypeError, match="quantized weight"):
        tvi.fused_mlp_block_i8(p["x"], p["ns"], p["nb"], p["fc1_w"],
                               p["fc1_b"], f["fc2_w"], p["fc2_b"], p["ls"])
    with pytest.raises(ValueError, match="must divide"):
        tvi.fused_mlp_block_i8(*mlp, num_chunks=3)
    with pytest.raises(ValueError, match="multiple of 64"):
        tvi.fused_mlp_block_i8(*mlp, num_chunks=8)
    with pytest.raises(ValueError, match="is on"):
        tvi.fused_mlp_block_i8(p["x"], p["ns"], p["nb"],
                               {k: v.cpu() for k, v in p["fc1_w"].items()},
                               *mlp[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["int8", "fused1"])
@pytest.mark.parametrize("swiglu", [False, True])
def test_vit_apply_routes_launch_their_kernels(card, impl, swiglu):
    """A small ViT on the card: the int8 route launches #8 and #9 or #10 per
    block, fused1 launches #7 per block or, for SwiGLU, #4 and #6."""
    from paths_tpu_torch.encoders import vit

    spec = vit.ViTSpec(img_size=64, patch_size=16, embed_dim=128, depth=2,
                       num_heads=2, mlp_ratio=2.0, swiglu=swiglu)
    model = vit.vit_init(0, spec)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 64, 64, 3)).astype(np.float32))
    want = vit.vit_apply(model, imgs, torch.float32, "xla")
    if impl == "int8":
        tvi.quantize_vit_blocks(model)
    fns = (tvf.fused_block, tvf.fused_attn_block, tvf.fused_mlp_block,
           tvf.fused_swiglu_mlp_block, tvi.fused_attn_block_i8,
           tvi.fused_mlp_block_i8, tvi.fused_swiglu_mlp_block_i8)
    before = [f.launches for f in fns]
    got = vit.vit_apply(model.to(card), imgs.to(card), torch.float32, impl)
    torch.cuda.synchronize()
    delta = [f.launches - b for f, b in zip(fns, before)]
    expect = {("int8", False): [0, 0, 0, 0, 2, 2, 0],
              ("int8", True): [0, 0, 0, 0, 2, 0, 2],
              ("fused1", False): [2, 0, 0, 0, 0, 0, 0],
              ("fused1", True): [0, 2, 0, 2, 0, 0, 0]}[(impl, swiglu)]
    assert delta == expect
    rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    assert rel < (5e-2 if impl == "int8" else 1e-4), rel


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_streaming_engine_matches_fused_at_flagship_width(card, tmp_path,
                                                          dropout):
    """`brca_paths_0` at full width (5 levels, K 20, 1024-d, trans_dim 128)
    on the kernel route, 8 synthetic slides: the streaming engine's loss,
    predictions and gradients equal the fused engine's (the same kernels on
    the same values), also under dropout from one generator seed; #1 and
    #2 / #3 launch once per decoder layer per level in each (dropout 0)."""
    import os

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import make_synthetic_store
    from paths_tpu_torch.engine.hierarchy import end2end_loss
    from paths_tpu_torch.engine.streaming import StreamingEngine
    from paths_tpu_torch.models.recursive import RecursiveModel

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.load(os.path.join(root, "models", "brca_paths_0"),
                      test_mode=True)
    cfg.attention_impl = "pallas"
    cfg.model_config.dropout = dropout
    ids = make_synthetic_store(str(tmp_path), cfg, num_slides=8,
                               base_hw=(6, 8), seed=0)
    ds = SlideDataset(ids, cfg, FeatureStore(str(tmp_path)))
    idx = list(range(8))
    bag, tables = collate_batch(ds, idx, level0_bucket=cfg.level0_bucket,
                                device=card)
    labels = {"survival_bin": torch.arange(8, device=card) % cfg.nbins,
              "censored": (torch.arange(8, device=card) % 3 == 0).int()}
    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0)).to(card)

    counters = (tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
                tfa.masked_flash_attention_bwd_dkv)
    before = [f.launches for f in counters]
    loss, aux = end2end_loss(model, cfg, bag, tables, labels, training=True,
                             generator=torch.Generator(card).manual_seed(3))
    loss.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}
    mid = [f.launches for f in counters]
    got_loss, pred, got = StreamingEngine(cfg, card).loss_and_grad(
        model, bag, [ds.slides[i].tables for i in idx], labels,
        generator=torch.Generator(card).manual_seed(3))
    torch.cuda.synchronize()
    after = [f.launches for f in counters]
    per = cfg.model_config.trans_layers * cfg.num_levels
    want_launches = [per] * 3 if dropout == 0 else [0] * 3
    assert [m - b for m, b in zip(mid, before)] == want_launches
    assert [a - m for a, m in zip(after, mid)] == want_launches
    torch.testing.assert_close(got_loss, loss.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(pred, aux["pred"].detach(), rtol=1e-6, atol=0)
    assert sorted(got) == sorted(want)
    scale = max(g.abs().max().item() for g in want.values())
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=0, atol=1e-6 * scale,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_remat_on_the_kernel_route_equals_no_remat(card, tmp_path, dropout):
    """`brca_paths_0` at full width on 8 synthetic slides, two train steps
    from one generator seed with `remat` on and off: losses, gradients and
    parameters equal to the bit (the kernels are deterministic); at dropout
    0 the recompute launches #1 a second time per decoder layer per level,
    #2 / #3 once; at 0.05 the plain route runs (as in JAX)."""
    import copy
    import os

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import make_synthetic_store
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import make_optimizer, make_step_fns

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.load(os.path.join(root, "models", "brca_paths_0"),
                      test_mode=True)
    cfg.attention_impl = "pallas"
    cfg.model_config.dropout = dropout
    ids = make_synthetic_store(str(tmp_path), cfg, num_slides=8,
                               base_hw=(6, 8), seed=0)
    ds = SlideDataset(ids, cfg, FeatureStore(str(tmp_path)))
    bag, tables = collate_batch(ds, list(range(8)),
                                level0_bucket=cfg.level0_bucket, device=card)
    labels = {"survival_bin": torch.arange(8, device=card) % cfg.nbins,
              "censored": (torch.arange(8, device=card) % 3 == 0).int()}
    counters = (tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd_dq,
                tfa.masked_flash_attention_bwd_dkv)
    per = cfg.model_config.trans_layers * cfg.num_levels
    runs = {}
    for remat in (False, True):
        c = copy.deepcopy(cfg)
        c.remat = remat
        model = RecursiveModel(c, generator=torch.Generator().manual_seed(0)).to(card)
        update, _ = make_step_fns(c, make_optimizer(c, model.parameters()))
        gen = torch.Generator(card).manual_seed(3)
        steps = []
        for _ in range(2):
            before = [f.launches for f in counters]
            loss, _ = update(model, bag, tables, labels, gen, epoch=1)
            torch.cuda.synchronize()
            launched = [f.launches - b for f, b in zip(counters, before)]
            want = [per * (1 + remat), per, per] if dropout == 0 else [0] * 3
            assert launched == want
            steps.append((loss.item(),
                          {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None},
                          {n: p.detach().clone() for n, p in model.named_parameters()}))
        runs[remat] = steps
    for (la, ga, pa), (lb, gb, pb) in zip(runs[False], runs[True]):
        assert la == lb
        assert sorted(ga) == sorted(gb)
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n
        for n in pa:
            assert torch.equal(pa[n], pb[n]), n


@pytest.mark.cuda
def test_heatmap_recursion_kernel_route_matches_plain(card, tmp_path):
    """`run_recursion` at flagship width over one small synthetic slide with
    a tiny encoder on the card (a pooled colour times a random 3 x 1024
    matrix): `attention_impl: "pallas"` (#1 once per decoder layer per depth)
    against the plain attention. Importances (which do not see the
    attention) and the final logits (which do) within 1e-4, the hazards' bar
    of the serving path (per-layer differences of 2e-5 through 2 layers a
    level); the same patches at every depth unless a top-K gap is under
    that."""
    import copy
    import os

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.viz.heatmap import run_recursion

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.load(os.path.join(root, "models", "brca_paths_0"),
                      test_mode=True)
    side = 8192                       # level 0 (0.625x of 10x): 2 x 2 patches
    rng = np.random.default_rng(0)
    img = rng.integers(240, 250, (side, side, 3), dtype=np.uint8)
    yy, xx = np.ogrid[0:side, 0:side]
    blob = ((yy - side // 2) ** 2 + (xx - side // 2) ** 2) < (0.45 * side) ** 2
    img[blob] = rng.integers(80, 160, (int(blob.sum()), 3), dtype=np.uint8)
    path = os.path.join(str(tmp_path), "slide.npy")
    np.save(path, img)
    w = torch.from_numpy(rng.normal(size=(3, 1024)).astype(np.float32)).to(card)

    def encode(x):
        return x.mean(dim=(1, 2)) @ w

    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0)).to(card).eval()
    out = {}
    for impl in ("pallas", "xla"):
        c = copy.deepcopy(cfg)
        c.attention_impl = impl
        before = tfa.masked_flash_attention_fwd.launches
        out[impl] = run_recursion(c, model, encode, path, tissue_threshold=0.1,
                                  camelyon=False, default_power=10.0,
                                  verbose=False, device=card)
        launched = tfa.masked_flash_attention_fwd.launches - before
        assert launched == (c.model_config.trans_layers * c.num_levels
                            if impl == "pallas" else 0)
    (ks, ki, kl), (ps, pi, pl) = out["pallas"], out["xla"]
    for depth, (a, b, ia, ib) in enumerate(zip(ks, ps, ki, pi)):
        if not np.array_equal(a.locs, b.locs):
            assert depth > 0
            top = np.sort(pi[depth - 1])[::-1]
            k = cfg.top_k_patches[depth - 1]
            assert top[k - 1] - top[k] < 1e-4
            break
        np.testing.assert_allclose(ia, ib, atol=1e-4, rtol=0)
    else:
        np.testing.assert_allclose(kl, pl, atol=1e-4, rtol=0)


def _resnet_mirror(arch, seed=0):
    from paths_tpu_torch.encoders import torch_mirror

    torch.manual_seed(seed)
    m = (torch_mirror.TorchResNet50() if arch == "resnet50"
         else torch_mirror.TorchResNet18()).eval()
    with torch.no_grad():
        for b in m.modules():
            if isinstance(b, torch.nn.BatchNorm2d):
                b.running_mean.uniform_(-0.2, 0.2)
                b.running_var.uniform_(0.5, 1.5)
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["resnet50", "resnet18"])
def test_resnet_on_the_card_matches_mirror(card, arch):
    """The converted resnet on the card (library convolutions, JAX's rounding
    points) against the torchvision-keyed mirror on the same card: f32 with
    TF32 off within 1e-4 of the largest feature, bf16 within 5e-2 of each
    feature's norm (the feature-grid bar)."""
    from paths_tpu_torch.encoders import resnet

    torch.backends.cudnn.allow_tf32 = False
    m = _resnet_mirror(arch)
    model = resnet.resnet_from_torchvision(
        {k: v.numpy() for k, v in m.state_dict().items()}, arch).to(card)
    imgs = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(8, 256, 256, 3)).astype(np.float32)).to(card)
    with torch.no_grad():
        want = m.to(card)(imgs.permute(0, 3, 1, 2))
    got = resnet.resnet_apply(model, imgs, torch.float32)
    assert got.shape == want.shape == (8, 2048 if arch == "resnet50" else 512)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    got16 = resnet.resnet_apply(model, imgs, torch.bfloat16)
    assert got16.dtype == torch.float32 and torch.isfinite(got16).all()
    rel = (got16 - want).norm(dim=-1) / want.norm(dim=-1)
    assert rel.max() <= 5e-2, rel.max()


@pytest.mark.cuda
def test_verify_vit_on_the_fused_route_and_planted_fault(card, monkeypatch):
    """`cli.verify_conversion.verify_vit` on the card for a small spec on the
    fused route (#4 and #5 once per block), in f32 against the mirror; then a
    converted model whose block-1 fc1 weight is scaled by 1.05 after
    conversion must fail the check."""
    from paths_tpu_torch.cli import verify_conversion as vc
    from paths_tpu_torch.encoders import torch_mirror, vit

    spec = vit.ViTSpec(img_size=64, patch_size=16, embed_dim=128, depth=3,
                       num_heads=2, mlp_ratio=4.0, layer_scale=True)
    torch.manual_seed(0)
    mirror = torch_mirror.timm_vit_mirror(spec).eval()
    with torch.no_grad():
        for blk in mirror.blocks:
            blk.ls1.gamma.fill_(1.0)
            blk.ls2.gamma.fill_(1.0)
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    imgs = np.random.default_rng(0).uniform(-1.5, 1.5, (4, 64, 64, 3)).astype(np.float32)
    before = (tvf.fused_attn_block.launches, tvf.fused_mlp_block.launches)
    res = vc.verify_vit("small", sd, imgs, spec=spec, device="cuda")
    assert (tvf.fused_attn_block.launches - before[0],
            tvf.fused_mlp_block.launches - before[1]) == (3, 3)
    assert res["max_abs"] <= 1e-4, res["max_abs"]
    convert = vc.vit_from_timm

    def faulty(sd_, spec_):
        model = convert(sd_, spec_)
        with torch.no_grad():
            model.blocks[1].fc1.weight.mul_(1.05)
        return model

    monkeypatch.setattr(vc, "vit_from_timm", faulty)
    bad = vc.verify_vit("small", sd, imgs, spec=spec, device="cuda")
    assert bad["max_abs"] > 1e-3, bad["max_abs"]


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d", [(257, 32), (81, 32), (130, 64)])
def test_export_flash_op_cuda_matches_plain(card, nq, d):
    """The operator `paths_torch::flash_attention_fwd` on CUDA tensors
    launches #1 once (its counter) and agrees with the plain version; its
    schema, fake implementation and dispatch pass `opcheck`."""
    q, k, v, ln = _inputs(4, 4, nq, nq, d, [nq, 1, nq // 2, 33], card)
    before = tfa.masked_flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, ln, 128)
    torch.cuda.synchronize()
    assert tfa.masked_flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, ln, 128)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=0)
    torch.library.opcheck(tfa.flash_attention_fwd, (q, k, v, ln, 128))


def _small_model_dir(root):
    """A 3-level model directory over a 6-slide synthetic store, on the
    kernel route (the port's config, no JAX)."""
    import os

    from paths_tpu_torch.config import Config, PATHSProcessorConfig
    from paths_tpu_torch.data.synthetic import make_synthetic_store
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.state import save_state

    mc = PATHSProcessorConfig(patch_embed_dim=32, trans_dim=32, trans_heads=1,
                              trans_layers=2, importance_mlp_hidden_dim=8,
                              hierarchical_ctx_mlp_hidden_dim=8)
    cfg = Config(model_config=mc, num_levels=3, top_k_patches=4, nbins=4,
                 level0_bucket=16, batch_size=4, attention_impl="pallas",
                 preprocess_dir=os.path.join(root, "store"))
    make_synthetic_store(cfg.preprocess_dir, cfg, num_slides=6,
                         base_hw=(3, 4), seed=1)
    d = os.path.join(root, "model")
    cfg.save(d)
    save_state(d, RecursiveModel(cfg,
                                 generator=torch.Generator().manual_seed(0)))
    return d, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("freeze", [False, True])
def test_export_cuda_artifact_launches_flash(card, tmp_path, freeze):
    """A CUDA serving program: its graph names the operator once per decoder
    layer per level, a request through `ServingSession(artifact=...)`
    launches #1 that often, and its hazards equal the live session's."""
    from paths_tpu_torch import export as texport
    from paths_tpu_torch.data.dataset import collate_batch
    from paths_tpu_torch.serve import ServingSession

    d, cfg = _small_model_dir(str(tmp_path))
    live = ServingSession(d, device="cuda", cache_batches=0)
    bag, tables = collate_batch(live._dataset, [0, 1, 2, 3],
                                level0_bucket=cfg.level0_bucket,
                                pads=live._pads, device="cuda")
    blob = texport.export_serving(cfg, live.model, bag, tables,
                                  freeze_params=freeze)
    path = str(tmp_path / "a.pt2z")
    with open(path, "wb") as f:
        f.write(blob)
    exp = texport.load_serving(blob)
    per = cfg.num_levels * cfg.model_config.trans_layers
    assert exp.platforms == ["cuda"]
    assert sum("paths_torch.flash_attention_fwd" in str(n.target)
               for n in exp.program().graph.nodes) == per
    sess = ServingSession(d, artifact=path, device="cuda", cache_batches=0)
    ids = live.slide_ids[:4]
    before = tfa.masked_flash_attention_fwd.launches
    got = sess.predict(ids)
    assert tfa.masked_flash_attention_fwd.launches == before + per
    want = live.predict(ids)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["hazards"], b["hazards"], atol=TOL,
                                   rtol=0)


@pytest.mark.cuda
def test_orbax_roundtrip_of_a_cuda_model(card, tmp_path):
    """`save_state(backend="orbax")` of a model and AdamW state on the card,
    read back into fresh ones on the card equal to the bit."""
    from paths_tpu_torch import convert
    from paths_tpu_torch.train import loop as tloop
    from paths_tpu_torch.train import state as tstate

    d, cfg = _small_model_dir(str(tmp_path))
    model = tloop.RecursiveModel(cfg).to(card)
    opt = tloop.make_optimizer(cfg, model.parameters())
    sum(p.sum() for p in model.parameters()).backward()
    opt.step()
    tstate.save_state(d, model, opt, {"epoch": 2}, backend="orbax")
    back = tloop.RecursiveModel(cfg).to(card)
    back_opt = tloop.make_optimizer(cfg, back.parameters())
    _, _, stats = tstate.load_state(d, back, back_opt,
                                    checkpoint_backend="orbax")
    assert stats["epoch"] == 2
    for got, want in ((convert.to_jax_flat(back), convert.to_jax_flat(model)),
                      (tstate.optimizer_to_jax_flat(back, back_opt),
                       tstate.optimizer_to_jax_flat(model, opt))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _dp_step_job(d, cfg):
    """A one-step job for `helpers_torch_dp`: 6 slides, the last padding."""
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.serve import store_slide_ids

    ids = store_slide_ids(FeatureStore(cfg.preprocess_dir), cfg.base_power)
    labels = {"survival_bin": [1, 3, 0, 2, 2, 1],
              "censored": [0, 1, 0, 0, 1, 0], "weight": [1, 1, 1, 1, 1, 0]}
    return {"kind": "step", "name": "step", "dir": d, "ids": ids,
            "idx": list(range(6)), "labels": labels}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_dp_step_matches_one_process(card, tmp_path, backend):
    """One data-parallel AdamW step of two ranks on the kernel route, from
    the same weights as one process's step on the whole batch: the ranks'
    losses add up to its loss within 1e-6 relative, the parameters agree
    within 1e-6 (a key bias within 2 lr, its gradient being rounding noise),
    and both ranks hold the same parameters to the bit. gloo runs both
    ranks on cuda:0 (NCCL refuses two ranks on one card); NCCL one rank per
    card."""
    from helpers_torch_dp import launch
    from paths_tpu_torch import convert
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train import loop as tloop
    from paths_tpu_torch.train import state as tstate

    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL takes one rank per card: this host has fewer than "
                    "two cards")
    d, cfg = _small_model_dir(str(tmp_path))
    job = _dp_step_job(d, cfg)
    device = "cuda:0" if backend == "gloo" else "cuda"
    ranks = launch((2, [job], str(tmp_path / "out")), device=device,
                   backend=backend)[0]
    got = [dict(np.load(str(tmp_path / "out" / f"step_rank{r}.npz")))
           for r in range(2)]
    for k, v in got[0].items():
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)

    model = RecursiveModel(cfg).to(card)
    opt = tloop.make_optimizer(cfg, model.parameters())
    model, opt, _ = tstate.load_state(d, model, opt)
    store = FeatureStore(cfg.preprocess_dir)
    ds = tdata.SlideDataset(job["ids"], cfg, store)
    bag, tables = tdata.collate_batch(ds, job["idx"], level0_bucket=32,
                                      pads=ds.global_pads(), device=card)
    labels = {k: torch.tensor(v, device=card) for k, v in job["labels"].items()}
    before = tfa.masked_flash_attention_bwd_dq.launches
    loss, _ = tloop.make_step_fns(cfg, opt)[0](model, bag, tables, labels,
                                                epoch=1)
    torch.cuda.synchronize()
    assert tfa.masked_flash_attention_bwd_dq.launches > before
    np.testing.assert_allclose(sum(r["step"]["loss"] for r in ranks),
                               loss.item(), rtol=1e-6)
    for k, want in convert.to_jax_flat(model).items():
        atol = 2 * cfg.lr if k.endswith("/k/b") else 1e-6
        np.testing.assert_allclose(got[0][k], want, rtol=0, atol=atol,
                                   err_msg=k)


def _two_devices(cards: int):
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards: this host has "
                    f"{torch.cuda.device_count()}")
    return ["cuda:0", "cuda:0"] if cards == 1 else ["cuda:0", "cuda:1"]


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 2])
def test_dp_session_two_shards(card, tmp_path, cards):
    """A two-shard `ServingSession`, both shards on cuda:0 or one per card,
    gives the hazards of one device serving each shard as a batch, to the
    bit, the one-device session's at the full batch within 1e-6, and
    launches #1 once per decoder layer per level for each shard."""
    from paths_tpu_torch.parallel.mesh import make_mesh
    from paths_tpu_torch.serve import ServingSession

    devices = _two_devices(cards)
    d, cfg = _small_model_dir(str(tmp_path))
    one = ServingSession(d, batch_size=4, cache_batches=0)
    two = ServingSession(d, batch_size=4, cache_batches=0,
                         mesh=make_mesh(devices=devices))
    ids = one.slide_ids
    want = [r["hazards"] for r in one.predict(ids)]
    before = tfa.masked_flash_attention_fwd.launches
    got = [r["hazards"] for r in two.predict(ids[:4])]
    torch.cuda.synchronize()
    per = cfg.model_config.trans_layers * cfg.num_levels
    assert tfa.masked_flash_attention_fwd.launches - before == 2 * per
    np.testing.assert_allclose(np.asarray(got), np.asarray(want[:4]),
                               rtol=1e-6, atol=0)
    halves = ServingSession(d, batch_size=2, cache_batches=0)
    assert [r["hazards"] for r in halves.predict(ids[:4])] == got


@pytest.mark.cuda
@pytest.mark.parametrize("cards,impl", [(1, "fused"), (2, "fused"),
                                        (2, "int8")])
def test_dp_preprocess_shards(card, tmp_path, cards, impl):
    """`process_slides` over two shards with Kaiko-S/16 (built once by
    `from_name(mesh=...)`, its weights or int8 codes copied to each card)
    gives the one-device grids to the bit: every row of the block kernels
    is independent of the batch's other rows."""
    import os

    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.encoders.registry import from_name
    from paths_tpu_torch.parallel.mesh import make_mesh
    from paths_tpu_torch.preprocess.pipeline import process_slides

    devices = _two_devices(cards)
    rng = np.random.default_rng(0)
    img = rng.integers(230, 250, (896, 896, 3), dtype=np.uint8)
    img[100:800, 150:700] = rng.integers(60, 160, (700, 550, 3), dtype=np.uint8)
    path = os.path.join(str(tmp_path), "s0.npy")
    np.save(path, img)
    kw = dict(patch_size=224, batch_size=8, default_power=10.0)
    grids = {}
    for name, mesh in (("one", None), ("two", make_mesh(devices=devices))):
        enc, dim, _ = from_name("kaiko-vits16", block_impl=impl, mesh=mesh)
        if mesh is not None:
            assert len(enc) == 2
        store = FeatureStore(os.path.join(str(tmp_path), name), create=True)
        process_slides([(path, "s0")], enc, dim, [10.0, 5.0], store,
                       mesh=mesh, **kw)
        grids[name] = [np.asarray(store.load("s0", p)) for p in (10.0, 5.0)]
    assert np.abs(grids["one"][0]).max() > 0
    for a, b in zip(grids["two"], grids["one"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- sequence parallelism

def _seq_layout(backend: str, world: int):
    """(device of every rank, skip reason or None): gloo puts every rank on
    cuda:0, NCCL one rank per card."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        return None, (f"NCCL takes one rank per card: {world} ranks, "
                      f"{torch.cuda.device_count()} card(s)")
    return ("cuda:0" if backend == "gloo" else "cuda"), None


@pytest.mark.cuda
@pytest.mark.parametrize("backend,sp", [("gloo", 2), ("nccl", 2),
                                        ("nccl", 4)])
def test_seq_attention_schedules_match_one_device(card, tmp_path, backend,
                                                  sp):
    """Both sequence-parallel schedules on #1-#3 over `sp` ranks, against
    the one-device kernels on the whole sequence (B 2, H 2, N 256, D 32,
    lengths 256 and 141: the valid keys end inside a block): outputs on
    valid rows at TOL, gradients within 1e-5 of the largest; the ring in
    bf16 within 5e-2 of the f32 kernel, its output bf16."""
    import os

    from helpers_torch_dp import launch

    device, reason = _seq_layout(backend, sp)
    if reason:
        pytest.skip(reason)
    q, k, v, lengths = _inputs(2, 2, 256, 256, 32, [256, 141], card)
    w = torch.from_numpy(np.random.default_rng(9).normal(
        size=q.shape).astype(np.float32)).to(card)
    valid = torch.arange(256, device=card)[None] < lengths[:, None]
    w = torch.where(valid[:, None, :, None], w, 0.0)
    inputs = os.path.join(str(tmp_path), "inputs.npz")
    np.savez(inputs, **{n: t.cpu().numpy() for n, t in
                        dict(q=q, k=k, v=v, lengths=lengths, w=w).items()})
    job = {"kind": "seq_attn", "name": "attn", "dir": str(tmp_path),
           "inputs": inputs, "block_k": 128}
    launch((sp, [job], str(tmp_path / "out")), device=device,
           backend=backend)
    blocks = [dict(np.load(str(tmp_path / "out" / f"attn_rank{r}.npz")))
              for r in range(sp)]
    got = {key: np.concatenate([b[key] for b in blocks], axis=2)
           for key in blocks[0]}
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.masked_flash_attention(qg, kg, vg, lengths, 128)
    (out * w).sum().backward()
    ok = valid.cpu().numpy()
    for impl in ("gathered", "ring"):
        mine = got[f"{impl}_out"].transpose(0, 2, 1, 3)[ok]
        ref = out.detach().cpu().numpy().transpose(0, 2, 1, 3)[ok]
        np.testing.assert_allclose(mine, ref, atol=TOL, err_msg=impl)
        for name, t in zip(("dq", "dk", "dv"), (qg, kg, vg)):
            _grad_close(torch.from_numpy(got[f"{impl}_{name}"]), t.grad.cpu())
    bf = got["ring_bf16_out"].transpose(0, 2, 1, 3)[ok]
    np.testing.assert_allclose(bf, ref, atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,mesh_shape,schedule", [
    ("gloo", [1, 2], "gathered"), ("gloo", [1, 2], "ring"),
    ("nccl", [1, 2], "ring"), ("nccl", [2, 2], "gathered"),
    ("nccl", [2, 2], "ring")])
def test_seq_step_matches_one_process(card, tmp_path, backend, mesh_shape,
                                      schedule):
    """One sequence-parallel AdamW step on the kernel route from JAX's seed-0
    initial weights against one process's step on the whole batch: the data
    indices' losses add up to
    its loss within 1e-6 relative, the world-summed gradients agree with its
    gradients within 1e-4 of each tensor's largest (a key bias, whose
    gradient is rounding noise, of the model's largest: AdamW's first step
    is nearly blind to a gradient's scale, so this is what sees a wrong
    1 / sp loss scale), the parameters agree within 1e-6 (a key bias within
    2 lr), and every rank holds the same parameters and gradients to the
    bit."""
    from helpers_torch_dp import launch
    from paths_tpu_torch import convert
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train import loop as tloop
    from paths_tpu_torch.train import state as tstate

    from paths_tpu_torch.models.jax_init import fresh_model

    world = mesh_shape[0] * mesh_shape[1]
    device, reason = _seq_layout(backend, world)
    if reason:
        pytest.skip(reason)
    d, cfg = _small_model_dir(str(tmp_path))
    # JAX's seed-0 initial weights: what a new run trains from
    tstate.save_state(d, fresh_model(cfg, 0))
    seq_cfg = Config.load(d)
    seq_cfg.mesh_shape, seq_cfg.seq_attention = mesh_shape, schedule
    seq_cfg.save(d)
    job = dict(_dp_step_job(d, cfg), grads=True)
    ranks = launch((world, [job], str(tmp_path / "out")), device=device,
                   backend=backend)[0]
    got = [dict(np.load(str(tmp_path / "out" / f"step_rank{r}.npz")))
           for r in range(world)]
    for r in range(1, world):
        for k, v in got[0].items():
            np.testing.assert_array_equal(got[r][k], v, err_msg=f"{r} {k}")

    model = RecursiveModel(cfg).to(card)
    opt = tloop.make_optimizer(cfg, model.parameters())
    model, opt, _ = tstate.load_state(d, model, opt)
    ds = tdata.SlideDataset(job["ids"], cfg, FeatureStore(cfg.preprocess_dir))
    bag, tables = tdata.collate_batch(ds, job["idx"], level0_bucket=32,
                                      pads=ds.global_pads(), device=card)
    labels = {k: torch.tensor(v, device=card) for k, v in job["labels"].items()}
    loss, _ = tloop.make_step_fns(cfg, opt)[0](model, bag, tables, labels,
                                                epoch=1)
    np.testing.assert_allclose(
        sum(r["step"]["loss"] for r in ranks if r["step"]["seq_index"] == 0),
        loss.item(), rtol=1e-6)
    for k, want in convert.to_jax_flat(model).items():
        atol = 2 * cfg.lr if k.endswith("/k/b") else 1e-6
        np.testing.assert_allclose(got[0][k], want, rtol=0, atol=atol,
                                   err_msg=k)
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    assert sorted("grad/" + n for n in grads) == sorted(
        k for k in got[0] if k.startswith("grad/"))
    largest = max(np.abs(g).max() for g in grads.values())
    for n, want in grads.items():
        ref = np.abs(want).max()
        if n.endswith(".k.bias") or ref == 0:
            ref = largest
        np.testing.assert_allclose(got[0]["grad/" + n], want, rtol=0,
                                   atol=1e-4 * ref, err_msg=n)


# The bf16 configuration across processes: one AdamW step under a data or
# (data x model) mesh against one process's bf16 step on the same batch from
# JAX's seed-0 weights. The losses to 4u relative (u = 2^-8), each gradient
# tensor's distance from one process's to 5e-2 of its `_grad_norm_scale`
# (chip_smoke.py's SEQ_BF16_STEP_NORM: elementwise, whole-model gradients
# are no yardstick in bf16), and every rank's parameters and gradients equal
# to the bit.
def _grad_norm_scale(grads, name):
    """What a gradient tensor's distance from another is a share of: its
    norm; a key bias's (zero in exact arithmetic), the model's largest
    gradient norm; a query or key projection's, its attention block's
    largest (their cotangents pass through the softmax's centring, dS =
    P (dP - delta), so they are small beside v's and out's while their
    rounding is the block's: the ring at sp 4 rounds P against four blocks'
    maxima, as JAX's does, and the q weights then part from one process's by
    1.14 x 5e-2 of their own norm)."""
    if name.endswith(".k.bias"):
        return max(np.linalg.norm(g) for g in grads.values())
    block, proj, _ = name.rsplit(".", 2)
    if proj in ("q", "k") and block.endswith("attn"):
        return max(np.linalg.norm(g) for n, g in grads.items()
                   if n.startswith(block + "."))
    return np.linalg.norm(grads[name])


def _bf16_mesh_step(card, tmp_path, backend, mesh_shape, schedule):
    from helpers_torch_dp import launch
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.models.jax_init import fresh_model
    from paths_tpu_torch.train import loop as tloop
    from paths_tpu_torch.train import state as tstate

    world = mesh_shape[0] * (mesh_shape[1] if len(mesh_shape) > 1 else 1)
    device, reason = _seq_layout(backend, world)
    if reason:
        pytest.skip(reason)
    d, cfg = _small_model_dir(str(tmp_path))
    cfg.compute_dtype = cfg.table_dtype = "bfloat16"
    tstate.save_state(d, fresh_model(cfg, 0))
    mesh_cfg = Config.load(d)
    mesh_cfg.compute_dtype = mesh_cfg.table_dtype = "bfloat16"
    mesh_cfg.mesh_shape, mesh_cfg.seq_attention = mesh_shape, schedule
    mesh_cfg.save(d)
    job = dict(_dp_step_job(d, cfg), grads=True)
    ranks = launch((world, [job], str(tmp_path / "out")), device=device,
                   backend=backend)[0]
    got = [dict(np.load(str(tmp_path / "out" / f"step_rank{r}.npz")))
           for r in range(world)]
    for r in range(1, world):
        for k, v in got[0].items():
            np.testing.assert_array_equal(got[r][k], v, err_msg=f"{r} {k}")

    model = fresh_model(cfg, 0).to(card)
    opt = tloop.make_optimizer(cfg, model.parameters())
    ds = tdata.SlideDataset(job["ids"], cfg, FeatureStore(cfg.preprocess_dir))
    bag, tables = tdata.collate_batch(ds, job["idx"], level0_bucket=32,
                                      pads=ds.global_pads(), device=card)
    assert bag.fts.dtype == torch.bfloat16
    labels = {k: torch.tensor(v, device=card) for k, v in job["labels"].items()}
    loss, _ = tloop.make_step_fns(cfg, opt)[0](model, bag, tables, labels,
                                                epoch=1)
    np.testing.assert_allclose(
        sum(r["step"]["loss"] for r in ranks if r["step"]["seq_index"] == 0),
        loss.item(), rtol=4 * BF16_U)
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    assert sorted("grad/" + n for n in grads) == sorted(
        k for k in got[0] if k.startswith("grad/"))
    for n, want in grads.items():
        dist = np.linalg.norm(got[0]["grad/" + n] - want)
        assert dist <= 5e-2 * max(_grad_norm_scale(grads, n), 1e-30), n
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_dp_bf16_step_matches_one_process(card, tmp_path, backend):
    """The bf16 step under [2] (`_bf16_mesh_step`)."""
    _bf16_mesh_step(card, tmp_path, backend, [2], "gathered")


@pytest.mark.cuda
@pytest.mark.parametrize("backend,mesh_shape,schedule", [
    ("gloo", [1, 2], "gathered"), ("gloo", [1, 2], "ring"),
    ("nccl", [1, 2], "ring"), ("nccl", [1, 4], "ring"),
    ("nccl", [2, 2], "gathered"), ("nccl", [2, 2], "ring")])
def test_seq_bf16_step_matches_one_process(card, tmp_path, backend,
                                           mesh_shape, schedule):
    """The bf16 step under [1, 2], [1, 4] and [2, 2] on both schedules
    (`_bf16_mesh_step`)."""
    _bf16_mesh_step(card, tmp_path, backend, mesh_shape, schedule)


# The flagship in the JAX package's bf16 configuration (`compute_dtype` and
# `table_dtype` "bfloat16"). u = 2^-8: hazards, kernel route vs plain route,
# to 4u (the routes round P at different points, an attention output moves
# by about an ulp, a hazard by at most u per such change; chip_smoke.py's
# BF16_PRED_ATOL); the streaming engine to the fused one's bits; and every
# launch of one step against its plain version on the same inputs: outputs
# at the flash bf16 bar, dq, dk, dv to 4u of their own largest (whole-model
# gradients are no yardstick in bf16: ReLU masks and cancelling sums move by
# many ulps when an attention output moves by one).
BF16_U = 2.0 ** -8


def _bf16_flagship(tmp_path, card):
    import os

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import make_synthetic_store

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.load(os.path.join(root, "models", "brca_paths_0"),
                      test_mode=True)
    cfg.attention_impl = "pallas"
    cfg.model_config.dropout = 0.0
    cfg.compute_dtype = cfg.table_dtype = "bfloat16"
    cfg.batch_size = [8]
    cfg.preprocess_dir = str(tmp_path / "store")
    ids = make_synthetic_store(cfg.preprocess_dir, cfg, num_slides=8,
                               base_hw=(6, 8), seed=0)
    ds = SlideDataset(ids, cfg, FeatureStore(cfg.preprocess_dir))
    bag, tables = collate_batch(ds, range(8), level0_bucket=cfg.level0_bucket,
                                device=card)
    return cfg, ids, bag, tables


@pytest.mark.cuda
def test_bf16_model_sessions_kernel_vs_plain_and_engines(card, tmp_path):
    """A bf16 request of 8 slides at flagship width: the kernel route's
    hazards within 4u of the plain route's, the streaming session's equal to
    the fused session's to the bit, #1 launched once per decoder layer per
    level."""
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.serve import ServingSession
    from paths_tpu_torch.train.state import save_state

    cfg, ids, _, _ = _bf16_flagship(tmp_path, card)
    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0))
    hazards = {}
    for impl, engine in (("pallas", "fused"), ("xla", "fused"),
                         ("pallas", "streaming")):
        cfg.attention_impl, cfg.engine = impl, engine
        d = str(tmp_path / f"{impl}_{engine}")
        cfg.save(d)
        save_state(d, model)
        sess = ServingSession(d, cache_batches=0, device=card)
        before = tfa.masked_flash_attention_fwd.launches
        hazards[impl, engine] = np.array([r["hazards"] for r in sess.predict(ids)])
        torch.cuda.synchronize()
        launched = tfa.masked_flash_attention_fwd.launches - before
        per = cfg.model_config.trans_layers * cfg.num_levels
        assert launched == (per if impl == "pallas" else 0), (impl, engine)
    kernel = hazards["pallas", "fused"]
    assert np.all((kernel > 0) & (kernel < 1))
    assert np.abs(kernel - hazards["xla", "fused"]).max() <= 4 * BF16_U
    np.testing.assert_array_equal(hazards["pallas", "streaming"], kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "dk zeroed", "dq scaled by 1.05"])
def test_bf16_model_step_launches_match_plain_versions(card, tmp_path,
                                                       monkeypatch, fault):
    """One bf16 training step at flagship width on the kernel route: #1-#3
    launch once per decoder layer per level, each forward launch is within
    the flash bf16 bar of its plain version and each backward launch's dq,
    dk, dv within 4u of the plain versions' own largest on the same inputs;
    a planted fault in the backward's results must fail that check; the
    parameters stay f32."""
    from paths_tpu_torch.engine.hierarchy import end2end_loss
    from paths_tpu_torch.models.recursive import RecursiveModel

    cfg, _, bag, tables = _bf16_flagship(tmp_path, card)
    labels = {"survival_bin": torch.arange(8, device=card) % cfg.nbins,
              "censored": (torch.arange(8, device=card) % 3 == 0).int()}
    model = RecursiveModel(cfg, generator=torch.Generator().manual_seed(0)).to(card)
    faults = {"dk zeroed": lambda dq, dk, dv: (dq, dk * 0, dv),
              "dq scaled by 1.05": lambda dq, dk, dv: (dq * 1.05, dk, dv)}
    fwd, bwd = tfa.masked_flash_attention_fwd, tfa.masked_flash_attention_bwd
    log = {"fwd": [], "bwd": []}

    class Recorded:
        """Records each call; the wrapper counts its launches through its
        module name, so `launches` reads and writes the wrapped one's."""

        def __init__(self, fn, key, post=None):
            self.fn, self.key, self.post = fn, key, post

        def __call__(self, *args):
            out = self.fn(*args)
            if self.post:
                out = self.post(*out)
            log[self.key].append((args, out))
            return out

        launches = property(lambda self: self.fn.launches,
                            lambda self, n: setattr(self.fn, "launches", n))

    monkeypatch.setattr(tfa, "masked_flash_attention_fwd", Recorded(fwd, "fwd"))
    monkeypatch.setattr(tfa, "masked_flash_attention_bwd",
                        Recorded(bwd, "bwd", faults.get(fault)))
    before = [f.launches for f in (fwd, tfa.masked_flash_attention_bwd_dq,
                                   tfa.masked_flash_attention_bwd_dkv)]
    loss, _ = end2end_loss(model, cfg, bag, tables, labels)
    loss.backward()
    torch.cuda.synchronize()
    after = [f.launches for f in (fwd, tfa.masked_flash_attention_bwd_dq,
                                  tfa.masked_flash_attention_bwd_dkv)]
    per = cfg.model_config.trans_layers * cfg.num_levels
    assert [a - b for a, b in zip(after, before)] == [per] * 3
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for (q, k, v, ln, block_k), (out, _) in log["fwd"]:
        _flash_bf16_close(out, tfa.flash_attention_reference(q, k, v, ln,
                                                             block_k)[0])
    worst = 0.0
    for (q, k, v, ln, out, lse, dout), grads in log["bwd"]:
        dq, delta = tfa.flash_bwd_dq_reference(q, k, v, ln, out, lse, dout)
        want = (dq, *tfa.flash_bwd_dkv_reference(q, k, v, ln, lse, dout, delta))
        for g, w in zip(grads, want):
            worst = max(worst, ((g.float() - w.float()).abs().max()
                                / (4 * BF16_U * w.float().abs().max())).item())
    assert (worst > 1.0) == (fault is not None), worst


# Collation without a host stack: each held slide's features are copied from
# a page-locked copy straight into its row of the batch on the card. The
# flagship's width (1024-d, 5 levels) on small synthetic slides.
@pytest.fixture(scope="module")
def collate_stores(tmp_path_factory):
    """Flagship-width 6-slide stores: "f16", "f32", and "mixed" (f32, but
    slides 1 and 4 f16)."""
    import os

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.data.synthetic import make_synthetic_store

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.load(os.path.join(root, "models", "brca_paths_0"),
                      test_mode=True)
    stores = {}
    for name in ("f16", "f32", "mixed"):
        d = str(tmp_path_factory.mktemp(f"collate_{name}"))
        ids = make_synthetic_store(
            d, cfg, num_slides=6, base_hw=(2, 3), seed=7,
            store_dtype=np.float16 if name == "f16" else np.float32)
        if name == "mixed":
            fs = FeatureStore(d)
            for sid in (ids[1], ids[4]):
                for power in cfg.power_levels():
                    fs.save(sid, power,
                            np.asarray(fs.load(sid, power)).astype(np.float16))
        stores[name] = (d, ids)
    return cfg, stores


def _collate_dataset(collate_stores, store, table_dtype, held=True):
    import copy

    from paths_tpu_torch.data.dataset import SlideDataset
    from paths_tpu_torch.data.feature_store import FeatureStore

    cfg, stores = collate_stores
    cfg = copy.deepcopy(cfg)
    cfg.table_dtype = table_dtype
    root, ids = stores[store]
    return SlideDataset(ids, cfg, FeatureStore(root), cache_slides=held)


def _wires(slide):
    """A slide's page-locked feature copies, a level each (None: none)."""
    return [slide.level0_wire] + [t.get("fts_wire") for t in slide.tables]


def _batch_fields(bag, tables):
    """Every tensor of a collated batch, by name, on the host."""
    out = {f"bag.{k}": getattr(bag, k).cpu()
           for k in ("fts", "locs", "mask", "parent_inds")}
    for lvl, t in enumerate(tables, start=1):
        out.update({f"{lvl}.{k}": getattr(t, k).cpu()
                    for k in ("fts", "locs", "count", "index", "grid_hw")})
    return out


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


COLLATE_IDX = [0, 1, 3, 4, 5, 5]       # padded by repeating the last slide


@pytest.mark.cuda
@pytest.mark.parametrize("store,table_dtype,kw", [
    ("f16", "float32", {}), ("f32", "bfloat16", {}), ("mixed", "float32", {}),
    ("mixed", "bfloat16", {"pads": True}), ("f16", "float32", {"seq": (1, 2)}),
    ("f16", "float32", {"level0_bucket": 1, "row_bucket": 1,
                        "grid_bucket": 1})])
@pytest.mark.parametrize("held", ["locked", "no_budget", "unheld"])
def test_cuda_collation_equals_cpu_collation(card, collate_stores, store,
                                             table_dtype, kw, held):
    """Each of three batches collated for the card (held slides: from
    pageable memory, then from the page-locked copies made at their second
    collation, or from pageable memory throughout where `pin_bytes` is 0;
    unheld: from pageable memory) equals, to the bit, the batch the CPU
    collates from the same store."""
    import warnings

    from paths_tpu_torch.data.dataset import collate_batch

    cpu = _collate_dataset(collate_stores, store, table_dtype)
    dev = _collate_dataset(collate_stores, store, table_dtype,
                           held=held != "unheld")
    if held == "no_budget":
        dev.pin_bytes = 0
    kw = dict(kw)
    if kw.pop("pads", False):
        kw["pads"] = cpu.global_pads()
    kw.setdefault("level0_bucket", cpu.config.level0_bucket)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the mixed-dtype warning
        want = _batch_fields(*collate_batch(cpu, COLLATE_IDX, device="cpu",
                                            **kw))
        for _ in range(3):
            got = _batch_fields(*collate_batch(dev, COLLATE_IDX, device=card,
                                               **kw))
            _assert_same_batch(got, want)
    wires = [w for i in set(COLLATE_IDX) for w in _wires(dev.slides[i])]
    if held == "locked":
        assert all(w is not None and w.is_pinned() for w in wires)
    else:
        assert all(w is None for w in wires)


@pytest.mark.cuda
def test_held_slides_pinned_once_and_counted(card, collate_stores,
                                             monkeypatch):
    """Over three batches each held slide's features are page-locked once,
    at its second collation (none in the first or the third batch, the
    same copies reused), and every feature byte copied from them is counted
    as `h2d_pinned_bytes`, beside `h2d_bytes`; the first batch's, from
    pageable memory, are not."""
    from torch.profiler import ProfilerActivity, profile

    from paths_tpu_torch import profiling
    from paths_tpu_torch.data.dataset import collate_batch

    ds = _collate_dataset(collate_stores, "f16", "float32")
    pins = []
    real_empty = torch.empty

    def empty(*a, **k):
        pins.append(bool(k.get("pin_memory")))
        return real_empty(*a, **k)

    monkeypatch.setattr(torch, "empty", empty)
    slides = len(set(COLLATE_IDX))
    levels = ds.config.num_levels
    counted, ptrs, new_pins = [], [], []
    for _ in range(3):
        n, t0 = sum(pins), len(profiling.spans())
        with profile(activities=[ProfilerActivity.CPU]):
            bag, tables = collate_batch(ds, COLLATE_IDX, device=card,
                                        level0_bucket=ds.config.level0_bucket)
        torch.cuda.synchronize()
        new_pins.append(sum(pins) - n)
        (col,) = [s for s in profiling.spans()[t0:] if s.name == "paths.collate"]
        counted.append(col.attrs)
        ptrs.append([w.data_ptr() for s in ds.slides for w in _wires(s)
                     if w is not None])
    assert new_pins == [0, levels * slides, 0]
    assert ptrs[0] == [] and ptrs[1] == ptrs[2]
    assert len(ptrs[1]) == levels * slides
    feature_bytes = sum(
        s.level0[0].nbytes + sum(t["fts"].nbytes for t in s.tables)
        for s in (ds.slides[i] for i in COLLATE_IDX))
    small = sum(v.numel() * (1 if v.dtype == torch.bool else 4)   # int32
                for k, v in _batch_fields(bag, tables).items()
                if k.split(".")[1] in ("locs", "count", "index", "grid_hw",
                                       "mask"))
    assert [a.get("h2d_pinned_bytes", 0) for a in counted] == [
        0, feature_bytes, feature_bytes]
    assert all(a["h2d_bytes"] == feature_bytes + small for a in counted)


@pytest.mark.cuda
def test_second_batch_before_the_first_is_read(card, collate_stores):
    """Two batches collated while the card is still busy (their copies
    queued behind a long kernel) each equal their CPU collation: the
    page-locked sources are never rewritten, so the second batch's copies
    cannot disturb the first's."""
    from paths_tpu_torch.data.dataset import collate_batch

    ds = _collate_dataset(collate_stores, "f16", "float32")
    cpu = _collate_dataset(collate_stores, "f16", "float32")
    bucket = ds.config.level0_bucket
    first, second = [0, 1, 2], [2, 3, 4, 5]
    for _ in range(2):                            # every slide page-locked
        collate_batch(ds, first + second, device=card, level0_bucket=bucket)
    torch.cuda.synchronize()
    assert all(w is not None for s in ds.slides for w in _wires(s))
    torch.cuda._sleep(1_000_000_000)              # about half a second
    a = collate_batch(ds, first, device=card, level0_bucket=bucket)
    b = collate_batch(ds, second, device=card, level0_bucket=bucket)
    torch.cuda.synchronize()
    for got, idx in ((a, first), (b, second)):
        _assert_same_batch(_batch_fields(*got), _batch_fields(*collate_batch(
            cpu, idx, device="cpu", level0_bucket=bucket)))


@pytest.mark.cuda
def test_unload_during_an_inflight_copy(card, collate_stores):
    """`unload()` right after the collation that page-locks the slides,
    while its copies still wait behind a long kernel, and page-locked
    blocks of the same sizes then taken and overwritten, leave the batch
    equal to the CPU's: torch's page-locked allocator keeps a dropped block
    until the copies that read it have run. Over three rounds the
    allocator's page-locked bytes do not grow (the dropped blocks return to
    it and are reused)."""
    import gc

    from paths_tpu_torch.data.dataset import collate_batch

    ds = _collate_dataset(collate_stores, "f16", "float32")
    cpu = _collate_dataset(collate_stores, "f16", "float32")
    bucket = ds.config.level0_bucket
    want = _batch_fields(*collate_batch(cpu, COLLATE_IDX, device="cpu",
                                        level0_bucket=bucket))
    held = []
    for _ in range(3):
        collate_batch(ds, COLLATE_IDX, device=card, level0_bucket=bucket)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000_000)
        batch = collate_batch(ds, COLLATE_IDX, device=card,
                              level0_bucket=bucket)
        sizes = [w.shape for s in ds.slides for w in _wires(s)
                 if w is not None]
        assert sizes
        for s in ds.slides:
            s.unload()
        gc.collect()
        grabbed = [torch.full(shape, 7.0, dtype=torch.float16,
                              pin_memory=True) for shape in sizes]
        torch.cuda.synchronize()
        _assert_same_batch(_batch_fields(*batch), want)
        del grabbed, batch
        gc.collect()
        held.append(torch.cuda.host_memory_stats()["allocated_bytes.current"])
    assert held[2] <= held[0], held
