"""Fused ViT encoder-block kernels: the hand-written CUDA kernels and their
plain PyTorch versions (forward only: the patch encoders are frozen).

Replaces the TPU kernels of `paths_tpu/kernels/vit_fused.py`:
`fused_attn_block` (body `_attn_kernel`), `fused_mlp_block` (`_mlp_kernel`),
`fused_swiglu_mlp_block` (`_swiglu_kernel`) and `fused_block`
(`_block_kernel`: the whole GELU block in one launch). The CUDA source is
`paths_tpu_torch/csrc/vit_fused.cu`, built for sm_90a by `kernels.build` and
called through ctypes; what bounds each kernel on the card and how its design
answers that is noted at the top of the source.

The entries keep the JAX argument order. x is (B, N, D) in the compute
dtype (f32 or bf16); the weights share x's dtype and are in PyTorch's
`nn.Linear` layout (out, in): `qkv_w` (3D, D), `proj_w` (D, D), `fc1_w`
(H, D) or, packed for SwiGLU, (2H, D) with the gate rows first, `fc2_w`
(D, H). LayerNorm scale/bias, biases and LayerScale may be any float dtype;
`ls=None` means no LayerScale. The TPU tuning knobs `group` and `num_chunks`
have no counterpart (they do not change these kernels' numbers).

Both the kernels and the plain versions accumulate in f32 and round to the
compute dtype where the TPU kernels do: after the LayerNorm (eps 1e-6), after
qkv + bias, P before P V, each head's context after the deferred divide, the
hidden activation before fc2, and the output. `fused_block` rounds where its
own TPU kernel does: P is divided by its row sum and then rounded, each
head's P V is rounded, and x after the attention half is rounded to the
compute dtype before the second LayerNorm.

A CUDA tensor goes to the kernels or the call raises; a CPU tensor goes to
the plain versions. The kernels take head_dim 64 (`fused_attn_block` also 80,
Virchow2's), D a multiple of 64, a hidden width that is a multiple of 32,
and any number of tokens: the attention of
`fused_attn_block` and `fused_block` streams K and V in tiles of 64 keys, so
the patch-8 Kaiko models (785 tokens) run as the others do. Each wrapper
allocates the scratch its launches pass through device memory: the LN output
(then the context), qkv, x after the attention half and the hidden
activation, as far as its block has them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from paths_tpu_torch.kernels import build

LN_EPS = 1e-6
HEAD_DIM = 64
ATTN_HEAD_DIMS = (64, 80)      # fused_attn_block's; the other kernels take 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {"gelu": 0, "gelu_tanh": 1, "swiglu": 2}


# ------------------------------------------------------------ plain versions

def _ln(x, scale, bias):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _mm(a, w):
    """a (.., K) times w (out, K)^T with f32 accumulation; operands of the
    compute dtype are exact in f32, so this is the kernels' arithmetic."""
    return a.float() @ w.float().T


def _residual(x, branch, bias, ls):
    branch = branch + bias.float()
    if ls is not None:
        branch = branch * ls.float()
    return (x.float() + branch).to(x.dtype)


def fused_attn_block_reference(x, norm_scale, norm_bias, qkv_w, qkv_b, proj_w,
                               proj_b, ls=None, *, num_heads: int):
    """Plain version of kernel #4: LN -> qkv -> per-head softmax attention
    (normalisation deferred past P V) -> out projection -> LayerScale ->
    residual, rounding where the kernel rounds."""
    cd = x.dtype
    b, n, d = x.shape
    hd = d // num_heads
    y = _ln(x, norm_scale, norm_bias)
    qkv = (_mm(y, qkv_w) + qkv_b.float()).to(cd)
    q, k, v = qkv.view(b, n, 3, num_heads, hd).float().unbind(2)  # (B,N,H,hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)                                   # (B,H,N,1)
    c = torch.einsum("bhqk,bkhd->bhqd", p.to(cd).float(), v)
    ctx = (c / l).to(cd).permute(0, 2, 1, 3).reshape(b, n, d)
    return _residual(x, _mm(ctx, proj_w), proj_b, ls)


def fused_block_reference(x, blk: dict, *, num_heads: int,
                          exact_gelu: bool = True):
    """Plain version of kernel #7: the whole GELU block, rounding where that
    kernel rounds. `blk` has the JAX package's block layout with the port's
    (out, in) matrices in x's dtype: `norm1`/`norm2` `{"scale", "bias"}`,
    `attn` `{"qkv_w", "qkv_b", "proj_w", "proj_b"}`, `mlp` `{"fc1_w",
    "fc1_b", "fc2_w", "fc2_b"}`, optional `ls1`/`ls2`."""
    cd = x.dtype
    b, n, d = x.shape
    hd = d // num_heads
    at, ml = blk["attn"], blk["mlp"]
    y = _ln(x, blk["norm1"]["scale"], blk["norm1"]["bias"])
    qkv = (_mm(y, at["qkv_w"]) + at["qkv_b"].float()).to(cd)
    q, k, v = qkv.view(b, n, 3, num_heads, hd).float().unbind(2)  # (B,N,H,hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(cd).float()
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).to(cd).reshape(b, n, d)
    x1 = _residual(x, _mm(ctx, at["proj_w"]), at["proj_b"], blk.get("ls1"))
    return fused_mlp_block_reference(
        x1, blk["norm2"]["scale"], blk["norm2"]["bias"], ml["fc1_w"],
        ml["fc1_b"], ml["fc2_w"], ml["fc2_b"], blk.get("ls2"),
        exact_gelu=exact_gelu)


def fused_mlp_block_reference(x, norm_scale, norm_bias, fc1_w, fc1_b, fc2_w,
                              fc2_b, ls=None, *, exact_gelu: bool = True):
    """Plain version of kernel #5: LN -> fc1 -> GELU (erf, or tanh when
    `exact_gelu` is False) -> fc2 -> LayerScale -> residual."""
    y = _ln(x, norm_scale, norm_bias)
    h = _mm(y, fc1_w) + fc1_b.float()
    h = torch.nn.functional.gelu(h, approximate="none" if exact_gelu else "tanh")
    return _residual(x, _mm(h.to(x.dtype), fc2_w), fc2_b, ls)


def fused_swiglu_mlp_block_reference(x, norm_scale, norm_bias, fc1_w, fc1_b,
                                     fc2_w, fc2_b, ls=None):
    """Plain version of kernel #6: LN -> packed fc1 (gate rows first) ->
    silu(gate) * value -> fc2 -> LayerScale -> residual."""
    y = _ln(x, norm_scale, norm_bias)
    h = _mm(y, fc1_w) + fc1_b.float()
    gate, val = h.chunk(2, dim=-1)
    h = gate * torch.sigmoid(gate) * val
    return _residual(x, _mm(h.to(x.dtype), fc2_w), fc2_b, ls)


# ------------------------------------------------------------------- checks

def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no fused ViT kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}: want (B, N, D)")
    if x.dtype not in DTYPES:
        raise TypeError(f"x is {x.dtype}: want one of {tuple(DTYPES)}")
    if x.requires_grad:
        raise RuntimeError("the fused ViT kernels are forward-only; call "
                           "them under torch.no_grad() on detached tensors")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and start on a 16-byte "
                         "boundary")
    if x.shape[0] > 65535:
        raise ValueError("batch must be <= 65535 (grid limit)")
    if x.shape[2] % HEAD_DIM:
        raise ValueError(f"D {x.shape[2]} must be a multiple of {HEAD_DIM}")


def _check_weight(x, name, w, shape) -> None:
    if w.device != x.device:
        raise ValueError(f"{name} is on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"{name} is {w.dtype}, x is {x.dtype}: weights must "
                        "be cast to the compute dtype")
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(w.shape)}, want {tuple(shape)} "
                         "((out, in) layout)")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and start on a 16-byte "
                         "boundary")


def _vector(x, name, v: Optional[torch.Tensor], length: int) -> torch.Tensor:
    """A bias, LayerNorm or LayerScale vector as contiguous f32 on x's
    device; None (no LayerScale) becomes ones."""
    if v is None:
        return torch.ones(length, dtype=torch.float32, device=x.device)
    if v.device != x.device:
        raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    if not v.is_floating_point() or tuple(v.shape) != (length,):
        raise ValueError(f"{name} {v.dtype} {tuple(v.shape)}, want a float "
                         f"vector of {length}")
    return v.detach().float().contiguous()


# ------------------------------------------------------------------ binding

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "paths_vit_attn_block": ([_P] * 11 + [_I] * 5 + [_P], ctypes.c_int),
    "paths_vit_mlp_block": ([_P] * 11 + [_I] * 6 + [_P], ctypes.c_int),
    "paths_vit_block": ([_P] * 20 + [_I] * 7 + [_P], ctypes.c_int),
    "paths_cuda_error_string": ([_I], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    return build.load_with_signatures("vit_fused", _SIGNATURES)


# ----------------------------------------------------------------- wrappers

def fused_attn_block(x, norm_scale, norm_bias, qkv_w, qkv_b, proj_w, proj_b,
                     ls=None, *, num_heads: int) -> torch.Tensor:
    """Kernel #4; see the module docstring. Each call adds one to
    `fused_attn_block.launches` (one call runs the LayerNorm, qkv,
    attention and out-projection kernels on the same stream)."""
    if x.device.type == "cpu":
        return fused_attn_block_reference(x, norm_scale, norm_bias, qkv_w,
                                          qkv_b, proj_w, proj_b, ls,
                                          num_heads=num_heads)
    _check_x(x)
    b, n, d = x.shape
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"num_heads {num_heads} must divide D {d}")
    if d // num_heads not in ATTN_HEAD_DIMS:
        raise ValueError(f"head_dim {d // num_heads} not supported (the "
                         f"kernel takes {ATTN_HEAD_DIMS})")
    _check_weight(x, "qkv_w", qkv_w, (3 * d, d))
    _check_weight(x, "proj_w", proj_w, (d, d))
    vecs = [_vector(x, name, v, length) for name, v, length in (
        ("norm_scale", norm_scale, d), ("norm_bias", norm_bias, d),
        ("qkv_b", qkv_b, 3 * d), ("proj_b", proj_b, d), ("ls", ls, d))]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    act = torch.empty_like(x)    # LN(x), then the per-head contexts
    qkv = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
    ns, nb, qb, pb, lsv = vecs
    build.launch(_library(), "paths_vit_attn_block", x, x.data_ptr(),
                 ns.data_ptr(), nb.data_ptr(), qkv_w.data_ptr(), qb.data_ptr(),
                 proj_w.data_ptr(), pb.data_ptr(), lsv.data_ptr(),
                 act.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, n, d,
                 num_heads, DTYPES[x.dtype])
    fused_attn_block.launches += 1
    return out


def _mlp(counter, x, norm_scale, norm_bias, fc1_w, fc1_b, fc2_w, fc2_b, ls,
         act: str) -> torch.Tensor:
    _check_x(x)
    b, n, d = x.shape
    packed = 2 if act == "swiglu" else 1
    if fc2_w.dim() != 2:
        raise ValueError(f"fc2_w {tuple(fc2_w.shape)}: want (D, H)")
    hidden = fc2_w.shape[1]
    if hidden % 32:
        raise ValueError(f"hidden width {hidden} must be a multiple of 32")
    _check_weight(x, "fc1_w", fc1_w, (packed * hidden, d))
    _check_weight(x, "fc2_w", fc2_w, (d, hidden))
    ns, nb, b1, b2, lsv = [_vector(x, name, v, length) for name, v, length in (
        ("norm_scale", norm_scale, d), ("norm_bias", norm_bias, d),
        ("fc1_b", fc1_b, packed * hidden), ("fc2_b", fc2_b, d), ("ls", ls, d))]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    y = torch.empty_like(x)      # LN(x)
    h = torch.empty((b, n, hidden), dtype=x.dtype, device=x.device)
    build.launch(_library(), "paths_vit_mlp_block", x, x.data_ptr(),
                 ns.data_ptr(), nb.data_ptr(), fc1_w.data_ptr(), b1.data_ptr(),
                 fc2_w.data_ptr(), b2.data_ptr(), lsv.data_ptr(), y.data_ptr(),
                 h.data_ptr(), out.data_ptr(), b, n, d, hidden, ACTS[act],
                 DTYPES[x.dtype])
    counter.launches += 1
    return out


def fused_mlp_block(x, norm_scale, norm_bias, fc1_w, fc1_b, fc2_w, fc2_b,
                    ls=None, *, exact_gelu: bool = True) -> torch.Tensor:
    """Kernel #5; see the module docstring. Each call adds one to
    `fused_mlp_block.launches` (one call runs the LayerNorm, fc1 and fc2
    kernels on the same stream)."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, norm_scale, norm_bias, fc1_w,
                                         fc1_b, fc2_w, fc2_b, ls,
                                         exact_gelu=exact_gelu)
    return _mlp(fused_mlp_block, x, norm_scale, norm_bias, fc1_w, fc1_b,
                fc2_w, fc2_b, ls, "gelu" if exact_gelu else "gelu_tanh")


def fused_swiglu_mlp_block(x, norm_scale, norm_bias, fc1_w, fc1_b, fc2_w,
                           fc2_b, ls=None) -> torch.Tensor:
    """Kernel #6; see the module docstring. Each call adds one to
    `fused_swiglu_mlp_block.launches` (one call runs the LayerNorm, the fc1
    kernel over the packed weight with the SwiGLU epilogue, and fc2)."""
    if x.device.type == "cpu":
        return fused_swiglu_mlp_block_reference(x, norm_scale, norm_bias,
                                                fc1_w, fc1_b, fc2_w, fc2_b, ls)
    return _mlp(fused_swiglu_mlp_block, x, norm_scale, norm_bias, fc1_w,
                fc1_b, fc2_w, fc2_b, ls, "swiglu")


def fused_block(x, blk: dict, *, num_heads: int,
                exact_gelu: bool = True) -> torch.Tensor:
    """Kernel #7: one whole pre-norm block with a GELU MLP, as one fixed
    sequence of launches on the current stream; `blk` as in
    `fused_block_reference`. Each call adds one to `fused_block.launches`."""
    if x.device.type == "cpu":
        return fused_block_reference(x, blk, num_heads=num_heads,
                                     exact_gelu=exact_gelu)
    _check_x(x)
    b, n, d = x.shape
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"num_heads {num_heads} must divide D {d}")
    if d // num_heads != HEAD_DIM:
        raise ValueError(f"head_dim {d // num_heads} not supported (the "
                         f"kernel takes {HEAD_DIM})")
    at, ml = blk["attn"], blk["mlp"]
    if ml["fc2_w"].dim() != 2:
        raise ValueError(f"fc2_w {tuple(ml['fc2_w'].shape)}: want (D, H)")
    hidden = ml["fc2_w"].shape[1]
    if hidden % 32:
        raise ValueError(f"hidden width {hidden} must be a multiple of 32")
    for name, w, shape in (("qkv_w", at["qkv_w"], (3 * d, d)),
                           ("proj_w", at["proj_w"], (d, d)),
                           ("fc1_w", ml["fc1_w"], (hidden, d)),
                           ("fc2_w", ml["fc2_w"], (d, hidden))):
        _check_weight(x, name, w, shape)
    vecs = [_vector(x, name, v, length) for name, v, length in (
        ("norm1 scale", blk["norm1"]["scale"], d),
        ("norm1 bias", blk["norm1"]["bias"], d), ("qkv_b", at["qkv_b"], 3 * d),
        ("proj_b", at["proj_b"], d), ("ls1", blk.get("ls1"), d),
        ("norm2 scale", blk["norm2"]["scale"], d),
        ("norm2 bias", blk["norm2"]["bias"], d), ("fc1_b", ml["fc1_b"], hidden),
        ("fc2_b", ml["fc2_b"], d), ("ls2", blk.get("ls2"), d))]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    act = torch.empty_like(x)    # LN1(x), the contexts, then LN2(x1)
    x1 = torch.empty_like(x)     # x after the attention half
    qkv = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
    h = torch.empty((b, n, hidden), dtype=x.dtype, device=x.device)
    n1s, n1b, qb, pb, ls1, n2s, n2b, b1, b2, ls2 = (v.data_ptr() for v in vecs)
    build.launch(_library(), "paths_vit_block", x, x.data_ptr(), n1s, n1b,
                 at["qkv_w"].data_ptr(), qb, at["proj_w"].data_ptr(), pb, ls1,
                 n2s, n2b, ml["fc1_w"].data_ptr(), b1, ml["fc2_w"].data_ptr(),
                 b2, ls2, act.data_ptr(), qkv.data_ptr(), x1.data_ptr(),
                 h.data_ptr(), out.data_ptr(), b, n, d, num_heads, hidden,
                 ACTS["gelu" if exact_gelu else "gelu_tanh"], DTYPES[x.dtype])
    fused_block.launches += 1
    return out


fused_attn_block.launches = 0
fused_block.launches = 0
fused_mlp_block.launches = 0
fused_swiglu_mlp_block.launches = 0
