"""Masked flash attention: the hand-written CUDA kernels of both directions
and their plain PyTorch versions.

Replaces the TPU kernels of `paths_tpu/kernels/flash_attention.py`:
`_flash_forward` (body `_flash_kernel`) and the two passes of
`_flash_backward` (dq: `_flash_bwd_dq_kernel`, dk/dv:
`_flash_bwd_dkv_kernel`). The CUDA sources are `paths_tpu_torch/csrc/
flash_attention.cu` (forward) and `csrc/flash_attention_bwd.cu` (the two
backward kernels), built for sm_90a by `kernels.build` and called through
ctypes. What bounds each on the card and how its design answers that is
noted at the top of its source.

`masked_flash_attention_fwd(q, k, v, lengths, block_k=512) -> (out, lse)`,
the inference entry:
  q (B, H, Nq, D), k/v (B, H, Nk, D) of one type (f32 or bf16; scores, the
  softmax state and the sums are f32), D 32 or 64, lengths (B,) int32; keys
  at index >= lengths[b] are masked for every query. out has q's shape and
  type, lse is (B, H, Nq) f32. Query rows at or past the length still
  produce outputs normalised over the valid keys. The raw kernel entries take
  no inputs that require grad; `masked_flash_attention` is the
  differentiable entry.

Rounding, as the TPU kernels round. In bf16 the forward rounds P = exp(s -
m) to bf16 before P V, where m is the running max of the valid keys up to
the end of P's `block_k`-key block (the JAX argument of the same name: the
TPU kernel walks the keys in blocks of `block_k` and rounds against the max
it has seen so far), while the row sum l and the lse stay unrounded f32. The
backward rounds dS to the input type before dS K (dq) and dS^T Q (dk); dv
takes P unrounded. In f32 every such rounding is none and `block_k` changes
nothing. The kernel takes `block_k` a multiple of 64, its key tile. The
plain versions (CPU tensors) also take f64 and then sum in f64
(`nn.core.wide`): a model run in f64 measures an f32 rounding gap.

`masked_flash_attention_bwd(q, k, v, lengths, out, lse, dout) -> (dq, dk,
dv)` launches the dq kernel (which also writes delta = rowsum(dO o O)) and
then the dk/dv kernel. Keys at or past the length get exactly zero dk/dv.

`masked_flash_attention(q, k, v, lengths, block_k=512) -> out` is a
`torch.autograd.Function` (the counterpart of the JAX `custom_vjp` of the
same name): forward through the forward kernel, backward through the two
backward kernels; `lengths` gets no gradient, and double backward raises.

A CUDA tensor goes to the kernels or the call raises; a CPU tensor goes to
the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from paths_tpu_torch.kernels import build
from paths_tpu_torch.nn.core import wide

NEG_INF = -1e30
L_FLOOR = 1e-30
HEAD_DIMS = (32, 64)
# the JAX entry's default key block (`paths_tpu/kernels/flash_attention.py`)
BLOCK_K = 512
# keys of one tile of the forward kernel: `block_k` is a multiple of it
KEY_TILE = 64
# the kernel's I/O types -> the C interface's dtype code; math runs in f32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _valid_keys(q: torch.Tensor, nk: int, lengths: torch.Tensor):
    """(B, 1, 1, Nk) bool: key index < lengths[b]."""
    return (torch.arange(nk, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lengths: torch.Tensor,
                              block_k: int = BLOCK_K):
    """Plain PyTorch version of the forward kernel: the same masking, NEG_INF
    and l floor, computed with whole score matrices. Returns (out, lse).

    In bf16, P of a key is taken against the running max m_j at the end of
    the key's `block_k` block and rounded to bf16; the block's share of the
    output is then scaled by exp(m_j - m), as the TPU kernel's online
    rescaling does, and l sums the unrounded P alike. In f32 m_j is the final
    max m for every key: rounding to f32 is none, so the blocks cannot
    matter."""
    if block_k < 1:
        raise ValueError(f"block_k {block_k} must be positive")
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    nk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", wide(q), wide(k)) * sm_scale
    valid = _valid_keys(q, nk, lengths)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if q.dtype == s.dtype:
        m_key = m
    else:
        blocks = -(-nk // block_k)
        padded = torch.nn.functional.pad(s, (0, blocks * block_k - nk),
                                         value=NEG_INF)
        m_blocks = padded.unflatten(-1, (blocks, block_k)).amax(dim=-1)
        m_key = torch.cummax(m_blocks, dim=-1).values.repeat_interleave(
            block_k, dim=-1)[..., :nk]
    p = torch.exp(s - m_key) * valid
    rescale = torch.exp(m_key - m)
    l_safe = (p * rescale).sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    out = torch.einsum("bhqk,bhkd->bhqd", wide(p.to(q.dtype)) * rescale,
                       wide(v)) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _probs(q, k, lengths, lse):
    """P = exp(scale * q k^T - lse) in f32, rebuilt from the forward's lse
    as the TPU kernels do, and exactly 0 on masked keys (with length 0 the
    lse is about NEG_INF, so the exponent alone would not give 0)."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", wide(q), wide(k)) * sm_scale
    valid = _valid_keys(q, k.shape[2], lengths)
    s = s.masked_fill(~valid, NEG_INF)
    return torch.exp(s - lse[..., None]) * valid


def flash_bwd_dq_reference(q, k, v, lengths, out, lse, dout):
    """Plain version of the dq kernel: (dq, delta) with delta =
    rowsum(dO o O) (B, H, Nq) f32 and dq = scale * dS k, dS = P o (dO v^T -
    delta) rounded to k's type (the TPU kernel's `ds.astype(k.dtype)`)."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lengths, lse)
    do = wide(dout)
    delta = (do * wide(out)).sum(dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, wide(v))
    ds = wide((p * (dp - delta[..., None])).to(k.dtype))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, wide(k)) * sm_scale
    return dq.to(q.dtype), delta


def flash_bwd_dkv_reference(q, k, v, lengths, lse, dout, delta):
    """Plain version of the dk/dv kernel: dv = P^T dO with P unrounded, dk =
    scale * dS^T q with dS = P o (dO v^T - delta) rounded to q's type (the
    TPU kernel's `ds.astype(q.dtype)`); rows of keys past the length are 0."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lengths, lse)
    do = wide(dout)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, wide(v))
    ds = wide((p * (dp - delta[..., None])).to(q.dtype))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, wide(q)) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(q, k, v, lengths, out, lse, dout):
    """Plain version of both backward kernels, step by step as the TPU
    kernels compute it: P from lse, delta = rowsum(dO o O), dS = P o (dP -
    delta), then dq, dk and dv. Returns (dq, dk, dv) in the input types."""
    dq, delta = flash_bwd_dq_reference(q, k, v, lengths, out, lse, dout)
    dk, dv = flash_bwd_dkv_reference(q, k, v, lengths, lse, dout, delta)
    return dq, dk, dv


def _check(q, k, v, lengths) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}: q, k and v must share one "
                            f"of {tuple(DTYPES)}")
        if t.requires_grad:
            raise RuntimeError(
                "the raw CUDA flash-attention kernels take no inputs that "
                "require grad; call masked_flash_attention for a gradient")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, H, N, D) each")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head_dim")
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)}, want ({b},)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (want one of {HEAD_DIMS})")
    if b > 65535 or h > 65535:
        raise ValueError("batch and heads must each be <= 65535 (grid limits)")


def _check_like(q, dtype, shape, **tensors) -> None:
    """The backward's extra operands: on q's device, contiguous and 16-byte
    aligned, of `dtype` and `shape`, and not requiring grad."""
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise TypeError(f"{name} is {t.dtype} {tuple(t.shape)}, want "
                            f"{dtype} {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a "
                             "16-byte boundary")
        if t.requires_grad:
            raise RuntimeError(f"{name} requires grad; the raw kernels take "
                               "detached tensors")


# library -> C entry -> (pointer arguments, int arguments); every entry then
# takes the softmax scale (float) and the stream, and returns a cudaError_t
_ENTRIES = {
    "flash_attention": {"paths_flash_attention_fwd": (6, 7)},
    "flash_attention_bwd": {"paths_flash_attention_bwd_dq": (9, 6),
                            "paths_flash_attention_bwd_dkv": (9, 6)},
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """Kernel library `name`, built on first use, with its C signatures."""
    lib = build.load(name)
    for entry, (n_ptr, n_int) in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.paths_cuda_error_string.argtypes = [ctypes.c_int]
    lib.paths_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry `entry` of library `name` on `device`'s current stream;
    raise if the launch was refused."""
    lib = _library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.paths_cuda_error_string(rc).decode())


def _require_cuda(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")


def masked_flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor,
                               block_k: int = BLOCK_K):
    """(out, lse); see the module docstring. Each kernel launch adds one to
    `masked_flash_attention_fwd.launches`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, block_k)
    _require_cuda(q)
    _check(q, k, v, lengths)
    if block_k < 1 or block_k % KEY_TILE:
        raise ValueError(f"block_k {block_k}: the kernel takes a positive "
                         f"multiple of its key tile, {KEY_TILE}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if nq == 0:
        return out, lse
    _launch("flash_attention", "paths_flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, nq, nk, d, DTYPES[q.dtype],
            block_k, 1.0 / math.sqrt(d))
    masked_flash_attention_fwd.launches += 1
    return out, lse


def masked_flash_attention_bwd_dq(q, k, v, lengths, out, lse, dout):
    """(dq, delta) through the dq kernel (kernel #2); delta = rowsum(dO o O)
    (B, H, Nq) f32 feeds the dk/dv kernel. Each launch adds one to
    `masked_flash_attention_bwd_dq.launches`."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, lengths, out, lse, dout)
    _require_cuda(q)
    _check(q, k, v, lengths)
    b, h, nq, d = q.shape
    _check_like(q, q.dtype, q.shape, out=out, dout=dout)
    _check_like(q, torch.float32, (b, h, nq), lse=lse)
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, delta
    _launch("flash_attention_bwd", "paths_flash_attention_bwd_dq", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), lengths.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), b, h, nq, k.shape[2], d, DTYPES[q.dtype],
            1.0 / math.sqrt(d))
    masked_flash_attention_bwd_dq.launches += 1
    return dq, delta


def masked_flash_attention_bwd_dkv(q, k, v, lengths, lse, dout, delta):
    """(dk, dv) through the dk/dv kernel (kernel #3), from the delta of the
    dq kernel; rows of keys at or past the length are exactly 0. Each launch
    adds one to `masked_flash_attention_bwd_dkv.launches`."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, lengths, lse, dout, delta)
    _require_cuda(q)
    _check(q, k, v, lengths)
    b, h, nq, d = q.shape
    _check_like(q, q.dtype, q.shape, dout=dout)
    _check_like(q, torch.float32, (b, h, nq), lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    _launch("flash_attention_bwd", "paths_flash_attention_bwd_dkv", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, nq, k.shape[2], d,
            DTYPES[q.dtype], 1.0 / math.sqrt(d))
    masked_flash_attention_bwd_dkv.launches += 1
    return dk, dv


def masked_flash_attention_bwd(q, k, v, lengths, out, lse, dout):
    """(dq, dk, dv): the dq kernel, then the dk/dv kernel on the same
    stream. A CPU tensor goes to the plain versions."""
    dq, delta = masked_flash_attention_bwd_dq(q, k, v, lengths, out, lse, dout)
    dk, dv = masked_flash_attention_bwd_dkv(q, k, v, lengths, lse, dout, delta)
    return dq, dk, dv


class _MaskedFlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels (or, on the CPU, their plain
    versions); the raw entries get detached tensors."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, block_k):
        out, lse = masked_flash_attention_fwd(q.detach(), k.detach(),
                                              v.detach(), lengths, block_k)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, lengths, out, lse = ctx.saved_tensors
        dq, dk, dv = masked_flash_attention_bwd(
            q.detach(), k.detach(), v.detach(), lengths, out.detach(), lse,
            dout.contiguous())
        return dq, dk, dv, None, None


def masked_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor,
                           block_k: int = BLOCK_K) -> torch.Tensor:
    """Differentiable masked flash attention (the JAX `custom_vjp` of the
    same name): out with q's shape and type; gradients for q, k and v, none
    for `lengths`; double backward raises. `block_k` places the forward's
    rounding of P in bf16 (module docstring)."""
    return _MaskedFlashAttention.apply(q, k, v, lengths, block_k)


masked_flash_attention_fwd.launches = 0
masked_flash_attention_bwd_dq.launches = 0
masked_flash_attention_bwd_dkv.launches = 0


# The forward kernel as the traceable operator `paths_torch::flash_attention_fwd`
# (q, k, v, lengths, block_k) -> (out, lse): `torch.export` records it as one
# node, so an exported serving program (`paths_tpu_torch.export`) runs the
# kernel. Its one body is `masked_flash_attention_fwd`: the counted launch on
# the card, the plain version on the CPU; the fake one gives the shapes and
# types. Importing this module registers it. It has no autograd formula:
# the differentiable entry is `masked_flash_attention`.
@torch.library.custom_op("paths_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor,
                        block_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    return masked_flash_attention_fwd(q, k, v, lengths, block_k)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, lengths, block_k):
    b, h, nq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, nq), dtype=torch.float32)
