"""Masked flash-attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel `paths_tpu/kernels/flash_attention.py::_flash_forward`
(body `_flash_kernel`). The CUDA source is `paths_tpu_torch/csrc/
flash_attention.cu`, built for sm_90a by `kernels.build` and called through
ctypes. What bounds it on the card and how its design answers that is noted
at the top of the source.

`masked_flash_attention_fwd(q, k, v, lengths) -> (out, lse)`:
  q (B, H, Nq, D), k/v (B, H, Nk, D) of one type (f32 or bf16; the kernel
  computes in f32), D 32 or 64, lengths (B,) int32; keys at index
  >= lengths[b] are masked for every query. out has q's shape and type, lse
  is (B, H, Nq) f32. Query rows at or past the length still produce outputs
  normalised over the valid keys. A CUDA tensor goes to the kernel or the
  call raises; a CPU tensor goes to the plain version. The kernel is forward
  only, so inputs that require grad raise on the CUDA path.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from paths_tpu_torch.kernels import build

NEG_INF = -1e30
L_FLOOR = 1e-30
HEAD_DIMS = (32, 64)
# the kernel's I/O types -> the C interface's dtype code; math runs in f32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lengths: torch.Tensor):
    """Plain PyTorch version of the kernel: the same masking, NEG_INF and
    l floor, computed with whole score matrices. Returns (out, lse)."""
    nk = k.shape[2]
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    valid = (torch.arange(nk, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(L_FLOOR)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


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
                "the CUDA flash-attention kernel is forward only; call it "
                "under torch.no_grad() or torch.inference_mode()")
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use, with its C signatures."""
    lib = build.load("flash_attention")
    fn = lib.paths_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paths_cuda_error_string.argtypes = [ctypes.c_int]
    lib.paths_cuda_error_string.restype = ctypes.c_char_p
    return lib


def masked_flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor):
    """(out, lse); see the module docstring. Each kernel launch adds one to
    `masked_flash_attention_fwd.launches`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    _check(q, k, v, lengths)
    b, h, nq, d = q.shape
    nk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    if nq == 0:
        return out, lse
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paths_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, nq, nk, d, DTYPES[q.dtype],
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError("flash-attention launch failed: "
                           + lib.paths_cuda_error_string(rc).decode())
    masked_flash_attention_fwd.launches += 1
    return out, lse


masked_flash_attention_fwd.launches = 0
