"""Sinusoidal positional encodings (counterpart of
`paths_tpu.ops.pos_encoding`).

The 2D encoding concatenates two half-width 1D encodings whose frequency
term divides by the FULL dim (not dim//2), i.e.
`div_term = exp(arange(0, dim//2, 2) * (-ln(k) / dim))`.
"""
from __future__ import annotations

import math

import torch


def _div_term(dim: int, span: int, k: float, dtype, device) -> torch.Tensor:
    """exp(arange(0, span, 2) * (-ln(k) / dim)), the factor rounded to
    `dtype` first, as JAX rounds a Python scalar to the array's dtype (torch
    would multiply by it unrounded). The rounding is made on the host: a
    tensor made on the card from a Python number would make the host wait."""
    factor = torch.tensor(-math.log(k) / dim, dtype=dtype).item()
    return torch.exp(torch.arange(0, span, 2, dtype=dtype, device=device)
                     * factor)


def _interleave(ang: torch.Tensor) -> torch.Tensor:
    """(..., n) angles -> (..., 2n) with sin in even and cos in odd columns."""
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


def positional_encoding_1d(length: int, dim: int, k: float = 10000.0,
                           dtype=torch.float32, device=None,
                           start: int = 0) -> torch.Tensor:
    """Standard 1D sinusoidal PE of positions start ... start + length - 1,
    shape (length, dim): pe[:, 0::2] = sin(pos * div), pe[:, 1::2] =
    cos(pos * div)."""
    pos = torch.arange(start, start + length, dtype=dtype,
                       device=device)[:, None]
    div = _div_term(dim, dim, k, dtype, device)[None, :]
    return _interleave(pos * div)[:, :dim]


def positional_encoding_2d_from_pos(apos: torch.Tensor, bpos: torch.Tensor,
                                    dim: int, k: float = 10000.0,
                                    dtype=torch.float32) -> torch.Tensor:
    """2D sinusoidal PE: PE2D(a, b) = PE1D(a) || PE1D(b).

    `apos` fills columns [0, dim//2), `bpos` fills [dim//2, dim). Inputs
    may be any shape (...,); the output appends a trailing dim."""
    apos = apos.to(dtype)[..., None]
    bpos = bpos.to(dtype)[..., None]
    half = dim // 2
    div = _div_term(dim, half, k, dtype, apos.device)
    pe_a = _interleave(apos * div)[..., :half]
    pe_b = _interleave(bpos * div)[..., :half]
    return torch.cat([pe_a, pe_b], dim=-1)
