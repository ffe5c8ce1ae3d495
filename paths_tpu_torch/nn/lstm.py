"""Hand-rolled LSTM cell shared across hierarchy levels (counterpart of
`paths_tpu.nn.lstm`).

Not a textbook LSTM: every gate reads concat(x, h(t-1)) and the output
tanh-maps the NEW memory:

    c' = c * sigmoid(Wf xh) + sigmoid(Wr xh) * tanh(Wm xh)
    h' = sigmoid(Wo xh) * tanh(Wc c')
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.nn.core import linear_apply, make_linear

_GATES = ("forget_gate", "remember_gate", "remember_map", "out_select_gate")


class LSTMCell(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        xh = input_dim + output_dim
        self.forget_gate = make_linear(xh, hidden_dim, generator=generator)
        self.remember_gate = make_linear(xh, hidden_dim, generator=generator)
        self.remember_map = make_linear(xh, hidden_dim, generator=generator)
        self.out_select_gate = make_linear(xh, output_dim, generator=generator)
        self.mem_to_out = make_linear(hidden_dim, output_dim, generator=generator)


def lstm_cell_apply(cell: LSTMCell, xs: torch.Tensor, hs: torch.Tensor,
                    cs: torch.Tensor,
                    compute_dtype: Optional[torch.dtype] = None):
    """One cell step; xs/hs/cs are (..., dim). Returns (h', c').

    The four gates that read concat(x, h) run as ONE matmul over their
    weights concatenated along the output axis."""
    xhs = torch.cat([xs, hs], dim=-1)
    w = torch.cat([getattr(cell, n).weight for n in _GATES], dim=0)
    b = torch.cat([getattr(cell, n).bias for n in _GATES], dim=0)
    if compute_dtype is not None:
        xhs, w, b = xhs.to(compute_dtype), w.to(compute_dtype), b.to(compute_dtype)
    packed = torch.nn.functional.linear(xhs, w, b)
    f, r, rm, o = packed.split([cell.forget_gate.out_features] * 3
                               + [cell.out_select_gate.out_features], dim=-1)
    cs = cs * torch.sigmoid(f)
    cs = cs + torch.sigmoid(r) * torch.tanh(rm)
    hs = torch.sigmoid(o) * torch.tanh(
        linear_apply(cell.mem_to_out, cs, compute_dtype))
    return hs.to(xs.dtype), cs.to(xs.dtype)
