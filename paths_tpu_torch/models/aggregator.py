"""Transformer aggregator: masked attention over a patch bag -> one slide
feature vector (counterpart of `paths_tpu.models.aggregator`).

The bag is projected D -> trans_dim and positionally encoded, a learned
special token is prepended, and the decoder output at the special token's
position is the aggregate. The encoder ("conditional") sequence is empty in
PATHS.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.nn.core import linear_apply, make_linear
from paths_tpu_torch.nn.transformer import Transformer
from paths_tpu_torch.ops.pos_encoding import (
    positional_encoding_1d,
    positional_encoding_2d_from_pos,
)


class Aggregator(nn.Module):
    def __init__(self, input_dim: int, model_dim: int, num_heads: int,
                 layers: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj_in = make_linear(input_dim, model_dim, generator=generator)
        self.transformer = Transformer(model_dim, num_heads, layers,
                                       ff_dim=model_dim * 4, generator=generator)
        self.special_token = nn.Parameter(
            torch.randn(model_dim, generator=generator))

    def pos_encode_1d(self, xs, compute_dtype=None, start: int = 0):
        """Project, then add 1D PE by bag position; `start` is the position
        of row 0 (a sequence-parallel block's first patch)."""
        xs = linear_apply(self.proj_in, xs, compute_dtype)
        _, n, d = xs.shape
        return xs + positional_encoding_1d(n, d, dtype=xs.dtype,
                                           device=xs.device,
                                           start=start)[None]

    def pos_encode_2d(self, xs, patch_locs, compute_dtype=None):
        """Project, then add 2D PE from patch-grid coords (B, N, 2);
        coordinate 0 fills the first half of the encoding."""
        xs = linear_apply(self.proj_in, xs, compute_dtype)
        pe = positional_encoding_2d_from_pos(patch_locs[..., 0],
                                             patch_locs[..., 1], xs.shape[-1])
        return xs + pe.to(xs.dtype)

    def forward(self, cond_seq, xs, cond_valid, xs_valid, *,
                dropout_rate=0.0, generator=None, training=False,
                compute_dtype=None, impl="xla", seq_mesh=None):
        """`aggregator_apply`: aggregate `xs` (already projected and
        encoded, (B, N, dm)) into (B, dm). `cond_seq` may be (B, 0, dm).

        With `seq_mesh`, `xs` (B, m, dm) is this rank's block of the
        sequence [special token, patches] (`models/batch.py`) and `xs_valid`
        its prefix mask: sequence index 0 puts the special token in its row
        0, the group's valid counts make the whole sequence's mask, and the
        special token's output is sent from index 0 to the group."""
        b, m, dm = xs.shape
        special = self.special_token.to(xs.dtype).expand(b, 1, dm)
        kw = dict(src_valid=cond_valid, rate=dropout_rate,
                  generator=generator, training=training,
                  compute_dtype=compute_dtype, impl=impl)
        if seq_mesh is not None:
            first = seq_mesh.index == 0
            seq = torch.cat([special, xs[:, 1:]], dim=1) if first else xs
            local = xs_valid.bool()
            if first:
                local = torch.cat([local.new_ones((b, 1)), local[:, 1:]], 1)
            lengths = seq_mesh.sum_(local.sum(dim=-1, dtype=torch.int32))
            tgt_valid = (torch.arange(seq_mesh.size * m, device=xs.device)[None]
                         < lengths[:, None])
            out = self.transformer(cond_seq, seq, tgt_valid=tgt_valid,
                                   seq_mesh=seq_mesh, **kw)
            return seq_mesh.from_first(out[:, 0])
        seq = torch.cat([special, xs], dim=1)
        tgt_valid = None
        if xs_valid is not None:
            tgt_valid = torch.cat(
                [torch.ones((b, 1), dtype=torch.bool, device=xs.device),
                 xs_valid.bool()], dim=1)
        out = self.transformer(cond_seq, seq, tgt_valid=tgt_valid, **kw)
        return out[:, 0]
