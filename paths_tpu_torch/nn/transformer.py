"""Post-norm transformer encoder/decoder stacks (counterpart of
`paths_tpu.nn.transformer`).

Layer structure matches `torch.nn.Transformer` defaults (norm_first=False,
ReLU feed-forward, a final LayerNorm after each stack). Dropout sites match
the JAX package (and torch): the attention weights, after each attention
output, inside the feed-forward after the ReLU, and after the feed-forward
output. `rate`, `generator` and `training` are threaded through every
layer; dropout runs only in training at rate > 0.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.nn.attention import MultiheadAttention
from paths_tpu_torch.nn.core import (
    LayerNorm,
    dropout,
    linear_apply,
    make_linear,
)


class FeedForward(nn.Module):
    def __init__(self, dim: int, ff_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin1 = make_linear(dim, ff_dim, init="xavier", generator=generator)
        self.lin2 = make_linear(ff_dim, dim, init="xavier", generator=generator)

    def forward(self, x, compute_dtype=None, *, rate=0.0, **drop):
        """`drop`: `nn.core.dropout`'s generator, training and shard."""
        h = torch.relu(linear_apply(self.lin1, x, compute_dtype))
        h = dropout(h, rate, **drop)
        return linear_apply(self.lin2, h, compute_dtype).to(x.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads, generator=generator)
        self.ff = FeedForward(dim, ff_dim, generator=generator)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x, *, valid=None, rate=0.0, generator=None,
                training=False, compute_dtype=None, impl="xla"):
        drop = dict(generator=generator, training=training)
        sa = self.self_attn(x, x, x, key_valid=valid, dropout_rate=rate,
                            compute_dtype=compute_dtype, impl=impl, **drop)
        x = self.norm1(x + dropout(sa, rate, **drop))
        ff = self.ff(x, compute_dtype, rate=rate, **drop)
        return self.norm2(x + dropout(ff, rate, **drop))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads, generator=generator)
        self.cross_attn = MultiheadAttention(dim, num_heads, generator=generator)
        self.ff = FeedForward(dim, ff_dim, generator=generator)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, memory, *, tgt_valid=None, mem_valid=None,
                rate=0.0, generator=None, training=False, compute_dtype=None,
                impl="xla", seq_mesh=None):
        """`memory` may have length 0; cross-attention then returns the
        out-projection bias (see `MultiheadAttention.forward`), which still
        goes through the output dropout. With `seq_mesh`, x is this rank's
        block of the target sequence and `tgt_valid` the whole sequence's
        mask; every dropout mask is this rank's block of the whole
        sequence's."""
        drop = dict(generator=generator, training=training)
        rows = drop
        if seq_mesh is not None:
            rows = dict(drop, shard=seq_mesh.dropout_shard())
        sa = self.self_attn(x, x, x, key_valid=tgt_valid, dropout_rate=rate,
                            compute_dtype=compute_dtype, impl=impl,
                            seq_mesh=seq_mesh, **drop)
        x = self.norm1(x + dropout(sa, rate, **rows))
        ca = self.cross_attn(x, memory, memory, key_valid=mem_valid,
                             dropout_rate=rate, compute_dtype=compute_dtype,
                             **rows)
        x = self.norm2(x + dropout(ca, rate, **rows))
        ff = self.ff(x, compute_dtype, rate=rate, **rows)
        return self.norm3(x + dropout(ff, rate, **rows))


class _Stack(nn.Module):
    def __init__(self, layers, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = LayerNorm(dim)


class Transformer(nn.Module):
    """Encoder-decoder pair with final norms (like nn.Transformer)."""

    def __init__(self, dim: int, num_heads: int, num_layers: int, ff_dim: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = _Stack([EncoderLayer(dim, num_heads, ff_dim,
                                            generator=generator)
                               for _ in range(num_layers)], dim)
        self.decoder = _Stack([DecoderLayer(dim, num_heads, ff_dim,
                                            generator=generator)
                               for _ in range(num_layers)], dim)

    def forward(self, src, tgt, *, src_valid=None, tgt_valid=None, rate=0.0,
                generator=None, training=False, compute_dtype=None,
                impl="xla", seq_mesh=None):
        """`transformer_apply`. `src` may be zero-length (B, 0, D); the
        encoder is then skipped. `seq_mesh` cuts the target sequence over a
        sequence group (`DecoderLayer`); the conditional sequence is whole."""
        kw = dict(rate=rate, generator=generator, training=training,
                  compute_dtype=compute_dtype, impl=impl)
        memory = src
        if src.shape[1] > 0:
            for layer in self.encoder.layers:
                memory = layer(memory, valid=src_valid, **kw)
            memory = self.encoder.norm(memory)
        x = tgt
        for layer in self.decoder.layers:
            x = layer(x, memory, tgt_valid=tgt_valid, mem_valid=src_valid,
                      seq_mesh=seq_mesh, **kw)
        return self.decoder.norm(x)
