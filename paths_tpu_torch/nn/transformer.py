"""Post-norm transformer encoder/decoder stacks (counterpart of
`paths_tpu.nn.transformer`).

Layer structure matches `torch.nn.Transformer` defaults (norm_first=False,
ReLU feed-forward, a final LayerNorm after each stack). The port serves
only, so no dropout runs here yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.nn.attention import MultiheadAttention
from paths_tpu_torch.nn.core import LayerNorm, linear_apply, make_linear


class FeedForward(nn.Module):
    def __init__(self, dim: int, ff_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin1 = make_linear(dim, ff_dim, init="xavier", generator=generator)
        self.lin2 = make_linear(ff_dim, dim, init="xavier", generator=generator)

    def forward(self, x, compute_dtype=None):
        h = torch.relu(linear_apply(self.lin1, x, compute_dtype))
        return linear_apply(self.lin2, h, compute_dtype).to(x.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ff_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads, generator=generator)
        self.ff = FeedForward(dim, ff_dim, generator=generator)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x, *, valid=None, compute_dtype=None, impl="xla"):
        sa = self.self_attn(x, x, x, key_valid=valid,
                            compute_dtype=compute_dtype, impl=impl)
        x = self.norm1(x + sa)
        return self.norm2(x + self.ff(x, compute_dtype))


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
                compute_dtype=None, impl="xla"):
        """`memory` may have length 0; cross-attention then adds the
        out-projection bias (see `MultiheadAttention.forward`)."""
        sa = self.self_attn(x, x, x, key_valid=tgt_valid,
                            compute_dtype=compute_dtype, impl=impl)
        x = self.norm1(x + sa)
        ca = self.cross_attn(x, memory, memory, key_valid=mem_valid,
                             compute_dtype=compute_dtype)
        x = self.norm2(x + ca)
        return self.norm3(x + self.ff(x, compute_dtype))


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

    def forward(self, src, tgt, *, src_valid=None, tgt_valid=None,
                compute_dtype=None, impl="xla"):
        """`transformer_apply`. `src` may be zero-length (B, 0, D); the
        encoder is then skipped."""
        memory = src
        if src.shape[1] > 0:
            for layer in self.encoder.layers:
                memory = layer(memory, valid=src_valid,
                               compute_dtype=compute_dtype, impl=impl)
            memory = self.encoder.norm(memory)
        x = tgt
        for layer in self.decoder.layers:
            x = layer(x, memory, tgt_valid=tgt_valid, mem_valid=src_valid,
                      compute_dtype=compute_dtype, impl=impl)
        return self.decoder.norm(x)
