"""Multi-head attention with key-padding masks (counterpart of
`paths_tpu.nn.attention`).

Math matches `torch.nn.MultiheadAttention`: q/k/v projections, scaled
dot-product softmax, out projection. Weights are kept unpacked as four
`nn.Linear`s (q, k, v, out), the layout of the JAX package's params.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.kernels.flash_attention import (
    flash_attention_fwd,
    masked_flash_attention,
)
from paths_tpu_torch.nn.core import dropout, linear_apply, make_linear, wide
from paths_tpu_torch.ops.masking import NEG_INF

# "auto" engages the flash kernels at and above this many keys, on CUDA only:
# the smallest swept bag length from which the kernel route beat the plain
# route at every longer one, forward alone and forward + backward
# (`MultiheadAttention(128, 4)`, f32, `kernels/bench_vit.py --sweep-auto`,
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit).
AUTO_PALLAS_MIN_LEN = 81


def kernel_route(impl: str, nq: int, nk: int, on_cuda: bool,
                 dropout_active: bool) -> bool:
    """Whether `MultiheadAttention` runs through the flash kernels: under
    "pallas", or under "auto" at >= AUTO_PALLAS_MIN_LEN keys on a CUDA
    tensor; never for cross-attention (Nq != Nk) or while attention dropout
    is active, which exists on the plain route only."""
    want = impl == "pallas" or (
        impl == "auto" and on_cuda and nk >= AUTO_PALLAS_MIN_LEN)
    return want and nq == nk and not dropout_active


class MultiheadAttention(nn.Module):
    """Xavier-uniform q/k/v/out weights and zero biases."""

    def __init__(self, dim: int, num_heads: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        for name in ("q", "k", "v", "out"):
            setattr(self, name, make_linear(dim, dim, init="xavier",
                                            generator=generator))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, *,
                key_valid: Optional[torch.Tensor] = None,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                training: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                impl: str = "xla", seq_mesh=None, shard=None) -> torch.Tensor:
        """`mha_apply`: query (B, Nq, D), key/value (B, Nk, D), key_valid
        (B, Nk) bool (True = attendable) -> (B, Nq, D).

        impl "pallas" runs self-attention (Nq == Nk) through the hand-written
        flash kernels; "auto" does so at >= AUTO_PALLAS_MIN_LEN keys on CUDA.
        The kernels take a PREFIX mask (valid keys first, as compacted bags
        are), so lengths are `key_valid.sum(-1)`. When a gradient is wanted
        the route is the differentiable `masked_flash_attention`; otherwise
        the forward kernel alone, which saves nothing, through the operator
        `paths_torch::flash_attention_fwd` that `torch.export` traces.
        Attention-weight dropout (in training, at rate > 0) exists on the
        plain route only, so a call with active dropout takes the plain
        route even under "pallas", as the JAX package does.

        With an empty memory (Nk == 0) the context is zero and the result is
        the broadcast out-projection bias, torch's behaviour for a
        zero-length memory.

        `seq_mesh` (a `parallel.seq_attention.SeqSharding` of size sp > 1)
        makes this self-attention over a sequence cut into sp blocks: query,
        key and value are this rank's (B, m, D) block, `key_valid` the
        whole sequence's (B, sp m) prefix mask, and the result this rank's
        block. The route is decided from the whole sequence's key count, so
        every rank of the group takes the same one. On the kernel route the
        group's schedule runs (`SeqSharding.attend`); on the plain route
        (also under active dropout) K and V are all-gathered over the group
        and this rank's query rows attend to them, this rank's block of the
        whole sequence's dropout masks on the weights (`nn.core.dropout`'s
        `shard`). `shard` gives that block to a cross-attention whose query
        is a rank's block.
        """
        h = self.num_heads
        b, nq, d = query.shape
        nk = key.shape[1]
        if nk == 0:
            return self.out.bias.to(query.dtype).expand(b, nq, d)
        sp = seq_mesh.size if seq_mesh is not None else 1

        cd = compute_dtype or query.dtype

        def heads(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
            y = linear_apply(lin, x, cd)
            return y.reshape(b, -1, h, d // h).transpose(1, 2)  # B,H,N,hd

        q, k, v = heads(self.q, query), heads(self.k, key), heads(self.v, value)

        if kernel_route(impl, sp * nq, sp * nk, query.is_cuda,
                        training and dropout_rate != 0.0):
            lengths = (key_valid.sum(dim=-1, dtype=torch.int32)
                       if key_valid is not None
                       else torch.full((b,), sp * nk, dtype=torch.int32,
                                       device=query.device))
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            # the key block of JAX's call (`paths_tpu/nn/attention.py`):
            # where bf16 rounds P, it sets the running max P is taken against
            block_k = 512 if cd == torch.bfloat16 else 128
            if sp > 1:
                ctx = seq_mesh.attend(q, k, v, lengths, block_k)
            elif torch.is_grad_enabled() and any(
                    t.requires_grad for t in (q, k, v)):
                ctx = masked_flash_attention(q, k, v, lengths, block_k)
            else:
                ctx, _ = flash_attention_fwd(q, k, v, lengths, block_k)
        else:
            drop = dict(generator=generator, training=training)
            if sp > 1:
                k, v = seq_mesh.all_gather(k, 2), seq_mesh.all_gather(v, 2)
                shard = seq_mesh.dropout_shard()
            if shard is not None:
                drop["shard"] = shard
            scale = 1.0 / math.sqrt(d // h)
            logits = torch.einsum("bhqd,bhkd->bhqk", wide(q), wide(k)) * scale
            if key_valid is not None:
                logits = logits.masked_fill(~key_valid[:, None, None, :], NEG_INF)
            weights = torch.softmax(logits, dim=-1)
            weights = dropout(weights, dropout_rate, **drop)
            # P rounded to cd, the product summed in f32 and rounded once:
            # JAX's preferred_element_type=f32
            ctx = torch.einsum("bhqk,bhkd->bhqd", wide(weights.to(cd)),
                               wide(v)).to(cd)
        ctx = ctx.transpose(1, 2).reshape(b, nq, d)
        return linear_apply(self.out, ctx, cd).to(query.dtype)
