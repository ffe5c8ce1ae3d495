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

from paths_tpu_torch.kernels.flash_attention import masked_flash_attention_fwd
from paths_tpu_torch.nn.core import make_linear
from paths_tpu_torch.ops.masking import NEG_INF

# "auto" engages the flash kernel at and above this many keys, on CUDA only.
# Not yet measured on this card: the value is a placeholder until the kernel
# and the plain path are timed against each other across bag lengths.
AUTO_PALLAS_MIN_LEN = 4096


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
                compute_dtype: Optional[torch.dtype] = None,
                impl: str = "xla") -> torch.Tensor:
        """`mha_apply`: query (B, Nq, D), key/value (B, Nk, D), key_valid
        (B, Nk) bool (True = attendable) -> (B, Nq, D).

        impl "pallas" runs self-attention (Nq == Nk) through the hand-written
        flash kernel; "auto" does so at >= AUTO_PALLAS_MIN_LEN keys on CUDA.
        The kernel takes a PREFIX mask (valid keys first, as compacted bags
        are), so lengths are `key_valid.sum(-1)`. The port has no dropout at
        inference; training with attention dropout will take the plain path,
        as the JAX package does.

        With an empty memory (Nk == 0) the context is zero and the result is
        the broadcast out-projection bias, torch's behaviour for a
        zero-length memory.
        """
        h = self.num_heads
        b, nq, d = query.shape
        nk = key.shape[1]
        if nk == 0:
            return self.out.bias.to(query.dtype).expand(b, nq, d)

        cd = compute_dtype or query.dtype

        def heads(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
            y = torch.nn.functional.linear(x.to(cd), lin.weight.to(cd),
                                           lin.bias.to(cd))
            return y.reshape(b, -1, h, d // h).transpose(1, 2)  # B,H,N,hd

        q, k, v = heads(self.q, query), heads(self.k, key), heads(self.v, value)

        use_kernel = nq == nk and (impl == "pallas" or (
            impl == "auto" and nk >= AUTO_PALLAS_MIN_LEN and query.is_cuda))
        if use_kernel:
            lengths = (key_valid.sum(dim=-1, dtype=torch.int32)
                       if key_valid is not None
                       else torch.full((b,), nk, dtype=torch.int32,
                                       device=query.device))
            ctx, _ = masked_flash_attention_fwd(
                q.contiguous(), k.contiguous(), v.contiguous(), lengths)
        else:
            scale = 1.0 / math.sqrt(d // h)
            logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
            if key_valid is not None:
                logits = logits.masked_fill(~key_valid[:, None, None, :], NEG_INF)
            weights = torch.softmax(logits, dim=-1)
            ctx = torch.einsum("bhqk,bhkd->bhqd", weights.to(cd), v).to(cd)
        ctx = ctx.transpose(1, 2).reshape(b, nq, d)
        return torch.nn.functional.linear(
            ctx.to(cd), self.out.weight.to(cd), self.out.bias.to(cd)
        ).to(query.dtype)
