"""Masking utilities for statically-shaped padded patch bags
(counterpart of `paths_tpu.ops.masking`)."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # large finite negative; avoids NaN from (-inf) - (-inf)


def masked_topk(values: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k over the last axis considering only `mask`-valid entries.

    Returns `(indices, valid)`: `indices` is (..., k) int64 and `valid` is
    (..., k) bool, False for slots beyond the number of valid entries.
    Invalid entries are pushed to NEG_INF so they are selected only after
    every valid entry. Ties go to the LOWEST index, as `lax.top_k` does:
    `torch.topk` promises no tie order, so this is a stable descending sort.
    """
    masked = torch.where(mask, values, torch.full_like(values, NEG_INF))
    idx = torch.sort(masked, dim=-1, descending=True, stable=True).indices[..., :k]
    return idx, torch.gather(mask, -1, idx)
