"""PatchBag: the statically-shaped batch of one hierarchy level
(counterpart of `paths_tpu.models.batch`).

  fts         (B, N, D)         patch features; padding rows are zeros
  locs        (B, N, 2)         pixel coords at the current magnification
  mask        (B, N)  bool      True = real patch
  parent_inds (B, N)  int64     index into the previous level's bag
  ctx_slide   (B, depth, Ds)    slide-level context stack
  ctx_patch   (B, N, depth, Dp) per-patch hierarchical context
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PatchBag:
    fts: torch.Tensor
    locs: torch.Tensor
    mask: torch.Tensor
    parent_inds: torch.Tensor
    ctx_slide: torch.Tensor
    ctx_patch: torch.Tensor

    @property
    def ctx_depth(self) -> int:
        return self.ctx_slide.shape[1]
