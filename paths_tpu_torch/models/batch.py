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


def pad_bag(bag: PatchBag, width: int) -> PatchBag:
    """Zero-pad the patch axis to `width` (mask False on the padding; a bag
    at least that wide is returned as it is). Padded rows are inert through
    every processor op, so this changes shapes only: callers pad to a few
    widths, so that the kernels see few shapes."""
    pad = width - bag.fts.shape[1]
    if pad <= 0:
        return bag

    def z(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                         dim=1)

    return dataclasses.replace(
        bag, fts=z(bag.fts), locs=z(bag.locs), mask=z(bag.mask),
        parent_inds=z(bag.parent_inds), ctx_patch=z(bag.ctx_patch))
