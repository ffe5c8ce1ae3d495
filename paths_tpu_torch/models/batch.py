"""PatchBag: the statically-shaped batch of one hierarchy level
(counterpart of `paths_tpu.models.batch`).

  fts         (B, N, D)         patch features; padding rows are zeros
  locs        (B, N, 2)         pixel coords at the current magnification
  mask        (B, N)  bool      True = real patch
  parent_inds (B, N)  int64     index into the previous level's bag
  ctx_slide   (B, depth, Ds)    slide-level context stack
  ctx_patch   (B, N, depth, Dp) per-patch hierarchical context

Under sequence parallelism (`parallel/seq_attention.py`) a level-0 bag is one
rank's block of the aggregator's sequence [special token, patch 0 ... patch
n-1], padded with masked rows to sp * m rows and cut into contiguous blocks
of m = `seq_block_width(n, sp)`: rank s holds rows [s m, (s + 1) m), so row 0
of rank 0 stands for the special token (masked here) and row j of rank s is
patch s m + j - 1. `patch_width` is then the whole bag's n; it is None for a
whole bag.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class PatchBag:
    fts: torch.Tensor
    locs: torch.Tensor
    mask: torch.Tensor
    parent_inds: torch.Tensor
    ctx_slide: torch.Tensor
    ctx_patch: torch.Tensor
    patch_width: Optional[int] = None

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


def seq_block_width(n: int, sp: int) -> int:
    """m: rows of one rank's block of a sequence of a special token and n
    patches cut into sp blocks."""
    return -(-(n + 1) // sp)


def shard_bag_patches(bag: PatchBag, index: int, sp: int) -> PatchBag:
    """Rank `index`'s block of a whole level-0 bag (the layout in the module
    docstring): a zero, masked row before patch 0 and zero rows after the
    last, then rows [index m, (index + 1) m)."""
    n = bag.fts.shape[1]
    m = seq_block_width(n, sp)
    lo = index * m

    def block(x: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[0], 1) + x.shape[2:]
        tail = (x.shape[0], sp * m - n - 1) + x.shape[2:]
        full = torch.cat([x.new_zeros(shape), x, x.new_zeros(tail)], dim=1)
        return full[:, lo: lo + m]

    return PatchBag(fts=block(bag.fts), locs=block(bag.locs),
                    mask=block(bag.mask), parent_inds=block(bag.parent_inds),
                    ctx_slide=bag.ctx_slide, ctx_patch=block(bag.ctx_patch),
                    patch_width=n)
