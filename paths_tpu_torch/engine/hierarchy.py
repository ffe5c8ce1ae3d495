"""The hierarchy engine: PATHS's magnification recursion as tensor ops
batched over slides (counterpart of `paths_tpu.engine.hierarchy`).

  level i forward -> masked top-K -> x4 child expansion -> bounds and
  background masking via the index grid -> feature-table gather -> stable
  compaction -> level i+1 forward ...

Edge cases follow the JAX package: bags smaller than K, out-of-bounds
children, and the all-background fallback (every non-background patch of
the next grid, or raw grid cells when it has none), capped at 4K patches.
Exact importance ties select the LOWEST bag index.

With `config.remat`, each level's forward runs under
`torch.utils.checkpoint` and is recomputed in the backward, as the JAX
package wraps each level in `jax.checkpoint`: the activations held between
forward and backward are the levels' inputs, not their internals.

Under sequence parallelism (`seq_mesh`, `parallel/seq_attention.py`) the
level-0 bag is this rank's block (`models/batch.py`) and the recursion is
partitioned by hand, where JAX leaves it to GSPMD: level 0 runs on the
block, its importance, mask and coordinates are all-gathered so that every
rank of the group runs the same masked top-K over the whole bag (ties to the
lowest global index), the kept rows' contexts are taken from the ranks that
hold them by a differentiable sum over the group, and the levels >= 1 run
whole on every rank. A remat recompute issues its level's collectives again,
in the same order on every rank.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from paths_tpu_torch.config import Config
from paths_tpu_torch.engine.tables import LevelTable
from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.models.recursive import RecursiveModel, recursive_apply
from paths_tpu_torch.ops.losses import cross_entropy_loss, nll_survival_loss
from paths_tpu_torch.ops.masking import masked_topk

def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along axis 1 with a (B, S) index, broadcasting trailing dims."""
    idx = idx.reshape(idx.shape + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, idx.expand(*idx.shape[:2], *a.shape[2:]))


def _compact(mask: torch.Tensor, *arrays):
    """Stable-partition valid entries to the front of the patch axis (the
    order is visible to 1D positional encodings). Returns (new_mask,
    permuted arrays...)."""
    perm = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)
    return (torch.gather(mask, 1, perm), *(_take(a, perm) for a in arrays))


def gather_level0(bag: PatchBag, out: dict, seq_mesh) -> dict:
    """A sequence-parallel rank's level-0 output with the whole bag's (B, n)
    "importance", "mask" and (B, n, 2) "locs" all-gathered from the group in
    one collective (no gradient: the top-K reads them); "ctx_patch" stays the
    block's."""
    n = bag.patch_width
    packed = torch.cat([out["importance"][..., None].double(),
                        bag.mask[..., None].double(), bag.locs.double()], -1)
    whole = seq_mesh.gather(packed, 1)[:, 1: n + 1]   # drop the special row
    return {**out, "importance": whole[..., 0].to(out["importance"].dtype),
            "mask": whole[..., 1] > 0.5, "locs": whole[..., 2:].long()}


def select_children(bag: PatchBag, out: dict, k: int, patch_size: int,
                    seq_mesh=None) -> dict:
    """Append context, masked top-K, x4 child expansion. Returns the
    pre-lookup intermediates. With `seq_mesh`, `bag` is a level-0 block and
    `out` comes from `gather_level0`."""
    dev = bag.fts.device
    mask, locs = bag.mask, bag.locs
    if seq_mesh is not None:
        mask, locs = out["mask"], out["locs"]
    b, n = mask.shape

    ctx_slide = torch.cat([bag.ctx_slide, out["ctx_slide"][:, None]], dim=1)
    ctx_patch = torch.cat([bag.ctx_patch, out["ctx_patch"][:, :, None]], dim=2)

    # k == -1 keeps every patch in bag order; any finite K goes through
    # top-K even when K >= N, since kept patches are reordered by importance
    if k == -1:
        k = n
        idx = torch.arange(n, device=dev).expand(b, n)
        kvalid = mask
    else:
        k = min(k, n)
        idx, kvalid = masked_topk(out["importance"], mask, k)

    kept_locs = _take(locs // patch_size, idx)
    if seq_mesh is None:
        kept_ctx = _take(ctx_patch, idx)
    else:
        # patch p is row p + 1 of the sequence: row (p + 1) % m of index
        # (p + 1) // m; each rank takes the kept rows it holds, and the sum
        # over the group (one term each) assembles them on every rank
        m = bag.mask.shape[1]
        mine = (idx + 1) // m == seq_mesh.index
        own = _take(ctx_patch, torch.where(mine, (idx + 1) % m, 0))
        kept_ctx = seq_mesh.sum(torch.where(mine[..., None, None], own, 0.0))

    # child quadrant offsets (0,0), (0,1), (1,0), (1,1), in the order the
    # children are concatenated: groups [(2y,2x)], [(2y,2x+1)], [(2y+1,2x)],
    # [(2y+1,2x+1)]. Made on the device: a copy from the host would make the
    # host wait for the card at every level
    quad = torch.arange(4, device=dev)
    offsets = torch.stack([quad // 2, quad % 2], dim=-1).to(kept_locs.dtype)
    child_locs = ((kept_locs * 2)[:, None] + offsets[None, :, None]).reshape(b, 4 * k, 2)
    child_parent = torch.arange(k, device=dev).repeat(4)
    child_kvalid = kvalid.repeat(1, 4)

    return {"ctx_slide": ctx_slide, "kept_ctx": kept_ctx,
            "child_locs": child_locs, "child_parent": child_parent,
            "child_kvalid": child_kvalid}


def lookup_device(sel: dict, table: LevelTable) -> dict:
    """Feature lookup from a device-resident LevelTable: bounds and
    background masking via the index grid, gather, and the all-background
    fallback."""
    child_locs = sel["child_locs"]
    b, s, _ = child_locs.shape
    dev = child_locs.device

    y, x = child_locs[..., 0], child_locs[..., 1]
    gh, gw = table.grid_hw[:, 0:1], table.grid_hw[:, 1:2]
    in_bounds = (y >= 0) & (y < gh) & (x >= 0) & (x < gw)
    hp, wp = table.index.shape[1:]
    flat = y.clamp(0, hp - 1) * wp + x.clamp(0, wp - 1)
    rows = torch.gather(table.index.reshape(b, -1), 1, flat)
    valid = sel["child_kvalid"] & in_bounds & (rows >= 0)
    rows_safe = torch.where(valid, rows, 0)

    fts = _take(table.fts, rows_safe) * valid[..., None]
    parent = sel["child_parent"].expand(b, s)

    # all-background fallback: the first min(count, 4K) non-bg rows, or raw
    # grid cells when the grid is entirely background; its ctx_patch is
    # zeroed by finish_step
    if table.fts.shape[1] < s:
        raise ValueError(f"LevelTable must carry >= 4K rows (have "
                         f"{table.fts.shape[1]}, need {s}); stack with "
                         "min_rows=4*K")
    any_valid = valid.any(dim=1)
    hw = (gh * gw)[:, 0]
    fb_n = torch.where(table.count > 0, table.count, hw).clamp(max=s)
    fb_valid = torch.arange(s, device=dev)[None, :] < fb_n[:, None]
    fb_fts = table.fts[:, :s] * fb_valid[..., None]
    fb_locs = table.locs[:, :s]
    fb_parent = torch.arange(s, device=dev).expand(b, s)

    selm = any_valid[:, None]
    return {
        "mask": torch.where(selm, valid, fb_valid),
        "fts": torch.where(selm[..., None], fts, fb_fts),
        "locs": torch.where(selm[..., None], child_locs, fb_locs),
        "parent": torch.where(selm, parent, fb_parent),
        "use_fallback": ~any_valid,
    }


def finish_step(sel: dict, lookup: dict, patch_size: int) -> PatchBag:
    """Combine selection context with looked-up features into the next
    level's bag: tile/zero ctx, stable compaction, pixel locs."""
    new_ctx = sel["kept_ctx"][:, sel["child_parent"]]
    new_ctx = torch.where(lookup["use_fallback"][:, None, None, None],
                          0.0, new_ctx)
    new_mask, new_fts, new_locs, new_parent, new_ctx = _compact(
        lookup["mask"], lookup["fts"], lookup["locs"], lookup["parent"],
        new_ctx)
    return PatchBag(fts=new_fts, locs=new_locs * patch_size, mask=new_mask,
                    parent_inds=new_parent, ctx_slide=sel["ctx_slide"],
                    ctx_patch=new_ctx)


def hierarchy_step(bag: PatchBag, out: dict, table: LevelTable, k: int,
                   patch_size: int, seq_mesh=None) -> PatchBag:
    """Advance the recursion one level: `table` is level i+1's, `k` the
    top-K to keep (-1 = keep all); returns the level-(i+1) bag with 4*K
    patch slots (`seq_mesh`: `select_children`)."""
    sel = select_children(bag, out, k, patch_size, seq_mesh)
    return finish_step(sel, lookup_device(sel, table), patch_size)


def remat_level(model: RecursiveModel, config: Config, depth: int,
                bag: PatchBag, *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                seq_mesh=None) -> dict:
    """`recursive_apply` under `torch.utils.checkpoint`: the backward
    recomputes the level's forward. `preserve_rng_state` keeps only the
    global generators, and dropout draws from `generator`, so the recompute
    sets `generator` back to its state at the level's entry (the same masks
    as the forward) and afterwards to the state it found (where the forward
    left it: the next step draws what it would draw without remat)."""
    entry = generator.get_state() if generator is not None else None
    recompute = False

    def level(bag):
        nonlocal recompute
        if not recompute or generator is None:
            recompute = True
            return recursive_apply(model, config, depth, bag,
                                   training=training, generator=generator,
                                   seq_mesh=seq_mesh)
        found = generator.get_state()
        generator.set_state(entry)
        try:
            return recursive_apply(model, config, depth, bag,
                                   training=training, generator=generator,
                                   seq_mesh=seq_mesh)
        finally:
            generator.set_state(found)

    return checkpoint(level, bag, use_reentrant=False,
                      preserve_rng_state=False)


def end2end_forward(model: RecursiveModel, config: Config, bag0: PatchBag,
                    tables: List[LevelTable], *, training: bool = False,
                    generator: Optional[torch.Generator] = None,
                    seq_mesh=None) -> List[dict]:
    """Run all levels, returning each level's processor output plus the bag
    it was computed on (`"bag"` key). `tables[i]` feeds the transition from
    level i to i+1. In training, dropout masks come from `generator`. With
    `config.remat` and autograd on, each level is `remat_level`. With
    `seq_mesh`, `bag0` is this rank's level-0 block (module docstring) and
    level 0's "importance" is the whole bag's (`gather_level0`)."""
    apply = (remat_level if config.remat and torch.is_grad_enabled()
             else recursive_apply)
    outs = []
    bag = bag0
    for i in range(config.num_levels):
        seq = seq_mesh if i == 0 else None   # levels >= 1 run whole
        out = apply(model, config, i, bag, training=training,
                    generator=generator, seq_mesh=seq)
        if seq is not None:
            out = gather_level0(bag, out, seq)
        outs.append({**out, "bag": bag})
        if i != config.num_levels - 1:
            bag = hierarchy_step(bag, out, tables[i], config.top_k_patches[i],
                                 config.model_config.patch_size, seq)
    return outs


def task_loss(config: Config, logits: torch.Tensor, labels: dict,
              denom=None):
    """Final-level loss and prediction. labels: {"survival_bin",
    "censored"} or {"subtype"}, optionally with "weight"; `denom` is the
    global batch's weight sum when these rows are one rank's share."""
    weights = labels.get("weight")
    if config.task == "survival":
        pred = torch.sigmoid(logits)
        loss = nll_survival_loss(pred, labels["survival_bin"],
                                 labels["censored"], weights=weights,
                                 denom=denom)
    elif config.task == "subtype_classification":
        pred = logits
        loss = cross_entropy_loss(logits, labels["subtype"], weights=weights,
                                  denom=denom)
    else:
        raise ValueError(config.task)
    return loss, pred


def end2end_loss(model: RecursiveModel, config: Config, bag0: PatchBag,
                 tables: List[LevelTable], labels: dict, *,
                 training: bool = False,
                 generator: Optional[torch.Generator] = None, denom=None,
                 seq_mesh=None):
    """Forward through all levels and the final-level loss (`task_loss`,
    with `denom`). Returns (loss, aux) with aux = {"pred": hazards or
    logits, "logits", "importances": per-level (B, N) importances}
    (`seq_mesh`: `end2end_forward`)."""
    outs = end2end_forward(model, config, bag0, tables, training=training,
                           generator=generator, seq_mesh=seq_mesh)
    logits = outs[-1]["logits"]
    loss, pred = task_loss(config, logits, labels, denom)
    aux = {"pred": pred, "logits": logits,
           "importances": [o["importance"] for o in outs]}
    return loss, aux
