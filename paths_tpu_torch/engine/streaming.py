"""Streaming execution: hierarchical training and serving for datasets whose
feature tables exceed the card's memory (counterpart of
`paths_tpu.engine.streaming`).

The fused engine (`hierarchy.py`) holds every level's `LevelTable` on the
device for the whole batch. The tables outgrow a card at higher base powers
or deeper hierarchies, while the *selected* bags stay small (4K patches per
level). This engine keeps the tables on the host (memory-mapped through the
feature store) and moves only what the recursion touches. Per level:

  1. the level's forward and `select_children` run on the card;
  2. the child coordinates and their validity (a few KB) come to the host in
     ONE device-to-host copy;
  3. the host gathers the child features from the slide tables
     (`lookup_host`, the numpy mirror of `hierarchy.lookup_device`);
  4. the gathered bag (4K x D) goes back to the card at the wire dtype
     (`tables.ship_at_wire_dtype`);
  5. `finish_step` builds the next level's bag.

One forward, not two: the JAX engine runs a selection pass and then replays
the recursion over the recorded lookups inside one jitted gradient, because
a jitted gradient cannot call back to the host mid-graph. PyTorch's tape
records the single forward as it runs, host lookups included, so
`loss_and_grad` is that forward with autograd on and one `backward()`: a
streaming train step launches the flash forward kernel once per decoder
layer per level (10 at the flagship), where JAX runs its forward twice. The
looked-up features are constants of the graph in both packages.

Dropout masks come from the caller's generator in the fused engine's level
order, so the two engines give the same results in training too.

With a (data x model) `mesh` (`parallel/mesh.py`), the level-0 bag is this
rank's block and level 0 runs over the sequence group as in the fused
engine (`hierarchy.py`); the host lookups of the levels >= 1 run alike on
every rank of the group, which all hold the same selections.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.engine.hierarchy import (
    finish_step,
    gather_level0,
    select_children,
    task_loss,
)
from paths_tpu_torch.engine.tables import host_stack_dtype, ship_at_wire_dtype
from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.models.recursive import RecursiveModel, recursive_apply
from paths_tpu_torch.parallel.mesh import seq_axis_size
from paths_tpu_torch.parallel.seq_attention import SeqSharding

def lookup_host(child_locs: np.ndarray, child_kvalid: np.ndarray,
                host_tables: Sequence[dict]) -> dict:
    """Numpy mirror of `hierarchy.lookup_device` over per-slide table dicts
    (as `build_level_table` makes them): bounds and background masking via
    the index grid, the gather, and the all-background fallback.

    The slides are gathered one after another on the calling thread: a
    slide's gather is 4K rows, too little work for the JAX package's pool of
    8 threads, which on the H100's host takes about three times as long
    (`chip_smoke.py`'s [streaming] lines time both)."""
    b, s, _ = child_locs.shape
    d = host_tables[0]["fts"].shape[1]
    fts = np.zeros((b, s, d),
                   host_stack_dtype([t["fts"].dtype for t in host_tables]))
    mask = np.zeros((b, s), bool)
    locs = np.zeros((b, s, 2), np.int32)
    parent = np.zeros((b, s), np.int32)
    use_fb = np.zeros((b,), bool)
    base_parent = np.tile(np.arange(s // 4, dtype=np.int32), 4)

    def gather_slide(j: int, t: dict) -> None:
        y, x = child_locs[j, :, 0], child_locs[j, :, 1]
        gh, gw = int(t["grid_hw"][0]), int(t["grid_hw"][1])
        inb = (y >= 0) & (y < gh) & (x >= 0) & (x < gw)
        yc = np.clip(y, 0, t["index"].shape[0] - 1)
        xc = np.clip(x, 0, t["index"].shape[1] - 1)
        rows = t["index"][yc, xc]
        valid = child_kvalid[j] & inb & (rows >= 0)

        if valid.any():
            # only the valid rows move (a third of the passes over the bag
            # that gathering every row and masking it takes)
            fts[j, valid] = t["fts"][rows[valid]]
            mask[j] = valid
            locs[j] = child_locs[j]
            parent[j] = base_parent
        else:
            use_fb[j] = True
            count = int(t["count"])
            fb_n = min(count if count > 0 else gh * gw, s)
            take = min(s, t["fts"].shape[0])
            fts[j, :take] = t["fts"][:take]
            locs[j, :take] = t["locs"][:take]
            mask[j] = np.arange(s) < fb_n
            fts[j] = fts[j] * mask[j][:, None]
            parent[j] = np.arange(s, dtype=np.int32)

    for j, t in enumerate(host_tables):
        gather_slide(j, t)
    return {"mask": mask, "fts": fts, "locs": locs, "parent": parent,
            "use_fallback": use_fb}


def coords_to_host(sel: dict):
    """(child_locs, child_kvalid) of a selection as numpy arrays, through ONE
    device-to-host copy: on the card each copy waits for the level's
    forward, and this wait sits on the critical path of every level."""
    packed = torch.cat([sel["child_locs"],
                        sel["child_kvalid"][..., None].to(sel["child_locs"].dtype)],
                       dim=-1).cpu().numpy()
    return packed[..., :2], packed[..., 2].astype(bool)


class StreamingEngine:
    """Streaming executor bound to a config, a device and, for sequence
    parallelism, a `ProcessMesh` with a `model` axis."""

    def __init__(self, config: Config, device="cuda", mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.seq_mesh = SeqSharding.from_mesh(mesh, config.seq_attention)
        self.grad_scale = 1.0 / seq_axis_size(mesh)

    def _put(self, host: dict) -> dict:
        """A lookup's host tensors on the device; int32 coordinates arrive
        as int64, the index dtype of the fused engine's tables."""
        dev = {k: v.to(self.device) for k, v in host.items()}
        dev["locs"] = dev["locs"].long()
        dev["parent"] = dev["parent"].long()
        return dev

    def forward(self, model: RecursiveModel, bag0: PatchBag,
                host_tables: List[List[dict]], *, training: bool = False,
                generator: Optional[torch.Generator] = None,
                record: bool = False):
        """Run the recursion; `host_tables[j][l]` is slide j's table for
        level l+1. Returns (outs, recorded): each level's processor output
        plus the bag it ran on (`"bag"`), and with `record` the device
        lookups that built each deeper bag."""
        cfg = self.config
        ps = cfg.model_config.patch_size
        bag = bag0
        outs, recorded = [], []
        for i in range(cfg.num_levels):
            seq = self.seq_mesh if i == 0 else None   # levels >= 1 run whole
            out = recursive_apply(model, cfg, i, bag, training=training,
                                  generator=generator, seq_mesh=seq)
            if seq is not None:
                out = gather_level0(bag, out, seq)
            outs.append({**out, "bag": bag})
            if i != cfg.num_levels - 1:
                sel = select_children(bag, out, cfg.top_k_patches[i], ps, seq)
                locs_h, kvalid_h = coords_to_host(sel)
                lk = lookup_host(locs_h, kvalid_h,
                                 [ts[i] for ts in host_tables])
                lk_dev = ship_at_wire_dtype(lk, cfg.table_dtype, self._put)
                if record:
                    recorded.append(lk_dev)
                bag = finish_step(sel, lk_dev, ps)
        return outs, recorded

    @torch.no_grad()
    def evaluate(self, model: RecursiveModel, bag0: PatchBag, host_tables,
                 labels: dict, denom=None):
        """Loss and prediction without dropout or gradient (`denom` as in
        `hierarchy.task_loss`)."""
        outs, _ = self.forward(model, bag0, host_tables)
        return task_loss(self.config, outs[-1]["logits"], labels, denom)

    def loss_and_grad(self, model: RecursiveModel, bag0: PatchBag,
                      host_tables, labels: dict, *, training: bool = True,
                      generator: Optional[torch.Generator] = None,
                      denom=None):
        """One forward with autograd on, then one backward. Returns (loss,
        pred, grads): detached loss and prediction, and the gradients by
        parameter name (also left in each parameter's `.grad`; the model's
        earlier gradients are cleared first). `denom` as in
        `hierarchy.task_loss`; under sequence parallelism the gradient is
        that of loss / sp (`parallel/mesh.py`)."""
        model.zero_grad(set_to_none=True)
        outs, _ = self.forward(model, bag0, host_tables, training=training,
                               generator=generator)
        loss, pred = task_loss(self.config, outs[-1]["logits"], labels, denom)
        (loss * self.grad_scale).backward()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        return loss.detach(), pred.detach(), grads
