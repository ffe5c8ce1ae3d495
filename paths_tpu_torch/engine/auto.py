"""`config.engine="auto"`: pick fused or streaming from a device-memory
estimate (counterpart of `paths_tpu.engine.auto`).

The fused engine holds every level's collated feature tables on the card:
fastest when they fit, out of memory when they don't. The streaming engine
keeps the deeper tables on the host. "auto" prices the fused engine from the
`global_pads` scan that static shapes already do:

  bytes(one collated batch at global pads)  x  RESIDENCY_FACTOR
      <=  HBM_FRACTION x device memory  -  PARAM_RESERVE    ->  fused
  otherwise                                                 ->  streaming

RESIDENCY_FACTOR covers what lives beside one batch's tables during a train
step: the prefetched next batch, plus activation and gradient headroom of
the same order as the tables. PARAM_RESERVE covers parameters, AdamW state
and the allocator's scratch. The estimate prices only what scales with the
dataset and errs toward streaming near the boundary: crossing it the other
way is an out-of-memory error mid-run.

A rank prices its own share: under a data mesh ceil(B / dp) slides (the
caller's `batch_size`), and under sequence parallelism (`sp` > 1) only its
block of m = ceil((n0 + 1) / sp) level-0 rows, plus under the gathered
schedule the K and V that each decoder layer gathers over the whole
sequence and keeps for the backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.engine.tables import as_torch_dtype, bag_widths
from paths_tpu_torch.models.batch import seq_block_width

RESIDENCY_FACTOR = 3.0   # live batch + prefetched batch + backward headroom
HBM_FRACTION = 0.85      # leave the caching allocator slack
PARAM_RESERVE = 512 << 20
DEFAULT_HBM = 80 << 30   # one H100's 80 GB, where the device cannot say


def _round_up(n: int, m: int) -> int:
    return m * ((n + m - 1) // m)


def estimate_fused_batch_bytes(config: Config, pads: dict,
                               batch_size: int, sp: int = 1) -> int:
    """Bytes of ONE fused-engine collated batch at dataset-global pads.

    Mirrors `data.dataset.collate_batch`'s shapes as the JAX package counts
    them: level-0 PatchBag (fts/locs/mask/ctx) and per-level LevelTables
    (fts/locs/index/count/grid_hw), with the same bucketing. With `sp` > 1,
    one sequence rank's share (module docstring)."""
    mc = config.model_config
    d = mc.patch_embed_dim
    item = as_torch_dtype(config.table_dtype).itemsize
    b = batch_size

    n0 = _round_up(pads["n0"], config.level0_bucket)
    rows0 = seq_block_width(n0, sp) if sp > 1 else n0
    ds_dim, dp_dim = mc.ctx_dim()
    depth = config.num_levels  # ctx stacks grow to num_levels-1; bound
    total = b * rows0 * (d * item        # bag0.fts
                         + 2 * 4 + 1     # locs + mask
                         + depth * dp_dim * item)   # ctx_patch (worst level)
    total += b * depth * ds_dim * item           # ctx_slide
    if sp > 1 and config.seq_attention == "gathered":
        cd = as_torch_dtype(config.compute_dtype).itemsize
        total += b * 2 * sp * rows0 * mc.trans_dim * cd * mc.trans_layers

    widths = bag_widths(config.top_k_patches, config.num_levels, n0)
    for lvl in range(1, config.num_levels):
        rows = _round_up(max(widths[lvl], pads["rows"][lvl]), 256)
        h = _round_up(pads["grid_hw"][lvl][0], 16)
        w = _round_up(pads["grid_hw"][lvl][1], 16)
        total += b * rows * (d * item + 2 * 4)   # table fts + locs
        total += b * (h * w * 4 + 4 + 8)         # index + count + grid_hw
    return int(total)


def hbm_bytes(device="cuda", default: int = DEFAULT_HBM) -> int:
    """The device's memory: a CUDA device's total memory, else `default`."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return default


def resolve_engine(config: Config, pads: Optional[dict], batch_size: int,
                   hbm: Optional[int] = None, verbose: bool = True,
                   device="cuda", sp: int = 1) -> str:
    """The engine `train_loop` and serving should use. Pass-through unless
    `config.engine == "auto"`; then fused iff the estimated batch residency
    (of a sequence rank's share when `sp` > 1) fits the budget of `device`
    (or of `hbm` bytes). Prints the decision and the numbers it was made
    from."""
    if config.engine != "auto":
        return config.engine
    if pads is None:
        # no global-pads scan to price from: the choice that never runs out
        if verbose:
            print("engine=auto: no shape bounds available -> streaming")
        return "streaming"
    hbm = hbm_bytes(device) if hbm is None else hbm
    batch = estimate_fused_batch_bytes(config, pads, batch_size, sp)
    need = RESIDENCY_FACTOR * batch
    budget = HBM_FRACTION * hbm - PARAM_RESERVE
    choice = "fused" if need <= budget else "streaming"
    if verbose:
        print(f"engine=auto: batch tables ~{batch / 2**20:.0f} MB, "
              f"residency ~{need / 2**20:.0f} MB vs budget "
              f"{budget / 2**20:.0f} MB (HBM {hbm / 2**30:.1f} GiB) "
              f"-> {choice}")
    return choice
