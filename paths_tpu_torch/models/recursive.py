"""RecursiveModel: one processor per hierarchy level plus the shared LSTM
cell (counterpart of `paths_tpu.models.recursive`). Module names mirror the
JAX params tree (`procs/<depth>/...`, `lstm/...`), which is what lets
`paths_tpu_torch.convert` map one onto the other key by key."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.config import Config
from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.models.processor import Processor, processor_apply
from paths_tpu_torch.nn.lstm import LSTMCell


class RecursiveModel(nn.Module):
    def __init__(self, config: Config, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mc = config.model_config
        self.procs = nn.ModuleList(
            Processor(mc, config, depth=i, generator=generator)
            for i in range(config.num_levels))
        if mc.lstm:
            self.lstm = LSTMCell(mc.patch_embed_dim, mc.patch_embed_dim,
                                 mc.hierarchical_ctx_mlp_hidden_dim,
                                 generator=generator)


def recursive_apply(model: RecursiveModel, config: Config, depth: int,
                    bag: PatchBag, *, training: bool = False,
                    generator: Optional[torch.Generator] = None,
                    seq_mesh=None) -> dict:
    """Dispatch to the depth-th processor (`seq_mesh`: `processor_apply`)."""
    return processor_apply(model.procs[depth], config.model_config, config,
                           depth, bag, lstm=getattr(model, "lstm", None),
                           training=training, generator=generator,
                           seq_mesh=seq_mesh)


def narrow_params(model: RecursiveModel, config: Config) -> list:
    """The parameters whose gradient on a rank is a value of
    `config.compute_dtype` when that is narrower than f32: those the forward
    casts to it once a step (every Linear weight and bias of the
    processors, the special tokens). Not the LayerNorms, which normalise in
    f32, nor the shared LSTM cell, cast once per level, whose gradient is
    the f32 sum of one cast's per level. Empty in f32
    (`parallel.mesh.all_reduce_grads`)."""
    if getattr(torch, config.compute_dtype).itemsize >= 4:
        return []
    norms = {p for m in model.procs.modules() if isinstance(m, nn.LayerNorm)
             for p in m.parameters(recurse=False)}
    return [p for p in model.procs.parameters() if p not in norms]
