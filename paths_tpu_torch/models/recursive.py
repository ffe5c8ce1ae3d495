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
                    bag: PatchBag) -> dict:
    """Dispatch to the depth-th processor."""
    return processor_apply(model.procs[depth], config.model_config, config,
                           depth, bag, lstm=getattr(model, "lstm", None))
