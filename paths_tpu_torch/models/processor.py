"""PATHS processor: the per-magnification-level module (counterpart of
`paths_tpu.models.processor`). All levels share one LSTM cell, passed in.

Per level:
  1. LSTM: thread per-patch hierarchical context; Y = X + h
  2. importance alpha = sigmoid(MLP(Y)), exactly 0 on padding
  3. Z = Y * alpha  (importance_mode="mul")
  4. project + positional encoding (1d by bag position / 2d by patch coords)
  5. transformer aggregation via special token -> slide feature
  6. residual slide context; linear head -> logits
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from paths_tpu_torch.config import Config, PATHSProcessorConfig
from paths_tpu_torch.models.aggregator import Aggregator
from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.nn.core import MLP, linear_apply, make_linear, sigmoid, wide
from paths_tpu_torch.nn.lstm import LSTMCell, lstm_cell_apply


class Processor(nn.Module):
    def __init__(self, config: PATHSProcessorConfig, train_config: Config,
                 depth: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = config.patch_embed_dim
        cls_in = config.trans_dim * (depth + 1 if config.slide_ctx_mode == "concat"
                                     else 1)
        self.classification = make_linear(cls_in, train_config.num_logits(),
                                          generator=generator)
        self.importance_mlp = MLP([d, config.importance_mlp_hidden_dim, 1],
                                  generator=generator)
        self.agg = Aggregator(d, config.trans_dim, config.trans_heads,
                              config.trans_layers, generator=generator)
        if not config.lstm:
            self.hctx_mlp = MLP([d, config.hierarchical_ctx_mlp_hidden_dim, d],
                                generator=generator)


def processor_apply(proc: Processor, config: PATHSProcessorConfig,
                    train_config: Config, depth: int, bag: PatchBag, *,
                    lstm: Optional[LSTMCell] = None, training: bool = False,
                    generator: Optional[torch.Generator] = None,
                    seq_mesh=None) -> dict:
    """Process one level's bag -> {"logits": (B, C), "ctx_slide": (B, Ds),
    "ctx_patch": (B, N, Dp), "importance": (B, N)}. In training,
    `config.dropout` applies inside the aggregator only (as in the JAX
    package), with masks drawn from `generator`.

    With `seq_mesh` the bag is this rank's block of a sequence-parallel
    level 0 (`models/batch.py`): the per-patch work (LSTM cell, importance,
    positional encoding) runs on the block's rows alone, the aggregator
    meets the group, and "ctx_patch" / "importance" are the block's while
    "logits" / "ctx_slide" are the whole bag's, the same on every rank."""
    cd = getattr(torch, train_config.compute_dtype)
    fts = bag.fts
    b, n, d = fts.shape
    mask = bag.mask
    hdim = config.hierarchical_ctx_mlp_hidden_dim

    # ---- LSTM hierarchical context
    if config.lstm:
        if lstm is None:
            raise ValueError("lstm=True needs the shared LSTM cell")
        if depth == 0:
            hs = fts.new_zeros((b, n, d))
            cs = fts.new_zeros((b, n, hdim))
        else:
            state = bag.ctx_patch[:, :, -1]
            hs, cs = state[..., :d], state[..., d:]
        hs, cs = lstm_cell_apply(lstm, fts, hs, cs, cd)
        fts = fts + hs  # Y = X + h
        patch_ctx = torch.cat([hs, cs], dim=-1)

    # ---- importance; exactly 0 on padding
    imp = sigmoid(proc.importance_mlp(fts, cd))[..., 0]
    importance = torch.where(mask, imp.to(fts.dtype), 0.0)
    if config.importance_mode == "mul":
        fts = fts * importance[..., None]  # Z = Y * alpha

    # ---- RNN-style context when not using the LSTM
    if not config.lstm:
        if depth > 0 and config.hierarchical_ctx:
            hctx = proc.hctx_mlp(bag.ctx_patch[:, :, -1], cd).to(fts.dtype)
            fts = fts + torch.where(mask[..., None], hctx, 0.0)
        patch_ctx = fts

    # ---- positional encoding + projection
    if config.pos_encoding_mode == "1d":
        # a block's row 0 is patch index * m - 1 (the special token's row on
        # index 0, whose encoding the token replaces)
        start = seq_mesh.index * n - 1 if seq_mesh is not None else 0
        xs = proc.agg.pos_encode_1d(fts, cd, start=start)
    elif config.pos_encoding_mode == "2d":
        xs = proc.agg.pos_encode_2d(fts, bag.locs // config.patch_size, cd)
    else:
        raise NotImplementedError(
            f"pos_encoding_mode={config.pos_encoding_mode!r}: 1d or 2d")

    # ---- aggregate over an empty conditional sequence
    cond = xs.new_zeros((b, 0, config.trans_dim))
    slide_features = proc.agg(cond, xs, None, mask,
                              dropout_rate=config.dropout,
                              generator=generator, training=training,
                              compute_dtype=cd,
                              impl=train_config.attention_impl,
                              seq_mesh=seq_mesh)

    # ---- residual slide context
    if config.slide_ctx_mode == "residual" and bag.ctx_depth > 0:
        slide_features = slide_features + bag.ctx_slide[:, -1]

    # ---- logits
    if config.slide_ctx_mode == "concat":
        ft = torch.cat([bag.ctx_slide.reshape(b, -1), slide_features], dim=1)
    else:
        ft = slide_features
    logits = linear_apply(proc.classification, ft, cd)

    return {"logits": wide(logits), "ctx_slide": slide_features,
            "ctx_patch": patch_ctx, "importance": importance}
