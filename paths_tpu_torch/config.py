"""Experiment configuration.

The port's own copy of `paths_tpu.config`: the same dataclasses, fields,
defaults and normalisation rules, so one `config.json` loads in both
packages. A `config.json` inside a model directory is parsed into
dataclasses; scalar `top_k_patches` / `batch_size` entries are broadcast to
per-level lists; `lstm=True` requires `hierarchical_ctx=True`; unknown keys
raise.

Fields that select JAX-side machinery (`mesh_shape`, `seq_attention`,
`remat`, `prng_impl`, `checkpoint_backend`, the streaming engine) are kept
so that configs stay interchangeable; the port reads only what the serving
path uses and refuses the values it has not ported yet where it meets them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class PATHSProcessorConfig:
    """Per-magnification-level model hyperparameters."""

    hierarchical_ctx: bool = True
    slide_ctx_mode: str = "residual"  # residual / concat / none

    patch_embed_dim: int = 1024
    dropout: float = 0.0
    patch_size: int = 256  # only needed for visualisation / preprocessing

    importance_mode: str = "mul"  # mul / none

    trans_dim: int = 192
    trans_heads: int = 4
    trans_layers: int = 2
    pos_encoding_mode: str = "1d"  # 1d / 2d / none

    importance_mlp_hidden_dim: int = 128
    hierarchical_ctx_mlp_hidden_dim: int = 256
    lstm: bool = True

    def ctx_dim(self) -> Tuple[int, int]:
        """(slide ctx dim, patch ctx dim)."""
        if self.lstm:
            return self.trans_dim, self.patch_embed_dim + self.hierarchical_ctx_mlp_hidden_dim
        return self.trans_dim, self.patch_embed_dim


@dataclass
class Config:
    """Task / recursion / training / data configuration."""

    model_config: PATHSProcessorConfig

    # Recursion
    base_power: float = 0.625
    magnification_factor: int = 2
    num_levels: int = 5
    num_epochs: int = 40
    top_k_patches: List[int] = field(default_factory=lambda: [20, 20, 20, 20])

    model_type: str = "PATHS"

    # Data
    wsi_dir: str = ""
    csv_path: str = ""
    nbins: int = 4
    loss: str = "nll"

    task: str = "survival"  # survival / subtype_classification
    filter_to_subtypes: Optional[List[str]] = None

    preprocess_dir: Optional[str] = None

    # Training
    batch_size: List[int] = field(default_factory=lambda: [32])
    save_epochs: int = 10
    eval_epochs: int = 1
    lr: float = 2e-5
    lr_decay_per_epoch: float = 0.99
    seed: int = 0
    early_stopping: bool = False
    weight_decay: float = 1e-2
    min_epochs: int = 0

    root_name: str = ""

    clip_grad_norm: Optional[float] = None

    hipt_splits: bool = False
    hipt_val_proportion: float = 0.0
    splits_dir: Optional[str] = None

    # dtype of matmuls and attention ("float32" or "bfloat16"); params are f32
    compute_dtype: str = "float32"
    # aggregator self-attention: "xla" = plain PyTorch attention, "pallas" =
    # the hand-written masked flash-attention kernel
    # (`paths_tpu_torch/kernels/flash_attention.py`), "auto" = the kernel for
    # bags of `nn.attention.AUTO_PALLAS_MIN_LEN` keys or more on CUDA. The
    # value names are shared with the JAX package so config files work in both.
    attention_impl: str = "xla"
    # dtype of feature tables / bags on the device ("float32" or "bfloat16")
    table_dtype: str = "float32"
    # "fused": whole-batch tables resident on the device (the only engine
    # ported so far)
    engine: str = "fused"
    # level-0 bags are padded up to a multiple of this
    level0_bucket: int = 256
    cache_eval_batches: bool = False
    # pad every batch to dataset-global shape maxima
    static_shapes: bool = True
    mesh_shape: Optional[List[int]] = None
    seq_attention: str = "gathered"
    remat: bool = False
    prng_impl: str = "auto"
    checkpoint_backend: str = "npz"

    def __post_init__(self):
        if isinstance(self.top_k_patches, int):
            self.top_k_patches = [self.top_k_patches] * (self.num_levels - 1)
        if isinstance(self.batch_size, int):
            self.batch_size = [self.batch_size] * self.num_levels
        if isinstance(self.num_epochs, list):
            self.num_epochs = self.num_epochs[0]
        if isinstance(self.model_config, dict):
            self.model_config = PATHSProcessorConfig(**self.model_config)
        if self.model_config.lstm and not self.model_config.hierarchical_ctx:
            raise ValueError(
                "If LSTM mode is enabled, hierarchical context must be enabled.")
        if self.magnification_factor != 2:
            print(f"WARNING: magnification_factor={self.magnification_factor}"
                  " is not honored: the preprocessed hierarchy is fixed at x2")

    # ------------------------------------------------------------------ I/O

    @staticmethod
    def load(root_path: str, test_mode: bool = False) -> "Config":
        """Load `<root_path>/config.json`."""
        jsonpath = os.path.join(root_path, "config.json")
        if not os.path.isdir(root_path):
            raise FileNotFoundError(f"Model directory '{root_path}' not found!")
        if not os.path.isfile(jsonpath):
            raise FileNotFoundError(f"config.json not found in '{root_path}'.")

        with open(jsonpath, "r") as f:
            data = json.load(f)

        if data.get("model_type", "PATHS") != "PATHS":
            raise NotImplementedError(f"Unknown model type '{data['model_type']}'")

        known = {f.name for f in dataclasses.fields(Config)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")

        config = Config(**data)

        if (not test_mode and config.preprocess_dir is not None
                and not os.path.isdir(config.preprocess_dir)):
            raise FileNotFoundError(
                f"Preprocessing root directory '{config.preprocess_dir}' not found!")
        return config

    def save(self, root_path: str) -> None:
        os.makedirs(root_path, exist_ok=True)
        with open(os.path.join(root_path, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    # ------------------------------------------------------------- helpers

    def power_levels(self) -> List[float]:
        """Magnification of each level."""
        return [self.base_power * self.magnification_factor**i for i in range(self.num_levels)]

    def num_logits(self) -> int:
        if self.task == "survival":
            return self.nbins
        if not self.filter_to_subtypes:
            raise ValueError("subtype task requires filter_to_subtypes")
        return len(self.filter_to_subtypes)


def power_str(power: float) -> str:
    """Canonical 3-decimal magnification suffix used in preprocessed file
    names (`{slide_id}_{power:.3f}`)."""
    return f"{power:.3f}"
