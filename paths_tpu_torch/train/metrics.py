"""Host-side post-processing of predictions (counterpart of the serving
part of `paths_tpu.train.metrics`)."""
from __future__ import annotations

import numpy as np


def survival_risk(hazards: np.ndarray) -> np.ndarray:
    """Risk score from per-bin hazards: -sum of the survival curve
    cumprod(1 - h) over bins. Accepts (nbins,) or (B, nbins)."""
    h = np.asarray(hazards, np.float64)
    return -np.cumprod(1.0 - h, axis=-1).sum(axis=-1)


def class_probs(logits: np.ndarray) -> np.ndarray:
    """Stable softmax over the last axis."""
    x = np.asarray(logits, np.float64)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
