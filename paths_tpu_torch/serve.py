"""Serving session: slide ids in, predictions out (counterpart of the live
fused branch of `paths_tpu.serve`).

A session owns a feature store and a model. Each request is collated into
statically-shaped batches (the trainer's bucketed collation, store-wide pads
under `static_shapes`, power-of-two batch widths), placed on the device and
run through the hierarchical forward. The StableHLO-artifact, streaming and
multi-device branches of the JAX package are not ported yet.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from paths_tpu_torch.config import Config, power_str
from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.engine.hierarchy import end2end_forward
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.train.metrics import class_probs, survival_risk
from paths_tpu_torch.train.state import load_state


def prediction_rows(config: Config, slide_ids: Sequence[str],
                    pred: np.ndarray) -> List[dict]:
    """Per-slide prediction dicts. Survival: `risk` and per-bin `hazards`.
    Subtype: argmax `pred` and per-class `probs`."""
    rows = []
    for sid, p in zip(slide_ids, np.asarray(pred)):
        if config.task == "survival":
            rows.append({"slide_id": sid,
                         "risk": float(survival_risk(p)),
                         "hazards": [float(h) for h in p]})
        else:
            probs = class_probs(p)
            classes = config.filter_to_subtypes
            rows.append({"slide_id": sid,
                         "pred": classes[int(np.argmax(probs))],
                         "probs": {c: float(q) for c, q in zip(classes, probs)}})
    return rows


def store_slide_ids(store: FeatureStore, base_power: float) -> List[str]:
    """Slide ids with a base-power grid present in the store."""
    suffix = f"_{power_str(base_power)}"
    ids = set()
    for fn in os.listdir(store.root):
        stem, ext = os.path.splitext(fn)
        if ext in (".npy", ".pt") and stem.endswith(suffix):
            ids.add(stem[:-len(suffix)])
    return sorted(ids)


def serving_forward(model: RecursiveModel, config: Config, bag,
                    tables) -> dict:
    """Prediction-only forward (counterpart of `export.make_serving_fn`):
    {"pred", "logits", "importances"}; `pred` is hazards (sigmoid) for
    survival, raw logits for subtype classification."""
    outs = end2end_forward(model, config, bag, tables)
    logits = outs[-1]["logits"]
    pred = torch.sigmoid(logits) if config.task == "survival" else logits
    return {"pred": pred, "logits": logits,
            "importances": [o["importance"] for o in outs]}


class ServingSession:
    """Batched slide-level prediction over a feature store.

    :param model_dir: model directory (config.json + model.npz)
    :param store_root: feature-store root; defaults to the config's
        `preprocess_dir`
    :param batch_size: serving batch width (default: the config's)
    :param cache_slides: keep materialized slide tables in host RAM across
        requests
    :param device: where the model runs; "cuda" unless the caller asks for
        the CPU
    """

    def __init__(self, model_dir: str, store_root: str = None,
                 batch_size: int = None, cache_slides: bool = True,
                 device="cuda"):
        self.config = Config.load(model_dir, test_mode=True)
        if self.config.engine != "fused":
            raise NotImplementedError(
                f"engine={self.config.engine!r}: only the fused engine is "
                "ported")
        self.device = torch.device(device)
        self.model_dir = model_dir
        self.store = FeatureStore(store_root or self.config.preprocess_dir)
        self.slide_ids = store_slide_ids(self.store, self.config.base_power)
        self._dataset = SlideDataset(self.slide_ids, self.config, self.store,
                                     cache_slides=cache_slides)
        self._index: Dict[str, int] = {s: i for i, s in enumerate(self.slide_ids)}
        self._lock = threading.Lock()   # one batch on the device at a time
        # store-wide pads: every request of a batch width has one shape
        self._pads = (self._dataset.global_pads()
                      if self.config.static_shapes and self.slide_ids else None)
        self.batch_size = batch_size or self.config.batch_size[0]
        model = load_state(model_dir, RecursiveModel(self.config))
        self.model = model.to(self.device).eval().requires_grad_(False)

    def _pad_width(self, n: int) -> int:
        """Batch width for an n-slide chunk: the next power of two, capped
        at the session's batch size."""
        width = 1
        while width < min(n, self.batch_size):
            width *= 2
        return min(width, self.batch_size)

    def _run(self, indices: Sequence[int]) -> np.ndarray:
        """One device batch, padded by repeating the last slide. Returns the
        pred rows of `indices` only."""
        n = len(indices)
        padded = list(indices) + [indices[-1]] * (self._pad_width(n) - n)
        bag, tables = collate_batch(
            self._dataset, padded, level0_bucket=self.config.level0_bucket,
            pads=self._pads, device=self.device)
        with torch.inference_mode():
            out = serving_forward(self.model, self.config, bag, tables)
        return out["pred"][:n].float().cpu().numpy()

    def predict(self, slide_ids: Sequence[str]) -> List[dict]:
        """Predictions for `slide_ids`, in order. Raises KeyError for
        unknown slides."""
        missing = [s for s in slide_ids if s not in self._index]
        if missing:
            raise KeyError(f"unknown slide ids (not in store): {missing}")
        indices = [self._index[s] for s in slide_ids]
        preds = []
        with self._lock:
            for s in range(0, len(indices), self.batch_size):
                preds.append(self._run(indices[s: s + self.batch_size]))
        pred = np.concatenate(preds) if preds else np.zeros((0,))
        return prediction_rows(self.config, slide_ids, pred)
