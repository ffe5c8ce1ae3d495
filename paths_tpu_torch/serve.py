"""Serving session: slide ids in, predictions out (counterpart of the live
branches of `paths_tpu.serve`).

A session owns a feature store and a model. Each request is collated into
statically-shaped batches (the trainer's bucketed collation, store-wide pads
under `static_shapes`, power-of-two batch widths), placed on the device and
run through the hierarchical forward of the model's engine: fused (every
level's tables on the device), streaming (the level-0 bag on the device, the
deeper tables gathered on the host level by level) or auto (fused when the
store's fused batch fits the device's memory). A device-resident LRU keeps
the last few collated batches, so a repeated request skips collation and the
copy to the card. With `artifact=`, the session runs an exported serving
program (`paths_tpu_torch.export`) in place of the live forward, collated at
the program's own pads.

With `mesh=make_mesh(n)` a live fused session serves data parallel in one
process: one replica of the model per device, batch widths in multiples of
n, and each batch split into n contiguous shards, each collated and copied
to its own device and run by that device's replica; the predictions are
gathered in order.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np
import torch

from paths_tpu_torch.config import Config, power_str
from paths_tpu_torch.data.dataset import SlideDataset, collate_bag0, collate_batch
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.engine.auto import resolve_engine
from paths_tpu_torch.engine.streaming import StreamingEngine
from paths_tpu_torch.export import (
    bag_to_dict,
    make_serving_fn,
    prediction,
    tables_to_dicts,
)
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.parallel.mesh import Mesh, data_axis_size, place_replicas
from paths_tpu_torch.profiling import span
from paths_tpu_torch.train.metrics import class_probs, survival_risk
from paths_tpu_torch.train.state import load_model


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
    """Prediction-only forward over a `PatchBag` and `LevelTable`s: the
    function that `export.export_serving` traces (`make_serving_fn`),
    {"pred", "logits", "importances"}; `pred` is hazards (sigmoid) for
    survival, raw logits for subtype classification."""
    return make_serving_fn(config)(model, bag_to_dict(bag),
                                   tables_to_dicts(tables))


class ServingSession:
    """Batched slide-level prediction over a feature store.

    :param model_dir: model directory (config.json + model.npz, or the
        reference's model.pt)
    :param store_root: feature-store root; defaults to the config's
        `preprocess_dir`
    :param batch_size: serving batch width (default: the config's)
    :param cache_slides: keep materialized slide tables in host RAM across
        requests. A miss copies each slide's rows straight into its row of
        the batch on the card, without a host stack: from pageable memory
        at a slide's first request, and from page-locked memory, locked at
        its second, after that (`SlideDataset`); the locked host RAM is the
        reused slides' feature bytes at the wire dtype, each block rounded
        up to a power of two by torch's page-locked allocator, up to a
        quarter of the host's memory
    :param cache_batches: keep up to this many collated batches on the
        device, keyed by their padded slide indices: a repeated request then
        skips collation and the copy to the card, the dominant serving cost,
        and pays only the forward. 0 disables.
    :param device: where the model runs; "cuda" unless the caller asks for
        the CPU
    :param artifact: path of a `cli.export` artifact with a program for
        `device`'s platform: requests run through it, collated to its
        export-time shapes (a fixed-batch artifact always runs its batch; a
        `poly_batch` one pads to power-of-two widths up to `batch_size`). A
        weights-as-arguments artifact takes its weights from `model_dir`.
    :param mesh: a `parallel.mesh.make_mesh` data mesh (live fused
        sessions only): one model replica per device, requests padded to
        multiples of its size and sharded over its devices; `device` is then
        its first device. `batch_size` must be a multiple of its size.
    """

    def __init__(self, model_dir: str, store_root: str = None,
                 batch_size: int = None, cache_slides: bool = True,
                 cache_batches: int = 4, device="cuda", *, artifact=None,
                 mesh: Mesh = None):
        self.config = Config.load(model_dir, test_mode=True)
        self._mesh = mesh if mesh is not None else Mesh([device])
        self.device = self._mesh.devices[0]
        if mesh is not None:
            # real raises, not asserts: -O must not drop a mesh's checks
            if artifact is not None:
                raise ValueError(
                    "mesh serving is implemented for live fused sessions")
            n, bs = data_axis_size(mesh), batch_size or self.config.batch_size[0]
            if bs % n:
                raise ValueError(
                    f"batch_size {bs} must be a multiple of the data axis "
                    f"({n}) so every bucket shards evenly")
        self.model_dir = model_dir
        self.store = FeatureStore(store_root or self.config.preprocess_dir)
        self.slide_ids = store_slide_ids(self.store, self.config.base_power)
        self._dataset = SlideDataset(self.slide_ids, self.config, self.store,
                                     cache_slides=cache_slides)
        self._index: Dict[str, int] = {s: i for i, s in enumerate(self.slide_ids)}
        self.batch_size = batch_size or self.config.batch_size[0]
        self._lock = threading.Lock()   # one batch on the device at a time
        self._batch_cache: "OrderedDict" = OrderedDict()
        self._cache_batches = cache_batches
        self._exp = None
        self._frozen = self._poly_artifact = self._streaming = False
        self.model = self._params = self._eng = None
        if artifact is not None:
            self._open_artifact(artifact, batch_size)
            return
        shards = data_axis_size(self._mesh)
        if self.config.engine == "auto":
            # resolve from the store's shape bounds, pricing one shard of a
            # batch per device; the session owns its config copy, so
            # recording the decision on it is safe
            self.config.engine = resolve_engine(
                self.config,
                self._dataset.global_pads() if self.slide_ids else None,
                self.batch_size // shards, device=self.device)
        self._streaming = self.config.engine == "streaming"
        if mesh is not None and self._streaming:
            raise ValueError(
                "mesh serving is implemented for live fused sessions")
        # store-wide pads: every request of a batch width has one shape; the
        # streaming engine pads only the level-0 bag
        self._pads = (self._dataset.global_pads(level0_only=self._streaming)
                      if self.config.static_shapes and self.slide_ids else None)
        self.model = self._load_model()
        self._replicas = place_replicas(self.model, self._mesh.devices)
        if self._streaming:
            self._eng = StreamingEngine(self.config, self.device)

    def _load_model(self) -> RecursiveModel:
        model = load_model(self.model_dir, RecursiveModel(self.config),
                           self.config.checkpoint_backend)
        return model.to(self.device).eval().requires_grad_(False)

    def _open_artifact(self, path: str, batch_size) -> None:
        from paths_tpu_torch.export import artifact_signature, load_serving

        with open(path, "rb") as f:
            self._exp = load_serving(f.read())
        if self.device.type not in self._exp.platforms:
            raise ValueError(f"{path} has no program for {self.device.type} "
                             f"(platforms {self._exp.platforms})")
        self._frozen, self.batch_size, self._pads = artifact_signature(
            self._exp)
        self._poly_artifact = self.batch_size is None
        if self._poly_artifact:
            # a symbolic batch axis: the caller picks the widest batch, and
            # requests pad to power-of-two widths up to it
            self.batch_size = batch_size or self.config.batch_size[0]
        if not self._frozen:
            self._params = dict(self._load_model().named_parameters())

    def _check_artifact_shapes(self, indices, bag, tables) -> None:
        """Slides preprocessed after the export can exceed the artifact's
        input shapes; reject them with a clear message instead of the
        program's shape-guard error."""
        got_n0 = int(bag.mask.shape[1])
        got_rows = [0] + [int(t.fts.shape[1]) for t in tables]
        got_grid = [(0, 0)] + [tuple(map(int, t.index.shape[1:3]))
                               for t in tables]
        if (got_n0 <= self._pads["n0"]
                and all(g <= p for g, p in zip(got_rows, self._pads["rows"]))
                and all(gh <= ph and gw <= pw for (gh, gw), (ph, pw)
                        in zip(got_grid, self._pads["grid_hw"]))):
            return
        names = sorted({self.slide_ids[i] for i in indices})
        raise ValueError(
            f"slides exceed the artifact's export-time shapes "
            f"(level-0 width {got_n0} > {self._pads['n0']} or table rows "
            f"{got_rows} > {self._pads['rows']}); offending batch: "
            f"{names}. Re-export the artifact with current global pads.")

    def _pad_width(self, n: int) -> int:
        """Batch width for an n-slide chunk: a fixed-batch artifact's batch,
        else the mesh size times the next power of two, capped at the
        session's batch size."""
        if self._exp is not None and not self._poly_artifact:
            return self.batch_size
        width = data_axis_size(self._mesh)
        while width < min(n, self.batch_size):
            width *= 2
        return min(width, self.batch_size)

    def _cached(self, padded: Sequence[int], assemble):
        """Device-resident LRU of collated batches keyed by the padded slide
        indices: a repeated request skips collation and the copy."""
        if not self._cache_batches:
            return assemble()
        key = tuple(padded)
        hit = self._batch_cache.pop(key, None)
        with span("paths.serve.batch", hit=int(hit is not None)):
            if hit is None:
                hit = assemble()
        self._batch_cache[key] = hit
        while len(self._batch_cache) > self._cache_batches:
            self._batch_cache.popitem(last=False)
        return hit

    def _run(self, indices: Sequence[int]) -> np.ndarray:
        """One device batch, padded by repeating the last slide. Returns the
        pred rows of `indices` only."""
        n = len(indices)
        padded = list(indices) + [indices[-1]] * (self._pad_width(n) - n)
        bucket = self.config.level0_bucket
        if self._exp is not None:    # exactly the export-time shapes
            def assemble():
                bag, tables = collate_batch(
                    self._dataset, padded, level0_bucket=1, row_bucket=1,
                    grid_bucket=1, pads=self._pads, device=self.device)
                self._check_artifact_shapes(padded, bag, tables)
                return bag_to_dict(bag), tables_to_dicts(tables)

            args = self._cached(padded, assemble)
            if not self._frozen:
                args = (self._params,) + tuple(args)
            with torch.inference_mode(), span("paths.forward"):
                pred = self._exp.call(*args)["pred"]
        elif self._streaming:
            bag0 = self._cached(padded, lambda: collate_bag0(
                self._dataset, padded, level0_bucket=bucket, pads=self._pads,
                device=self.device))
            slides = [self._dataset.slides[i] for i in padded]
            with torch.inference_mode():
                with span("paths.forward"):
                    outs, _ = self._eng.forward(self.model, bag0,
                                                [s.tables for s in slides])
                pred = prediction(self.config, outs[-1]["logits"])
            if not self._dataset.cache_slides:
                for s in slides:
                    s.unload()
        else:
            devices = self._mesh.devices
            share = len(padded) // len(devices)
            shards = self._cached(padded, lambda: [collate_batch(
                self._dataset, padded[i * share: (i + 1) * share],
                level0_bucket=bucket, pads=self._pads, device=d)
                for i, d in enumerate(devices)])
            with torch.inference_mode(), span("paths.forward"):
                # the forward never waits for its card, so this loop queues
                # every device's shard before the first copy back waits
                preds = [serving_forward(model, self.config, bag, tables)["pred"]
                         for model, (bag, tables) in zip(self._replicas,
                                                         shards)]
            pred = torch.cat([p.float().cpu() for p in preds])
        return pred[:n].float().cpu().numpy()

    def predict(self, slide_ids: Sequence[str]) -> List[dict]:
        """Predictions for `slide_ids`, in order. Raises KeyError for
        unknown slides."""
        missing = [s for s in slide_ids if s not in self._index]
        if missing:
            raise KeyError(f"unknown slide ids (not in store): {missing}")
        indices = [self._index[s] for s in slide_ids]
        preds = []
        with self._lock, span("paths.serve.request", slides=len(slide_ids)):
            for s in range(0, len(indices), self.batch_size):
                preds.append(self._run(indices[s: s + self.batch_size]))
        pred = np.concatenate(preds) if preds else np.zeros((0,))
        return prediction_rows(self.config, slide_ids, pred)

    def info(self) -> dict:
        return {
            "task": self.config.task,
            "model_dir": self.model_dir,
            "num_slides": len(self.slide_ids),
            "batch_size": self.batch_size,
            "backend": ("frozen-artifact" if self._exp is not None
                        and self._frozen else
                        "artifact" if self._exp is not None else
                        "live-streaming" if self._streaming else "live"),
            "device": str(self.device),
        }
