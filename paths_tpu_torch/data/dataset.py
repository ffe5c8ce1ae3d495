"""Dataset assembly: metadata CSV -> splits -> device-ready batches
(counterpart of `paths_tpu.data.dataset`, without pandas).

  * metadata rows lacking a preprocessed file are dropped; one slide per
    patient (the first row of each case_id); survival months are
    quantile-binned over the whole frame before splitting (the bins of
    `pd.qcut`), then labelled per split (the bins of `pd.cut(...,
    include_lowest=True)`)
  * HIPT cross-validation split files, or random proportional splits that
    draw exactly what `frame.sample(n, random_state=seed)` draws
  * a `SlideDataset` serves its slides by index, with labels when built
    from metadata and without them for serving
  * `collate_batch` / `collate_bag0` pad to the JAX package's widths and
    buckets, so both packages collate a batch to the same shapes
"""
from __future__ import annotations

import csv
import io
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.data.slide import SlidePyramid
from paths_tpu_torch.engine.tables import (
    bag_widths,
    feature_source,
    fill_rows,
    small_host_array,
    stack_tables,
)
from paths_tpu_torch.models.batch import PatchBag, seq_block_width
from paths_tpu_torch.profiling import count, span

MAX_WORKERS = 8


def _round_up(n: int, m: int) -> int:
    return m * ((n + m - 1) // m)


def _strip_ext(slide_id: str) -> str:
    """`TCGA-....svs` -> `TCGA-...` (everything before the last dot)."""
    return ".".join(str(slide_id).split(".")[:-1])


def _read_csv_rows(path: str) -> List[dict]:
    """Rows of a metadata CSV, plain or the single member of a zip."""
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as z:
            names = [n for n in z.namelist() if not n.endswith("/")]
            if len(names) != 1:
                raise ValueError(f"{path}: want one file in the zip, got {names}")
            text = z.read(names[0]).decode("utf-8")
    else:
        with open(path, newline="", encoding="utf-8") as f:
            text = f.read()
    return list(csv.DictReader(io.StringIO(text)))


def qcut_bins(values: np.ndarray, nbins: int) -> np.ndarray:
    """The bin edges of `pd.qcut(values, nbins, retbins=True)`: linear
    quantiles at 0, 1/nbins, ..., 1, computed as pandas does (percentiles
    of 100 * q). Edges must be unique."""
    bins = np.percentile(np.asarray(values, np.float64),
                         np.linspace(0, 1, nbins + 1) * 100.0)
    if len(np.unique(bins)) < len(bins):
        raise ValueError(f"Bin edges must be unique: {bins!r}")
    return bins


def cut_labels(values: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """`pd.cut(values, bins, labels=False, include_lowest=True)`: right-
    closed bins, the lowest edge included. Values outside the edges raise
    (pandas would return NaN)."""
    x = np.asarray(values, np.float64)
    ids = np.searchsorted(bins, x, side="left")
    ids[x == bins[0]] = 1
    if np.any((ids == 0) | (ids == len(bins))):
        raise ValueError("values outside the survival bins")
    return ids - 1


def load_metadata(config: Config, store: FeatureStore) -> Tuple[List[dict], np.ndarray]:
    """Read and prune the metadata CSV; returns (rows, survival bin edges).
    Each row is a dict of case_id, slide_id, survival_months (float),
    censorship (int) and oncotree_code."""
    rows = []
    for r in _read_csv_rows(config.csv_path):
        rows.append({"case_id": r["case_id"], "slide_id": r["slide_id"],
                     "survival_months": float(r["survival_months"]),
                     "censorship": int(float(r["censorship"])),
                     "oncotree_code": r["oncotree_code"]})
    kept = [r for r in rows if store.path(_strip_ext(r["slide_id"]),
                                          config.base_power) is not None]
    if len(kept) < len(rows):
        print(f"Ignoring {len(rows) - len(kept)} rows without files.")
    seen, unique = set(), []
    for r in kept:
        if r["case_id"] not in seen:
            seen.add(r["case_id"])
            unique.append(r)
    bins = qcut_bins([r["survival_months"] for r in unique], config.nbins)
    return unique, bins


def _read_hipt_split(path: str, task: str):
    with open(path, "r") as f:
        r = csv.reader(f)
        next(r)
        data = [row[1:] for row in r]
    if task == "subtype_classification":
        train = [a + ".svs" for a, b, c in data]
        val = [b + ".svs" for a, b, c in data if len(b) > 0]
        test = [c + ".svs" for a, b, c in data if len(c) > 0]
        return train, val, test, "slide_id"
    train = [a for a, b in data]
    test = [b for a, b in data if len(b) > 0]
    return train, None, test, "case_id"


def _sample(rows: List[dict], n: int, seed: int):
    """`frame.sample(n, random_state=seed)` over `rows` in their order, and
    the rows it left, in their order."""
    picks = np.random.RandomState(seed).choice(len(rows), size=n, replace=False)
    chosen = set(picks.tolist())
    return ([rows[i] for i in picks],
            [r for i, r in enumerate(rows) if i not in chosen])


def load_splits(props: Sequence[float], seed: int, config: Config,
                store: Optional[FeatureStore] = None, test_only: bool = False,
                combined: bool = False, preload: bool = True):
    """Train/val/test SlideDatasets (`paths_tpu.data.dataset.load_splits`).
    `props` is the random-split proportion triple, unused when
    `config.hipt_splits`; val is None where a HIPT split has none.

    :param test_only: return only the test split's dataset
    :param combined: return one dataset of every kept metadata row, before
        the subtype filter and the split"""
    train_prop, val_prop, test_prop = props
    if abs(train_prop + val_prop + test_prop - 1) >= 1e-4:
        raise ValueError(f"split proportions {props} do not sum to 1")

    store = store or FeatureStore(config.preprocess_dir)
    rows, bins = load_metadata(config, store)

    def dataset(split_rows):
        return labelled_dataset(split_rows, bins, config, store, preload)

    if combined:
        return dataset(rows)

    if config.filter_to_subtypes is not None:
        rows = [r for r in rows if r["oncotree_code"] in config.filter_to_subtypes]

    if config.hipt_splits:
        ds_name = os.path.split(config.wsi_dir)[-1].lower()
        sub = ("survival" if config.task == "survival"
               else "subtype_classification")
        splits_dir = config.splits_dir or "data/splits"
        path = os.path.join(splits_dir, sub, f"tcga_{ds_name}",
                            f"splits_{seed}.csv")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"HIPT split file not found: {path}")
        train_p, val_p, test_p, match_on = _read_hipt_split(path, config.task)

        if config.task == "survival" and config.hipt_val_proportion > 0:
            val_size = int(len(train_p) * config.hipt_val_proportion)
            val_p, train_p = train_p[:val_size], train_p[val_size:]

        def pick(names):
            names = set(names)
            return [r for r in rows if r[match_on] in names]

        train = pick(train_p)
        val = pick(val_p) if val_p else None
        test = pick(test_p)
    else:
        train, rest = _sample(rows, int(train_prop * len(rows)), seed)
        val, test = _sample(rest, int(val_prop * len(rows)), seed)

    if test_only:
        return dataset(test)
    return [None if split is None else dataset(split)
            for split in (train, val, test)]


def labelled_dataset(rows: Sequence[dict], bins: np.ndarray, config: Config,
                     store: FeatureStore, preload: bool = True) -> "SlideDataset":
    """A SlideDataset of metadata `rows` with their labels: the survival bin
    (`cut_labels` over `bins`), survival months, censorship and, for
    subtype classification, the class index."""
    months = np.asarray([r["survival_months"] for r in rows], np.float64)
    labels = {
        "survival_bin": cut_labels(months, bins).astype(np.int32),
        "survival": months.astype(np.float32),
        "censored": np.asarray([r["censorship"] for r in rows], np.int32),
    }
    if config.task == "subtype_classification":
        labels["subtype"] = np.asarray(
            [config.filter_to_subtypes.index(r["oncotree_code"]) for r in rows],
            np.int32)
    return SlideDataset([_strip_ext(r["slide_id"]) for r in rows], config,
                        store, cache_slides=preload, labels=labels,
                        preload=preload)


class SlideDataset:
    """The slides of a feature store, by id, with or without labels.

    Collation for a card copies each slide's features straight into its
    row of the batch there. A held slide is copied from pageable memory at
    its first collation, and page-locked at its second (`SlidePyramid.pin`)
    while `pin_bytes` (a quarter of the host's memory) allows, so that a
    slide collated once (a one-pass sweep) never pays for the locking and a
    reused one is copied at the link's rate. The locked host RAM is the
    held slides' feature bytes at the wire dtype, each block rounded up to
    a power of two by torch's page-locked allocator; it takes the place of
    the held arrays where the wire dtype is the storage dtype.

    :param cache_slides: keep materialized tables after a batch is
        collated (trade host RAM for repeat-request latency); on a card the
        reused ones are page-locked
    :param labels: per-slide label columns (name -> array aligned with
        `slide_ids`), or None for a label-free (serving) dataset
    :param preload: build every slide's tables up front, on a thread pool
    """

    def __init__(self, slide_ids: Sequence[str], config: Config,
                 store: FeatureStore, cache_slides: bool = True, *,
                 labels: Optional[Dict[str, np.ndarray]] = None,
                 preload: bool = False):
        self.config = config
        self.slide_ids = list(slide_ids)
        self.cache_slides = cache_slides
        # page-locked host RAM the held slides may take; past it they stay
        # pageable
        self.pin_bytes = (os.sysconf("SC_PAGE_SIZE")
                          * os.sysconf("SC_PHYS_PAGES") // 4)
        self.label_columns = labels
        mc = config.model_config
        # table row bounds for levels >= 1 do not depend on n0 when K != -1
        widths = bag_widths(config.top_k_patches, config.num_levels, 10**9)
        self.level_min_rows = [0] + widths[1:]
        self.slides = [SlidePyramid(
            sid, store, config.base_power, config.num_levels, mc.patch_size,
            level_min_rows=self.level_min_rows,
            magnification_factor=config.magnification_factor)
            for sid in self.slide_ids]
        self._global_pads: Optional[dict] = None
        self._global_pads_l0: Optional[dict] = None
        if preload:
            with ThreadPoolExecutor(min(MAX_WORKERS, os.cpu_count() or 1)) as ex:
                list(ex.map(lambda s: s.materialize(), self.slides))

    def __len__(self) -> int:
        return len(self.slides)

    def global_pads(self, level0_only: bool = False) -> dict:
        """Dataset-wide shape maxima: level-0 bag width, per-level table rows
        and grid dims. Collating every batch to these gives every batch of a
        width one shape. One pass over the slides; a slide that was not
        loaded before the pass is unloaded after it unless `cache_slides`.

        :param level0_only: scan only the level-0 bag widths (what the
            streaming engine pads; its deeper tables stay on the host), so
            the pass reads one grid per slide instead of all levels"""
        if self._global_pads is not None:
            return self._global_pads
        if level0_only and self._global_pads_l0 is not None:
            return self._global_pads_l0
        n0 = 0
        rows = [0] * self.config.num_levels
        grid_hw = [(0, 0)] * self.config.num_levels
        for s in self.slides:
            was_loaded = s._tables is not None
            n0 = max(n0, s.level0[2])
            if not level0_only:
                for lvl, t in enumerate(s.tables, start=1):
                    rows[lvl] = max(rows[lvl], t["fts"].shape[0])
                    grid_hw[lvl] = (max(grid_hw[lvl][0], t["index"].shape[0]),
                                    max(grid_hw[lvl][1], t["index"].shape[1]))
            if not (self.cache_slides or was_loaded):
                s.unload()
        pads = {"n0": n0, "rows": rows, "grid_hw": grid_hw}
        if level0_only:
            self._global_pads_l0 = pads
        else:
            self._global_pads = pads
        return pads

    def labels(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """The label columns at `indices` (survival_bin, survival, censored
        and, for subtype classification, subtype)."""
        if self.label_columns is None:
            raise ValueError("this dataset has no labels")
        idx = np.asarray(indices, np.int64)
        return {k: v[idx] for k, v in self.label_columns.items()}


def union_pads(*pads: Optional[dict]) -> Optional[dict]:
    """Elementwise max of `global_pads` dicts (so train/val/test batches
    share one shape)."""
    pads = [p for p in pads if p is not None]
    if not pads:
        return None
    return {"n0": max(p["n0"] for p in pads),
            "rows": [max(p["rows"][i] for p in pads)
                     for i in range(len(pads[0]["rows"]))],
            "grid_hw": [tuple(max(p["grid_hw"][i][j] for p in pads)
                              for j in range(2))
                        for i in range(len(pads[0]["grid_hw"]))]}


def pad_batch_indices(indices: Sequence[int], multiple: int):
    """Pad an index list to a multiple of `multiple` by repeating the last
    element; returns (padded_indices, weights) where the weights zero out
    the padded duplicates in the loss and evaluators."""
    idx = list(indices)
    n = len(idx)
    pad = (-n) % multiple
    idx = idx + [idx[-1]] * pad
    w = np.ones(len(idx), np.float32)
    if pad:
        w[n:] = 0.0
    return idx, w


def labels_on(dataset: "SlideDataset", indices: Sequence[int],
              device) -> Dict[str, torch.Tensor]:
    """`dataset.labels(indices)` as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in dataset.labels(indices).items()}


def _pins(dataset: SlideDataset, device) -> bool:
    """Whether collation page-locks reused slides' features: for a card,
    where the dataset holds its slides' tables."""
    return torch.device(device).type == "cuda" and dataset.cache_slides


def _pin_reused(dataset: SlideDataset, slides, dtype) -> None:
    """Count a collation of each distinct slide of a batch, and page-lock
    the features of those at their second (`SlidePyramid.pin`), in batch
    order, while the dataset's `pin_bytes` allows. A slide that does not
    fit then, or cannot be locked, stays pageable."""
    slides = list(dict.fromkeys(slides))
    reused = [s for s in slides if s.collations == 1]
    for s in slides:
        s.collations += 1
    if reused:
        free = dataset.pin_bytes - sum(s.pinned_bytes for s in dataset.slides)
        for s in reused:
            free -= s.pin(dtype, free)


def collate_batch(dataset: SlideDataset, indices: Sequence[int],
                  level0_bucket: int = 256, row_bucket: int = 256,
                  grid_bucket: int = 16, dtype: Optional[torch.dtype] = None,
                  pads: Optional[dict] = None, device="cuda",
                  seq: Optional[Tuple[int, int]] = None):
    """Collate slides into (PatchBag, [LevelTable]) on `device`.

    The level-0 width is the batch max rounded up to `level0_bucket`; table
    rows and grid dims round to `row_bucket` / `grid_bucket`. `pads` (a
    `global_pads()` dict) replaces batch maxima with dataset-wide maxima.
    With `seq` = (index, sp) the level-0 bag is sequence rank `index`'s
    block (`collate_bag0`); the tables are whole."""
    cfg = dataset.config
    if dtype is None:
        dtype = getattr(torch, cfg.table_dtype)
    with span("paths.collate", slides=len(indices)):
        slides = [dataset.slides[i] for i in indices]

        bag0 = collate_bag0(dataset, indices, level0_bucket=level0_bucket,
                            dtype=dtype, pads=pads, device=device, seq=seq)
        n0 = bag0.patch_width or bag0.mask.shape[1]

        widths = bag_widths(cfg.top_k_patches, cfg.num_levels, n0)
        tables = []
        for lvl in range(1, cfg.num_levels):
            per = [s.tables[lvl - 1] for s in slides]
            max_rows = max(t["fts"].shape[0] for t in per)
            max_h = max(t["index"].shape[0] for t in per)
            max_w = max(t["index"].shape[1] for t in per)
            if pads is not None:
                max_rows = max(max_rows, pads["rows"][lvl])
                max_h = max(max_h, pads["grid_hw"][lvl][0])
                max_w = max(max_w, pads["grid_hw"][lvl][1])
            rows = _round_up(max(widths[lvl], max_rows), row_bucket)
            h = _round_up(max_h, grid_bucket)
            w = _round_up(max_w, grid_bucket)
            tables.append(stack_tables(per, min_rows=widths[lvl],
                                       pad_rows_to=rows, pad_grid_to=(h, w),
                                       dtype=dtype, device=device))

        if not dataset.cache_slides:
            for s in slides:
                s.unload()
    return bag0, tables


def collate_bag0(dataset: SlideDataset, indices: Sequence[int],
                 level0_bucket: int = 256, dtype: Optional[torch.dtype] = None,
                 pads: Optional[dict] = None, device="cuda",
                 seq: Optional[Tuple[int, int]] = None) -> PatchBag:
    """Collate only the level-0 bag, on `device`. With `seq` = (index, sp),
    only the m rows of sequence rank `index`'s block
    (`models/batch.py::seq_block_width`) are collated; `patch_width` is the
    whole bag's width. Every collation passes here: one bound for a card
    from held slides (`_pins`) is counted, and page-locks the slides it
    reuses (`_pin_reused`)."""
    cfg = dataset.config
    mc = cfg.model_config
    if dtype is None:
        dtype = getattr(torch, cfg.table_dtype)
    slides = [dataset.slides[i] for i in indices]
    pin = _pins(dataset, device)
    if pin:
        _pin_reused(dataset, slides, dtype)
    l0 = [s.level0 for s in slides]
    b = len(l0)
    ds_dim, dp_dim = mc.ctx_dim()

    max_n0 = max(x[2] for x in l0)
    if pads is not None:
        max_n0 = max(max_n0, pads["n0"])
    n0 = _round_up(max_n0, level0_bucket)
    rows, first, width = n0, 0, None
    if seq is not None:
        index, sp = seq
        rows = seq_block_width(n0, sp)
        first, width = index * rows - 1, n0   # patch of the block's row 0
    # the features are made zero on the device at the table dtype and each
    # slide's rows copied in, crossing at the narrower of storage and table
    # dtype, as in stack_tables
    device = torch.device(device)
    fts0 = torch.zeros((b, rows, mc.patch_embed_dim), dtype=dtype,
                       device=device)
    locs0 = small_host_array((b, rows, 2), 0, device)
    mask0 = small_host_array((b, rows), False, device, torch.bool)
    locs_np, mask_np = locs0.numpy(), mask0.numpy()
    for i, (f, l, n) in enumerate(l0):
        lo, hi = max(first, 0), min(n, first + rows)
        if hi > lo:
            src = feature_source(f, slides[i].level0_wire, dtype) if pin else f
            fill_rows(fts0[:, lo - first:], i, src[lo:hi])
            locs_np[i, lo - first: hi - first] = l[lo:hi]
            mask_np[i, lo - first: hi - first] = True
    patch = torch.arange(first, first + rows, device=device)
    patch = torch.where((patch >= 0) & (patch < n0), patch, 0)
    count("h2d_bytes", locs0.nbytes + mask0.nbytes)

    return PatchBag(
        fts=fts0,
        locs=locs0.to(device, non_blocking=True).long(),
        mask=mask0.to(device, non_blocking=True),
        parent_inds=patch.expand(b, rows),
        ctx_slide=torch.zeros((b, 0, ds_dim), dtype=dtype, device=device),
        ctx_patch=torch.zeros((b, rows, 0, dp_dim), dtype=dtype,
                              device=device),
        patch_width=width)


def iterate_batches(dataset: SlideDataset, batch_size: int, *,
                    shuffle: bool = False, seed: int = 0,
                    level0_bucket: int = 256, pads: Optional[dict] = None,
                    device="cuda"):
    """Yield collated (bag0, tables, labels) batches on `device`; shuffling
    is seeded per call."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for s in range(0, len(order), batch_size):
        idx = order[s: s + batch_size].tolist()
        labels = labels_on(dataset, idx, device)
        bag0, tables = collate_batch(dataset, idx, level0_bucket=level0_bucket,
                                     pads=pads, device=device)
        yield bag0, tables, labels
