"""The offline preprocessor: WSI -> per-magnification feature grids
(counterpart of `paths_tpu.preprocess.pipeline`).

For each slide and magnification: an Otsu tissue mask once at
`power/downscale`, grid cells whose tissue proportion exceeds the threshold,
their patches read and encoded, and the embeddings scattered into an
H x W x D grid with zero rows for background; `{slide_id}_{power:.3f}`
naming; skip-if-exists resume; per-(slide, power) fault tolerance.

How the host and the card overlap:
  * tissue proportions are computed for all cells at once via integral images
  * patches cross to the card as uint8 (a quarter of the f32 bytes) and are
    normalised there; a dedicated staging thread copies each pinned batch on
    its own CUDA stream while the producer decodes the next one, and hands
    the consumer an event that the encode stream waits on
  * kernel launches are asynchronous, so the host reads batch k + 1 while
    the card encodes batch k; a level's embeddings come back in one copy
  * batches are padded to power-of-two buckets (the full `batch_size` for
    the body, the smallest bucket for each level's tail), so small levels do
    not ship and encode mostly padding; padding rows are encoded and dropped
  * with `decode_workers >= 2`, spawn processes decode slide shards in
    parallel and feed one bounded queue (the reference pipeline's shape:
    many decode processes fanning into one accelerator); the children never
    touch the card, and the parent stages and encodes

Not ported yet (ROADMAP.md Queue 1, 'Parallel'): batches sharded over
several cards.
"""
from __future__ import annotations

import math
import queue
import threading
import time
import traceback
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.preprocess.masking import tissue_mask
from paths_tpu_torch.preprocess.wsi import WSIReader, camelyon_map, open_wsi


def next_multiple(n: int, m: int) -> int:
    return m * math.ceil(n / m)


def _grid_dtype(store_dtype) -> np.dtype:
    """Validated on-disk grid dtype: float32 (interchangeable with the
    reference's stores) or float16 (half the store; background stays exact,
    zero rows survive the cast)."""
    dt = np.dtype(store_dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.float16)):
        raise ValueError(
            f"store_dtype must be float32 or float16, got {store_dtype!r}")
    return dt


def _warn_skip_dtype(store, slide_id: str, power: float, store_dtype) -> None:
    """Skip-if-exists resume keeps whatever dtype is on disk; if it is not
    the dtype this run was asked for, the store ends up mixed. Say so."""
    existing = store.dtype(slide_id, power)
    if existing is not None and existing != _grid_dtype(store_dtype):
        warnings.warn(
            f"resume: existing grids are {existing} but this run requests "
            f"store_dtype={np.dtype(store_dtype)}; kept as-is. Delete the "
            "old files (or rerun with the matching --store-dtype) for a "
            "uniform store.")


def cell_tissue_proportions(mask: np.ndarray, cell: int,
                            n_rows: int, n_cols: int) -> np.ndarray:
    """Mean mask value per (cell x cell) grid cell, edge cells averaged over
    their in-bounds area only."""
    m = mask.astype(np.float64)
    ii = np.zeros((m.shape[0] + 1, m.shape[1] + 1))
    ii[1:, 1:] = m.cumsum(0).cumsum(1)

    r0 = np.minimum(np.arange(n_rows) * cell, m.shape[0])
    r1 = np.minimum(r0 + cell, m.shape[0])
    c0 = np.minimum(np.arange(n_cols) * cell, m.shape[1])
    c1 = np.minimum(c0 + cell, m.shape[1])
    sums = (ii[r1][:, c1] - ii[r1][:, c0] - ii[r0][:, c1] + ii[r0][:, c0])
    areas = np.maximum((r1 - r0)[:, None] * (c1 - c0)[None, :], 1)
    return sums / areas


class _StagedBatch:
    """A batch on its way to the card: the device tensor, the event recorded
    after its copy on the staging stream, and the pinned host buffer, kept
    alive until the consumer takes the batch."""

    def __init__(self, dev: torch.Tensor, event, host: torch.Tensor):
        self.dev, self.event, self.host = dev, event, host


class _AsyncStager:
    """Dedicated host-to-device thread: calling the stager returns at once
    with a Future while the transfer runs on its own thread, so the producer
    decodes batch k + 1 while batch k crosses the link. ONE thread on
    purpose: transfers stay ordered and the link is never oversubscribed.
    Resolve results with `_staged` before use."""

    def __init__(self, stage_fn):
        self._fn = stage_fn
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="h2d-stager")
        # cumulative seconds the stager thread spent pinning and copying
        # (it waits for each copy's event, so this is the transfer's wall
        # time that the overlap hides), and the bytes it moved
        self.busy_s = 0.0
        self.bytes_staged = 0

    def _run(self, arr):
        self.bytes_staged += arr.nbytes
        t0 = time.perf_counter()
        try:
            return self._fn(arr)
        finally:
            self.busy_s += time.perf_counter() - t0

    def __call__(self, arr) -> "Future":
        return self._pool.submit(self._run, arr)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


def _staged(arr) -> torch.Tensor:
    """Resolve a staged batch into a tensor the encode may read: the Future
    an `_AsyncStager` returned (a transfer error re-raises here, at the
    consuming site), a `_StagedBatch`, or a host array when staging is off.
    The current stream waits for the copy's event, and the tensor is
    recorded on it so that its memory is not reused while the encode reads."""
    if isinstance(arr, Future):
        arr = arr.result()
    if isinstance(arr, _StagedBatch):
        stream = torch.cuda.current_stream(arr.dev.device)
        stream.wait_event(arr.event)
        arr.dev.record_stream(stream)
        return arr.dev
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(arr)
    return arr


def _make_stager(stage_h2d: bool, device):
    """The host->device staging step, run off the consumer's thread so the
    copy overlaps the card's encode of the previous batch. Returns None when
    staging is off. On a CUDA device: pin the batch, copy it with
    `non_blocking=True` on a stream of the stager's own, record an event and
    wait for it in the staging thread. On the CPU: wrap the array."""
    if not stage_h2d:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return lambda arr: torch.from_numpy(arr)
    stream = torch.cuda.Stream(device)

    def stage(arr: np.ndarray) -> _StagedBatch:
        host = torch.from_numpy(arr).pin_memory()
        with torch.cuda.stream(stream):
            dev = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
        return _StagedBatch(dev, event, host)

    return stage


def _level_plan(wsi: WSIReader, power: float, patch_size: int,
                tissue_threshold: float, downscale: int, camelyon: bool):
    """Host stage 1 for one (slide, magnification): Otsu mask once at
    power/downscale, tissue proportions for all cells via integral images.
    Returns (n_rows, n_cols, candidate (row, col) array)."""
    p = patch_size
    rows, cols = wsi.slide_dimensions(power)
    rows, cols = next_multiple(rows, p), next_multiple(cols, p)
    n_rows, n_cols = rows // p, cols // p
    mimg = wsi.read_rect((0, 0), (rows // downscale, cols // downscale),
                         power / downscale)
    if camelyon:
        mimg = camelyon_map(mimg)
    mask = tissue_mask(mimg)
    props = cell_tissue_proportions(mask, p // downscale, n_rows, n_cols)
    return n_rows, n_cols, np.argwhere(props > tissue_threshold)


class _WholeLevelSource:
    """Load-mode-1 patch source: the whole level image is read from the slide
    ONCE and patches are sliced out of host RAM. Faster on storage where many
    small rect reads dominate, at a large per-level memory cost. Exposes the
    `read_rect` subset `_read_batch` uses."""

    def __init__(self, wsi: WSIReader, power: float, rows: int, cols: int):
        self.img = wsi.read_rect((0, 0), (rows, cols), power)

    def read_rect(self, loc, size, power) -> np.ndarray:
        y, x = int(loc[0]), int(loc[1])
        h, w = int(size[0]), int(size[1])
        return self.img[y: y + h, x: x + w]


def _patch_source(wsi: WSIReader, load_mode: int, power: float,
                  n_rows: int, n_cols: int, patch_size: int):
    """The object `_read_batch` reads patches from: the WSI handle itself
    (load_mode 0, per-rect reads) or a whole-level RAM image (load_mode 1)."""
    if load_mode == 1:
        return _WholeLevelSource(wsi, power, n_rows * patch_size,
                                 n_cols * patch_size)
    return wsi


def _bucket(width: int, batch_size: int, mult: int = 1) -> int:
    """Padded width for a batch holding `width` valid patches: the smallest
    power of two >= width, floored at 32 and batch_size // 8 and capped at
    batch_size, so full batches keep `batch_size` and only each level's TAIL
    batch shrinks. `mult` > 1 rounds every bucket up to a multiple of it."""
    b = max(32, batch_size // 8)
    while b < width:
        b *= 2
    b = min(b, batch_size)
    return next_multiple(b, mult) if mult > 1 else b


def _read_batch(wsi: WSIReader, cand: np.ndarray, bi: int, power: float,
                patch_size: int, batch_size: int, pool: ThreadPoolExecutor,
                camelyon: bool, stage_fn=None):
    """Host stage 2: read one padded patch batch (thread-pooled rects). With
    `stage_fn` the copy to the card is issued here, from the reader's side,
    so it overlaps the card's encode of the previous batch."""
    p = patch_size

    def read_cell(rc):
        r, c = rc
        img = wsi.read_rect((r * p, c * p), (p, p), power)
        return camelyon_map(img) if camelyon else img

    s = bi * batch_size
    e = min(s + batch_size, len(cand))
    imgs = list(pool.map(read_cell, cand[s:e]))
    arr = np.zeros((_bucket(e - s, batch_size), p, p, 3), np.uint8)
    arr[: e - s] = np.stack(imgs)
    if stage_fn is not None:
        arr = stage_fn(arr)
    return arr, s, e


def _drain_level(in_flight, cand, grid) -> None:
    """Scatter a level's embeddings with ONE device->host copy. Batch widths
    vary (the tail is bucketed), so rows are consumed by each batch's own
    padded width."""
    if not in_flight:
        return
    embs = [e for e, _, _ in in_flight]
    emb_all = (embs[0] if len(embs) == 1 else torch.cat(embs)).cpu().numpy()
    off = 0
    for emb_dev, s, e in in_flight:
        emb = emb_all[off: off + (e - s)]
        off += emb_dev.shape[0]
        rs, cs = cand[s:e, 0], cand[s:e, 1]
        grid[rs, cs] = emb


def process_level(wsi: WSIReader, encode_fn: Callable, dim: int, power: float,
                  *, patch_size: int = 256, tissue_threshold: float = 0.1,
                  downscale: int = 4, batch_size: int = 64, threads: int = 8,
                  camelyon: bool = False, load_mode: int = 0,
                  store_dtype="float32", device="cuda",
                  verbose: bool = False) -> np.ndarray:
    """One (slide, magnification) -> (rows/P, cols/P, D) grid in
    `store_dtype`. `encode_fn` takes a (B, P, P, 3) uint8 tensor on `device`
    and returns (B, dim) float32 there."""
    n_rows, n_cols, cand = _level_plan(wsi, power, patch_size,
                                       tissue_threshold, downscale, camelyon)
    if verbose:
        print(f"  power {power}: {len(cand)}/{n_rows * n_cols} cells pass "
              f"tissue threshold")

    grid = np.zeros((n_rows, n_cols, dim), _grid_dtype(store_dtype))
    if len(cand) == 0:
        return grid

    stager = _AsyncStager(_make_stager(True, device))
    src = _patch_source(wsi, load_mode, power, n_rows, n_cols, patch_size)
    pool = ThreadPoolExecutor(max_workers=threads)
    try:
        n_batches = math.ceil(len(cand) / batch_size)

        # software pipeline: read batch k+1 while the card encodes k, and
        # the copy of batch k overlaps the decode of k+1 (stager)
        pending = pool.submit(_read_batch, src, cand, 0, power, patch_size,
                              batch_size, pool, camelyon, stager)
        in_flight = []  # (embeddings on the device, s, e)
        for bi in range(n_batches):
            arr, s, e = pending.result()
            if bi + 1 < n_batches:
                pending = pool.submit(_read_batch, src, cand, bi + 1, power,
                                      patch_size, batch_size, pool, camelyon,
                                      stager)
            in_flight.append((encode_fn(_staged(arr)), s, e))

        _drain_level(in_flight, cand, grid)
    finally:
        pool.shutdown(wait=False)
        stager.shutdown()
    return grid


def process_slide(path: str, slide_id: str, encode_fn: Callable, dim: int,
                  magnifications: Sequence[float], store: FeatureStore, *,
                  patch_size: int = 256, tissue_threshold: float = 0.1,
                  downscale: int = 4, batch_size: int = 64, threads: int = 8,
                  default_power: float = 40.0, load_mode: int = 0,
                  store_dtype="float32", device="cuda",
                  verbose: bool = False) -> None:
    """All magnifications for one slide, with skip-if-exists resume and
    per-(slide, power) fault tolerance."""
    wsi = open_wsi(path, default_power)
    try:
        for power in magnifications:
            if store.exists(slide_id, power):
                _warn_skip_dtype(store, slide_id, power, store_dtype)
                continue
            try:
                grid = process_level(
                    wsi, encode_fn, dim, power, patch_size=patch_size,
                    tissue_threshold=tissue_threshold, downscale=downscale,
                    batch_size=batch_size, threads=threads,
                    load_mode=load_mode, store_dtype=store_dtype,
                    device=device, verbose=verbose)
                store.save(slide_id, power, grid)
            except Exception:
                print(f"FAILED ON SLIDE {slide_id} AT POWER {power}")
                traceback.print_exc()
    finally:
        wsi.close()


def _decode_worker(wid: int, items: Sequence, magnifications: Sequence[float],
                   store_root: str, opts: dict, q) -> None:
    """Child-process decode producer (spawn): owns its WSI handles and a
    read thread pool, and never touches the card (batches cross the queue
    as host arrays; the parent stages them). The message stream is keyed by
    (slide_id, power), so several workers can interleave levels on one
    queue."""
    store = FeatureStore(store_root)
    pool = ThreadPoolExecutor(max_workers=opts["threads"])
    try:
        for path, slide_id in items:
            try:
                wsi = open_wsi(path, opts["default_power"])
            except Exception:
                q.put(("error", (slide_id, None, traceback.format_exc())))
                continue
            try:
                for power in magnifications:
                    if store.exists(slide_id, power):
                        _warn_skip_dtype(store, slide_id, power,
                                         opts["store_dtype"])
                        continue
                    key = (slide_id, power)
                    try:
                        n_rows, n_cols, cand = _level_plan(
                            wsi, power, opts["patch_size"],
                            opts["tissue_threshold"], opts["downscale"],
                            camelyon=False)
                        q.put(("level", (key, n_rows, n_cols, cand)))
                        src = _patch_source(wsi, opts["load_mode"], power,
                                            n_rows, n_cols, opts["patch_size"])
                        nb = math.ceil(len(cand) / opts["batch_size"])
                        for bi in range(nb):
                            arr, s, e = _read_batch(
                                src, cand, bi, power, opts["patch_size"],
                                opts["batch_size"], pool, False)
                            q.put(("batch", (key, arr, s, e)))
                        q.put(("flush", key))
                    except Exception:
                        q.put(("error", (slide_id, power,
                                         traceback.format_exc())))
            finally:
                wsi.close()
    finally:
        pool.shutdown(wait=False)
        q.put(("done", wid))


def _consume_decode_queue(q, procs, *, encode, stage_fn, dim, store,
                          verbose, grid_dtype=np.float32, device="cuda",
                          poll_s: float = 5.0) -> None:
    """Parent-side consumer of the decode workers' message stream.

    Runs until every worker's `done` sentinel arrives, but survives workers
    that die without one (segfault, OOM kill): when the queue stays quiet
    past `poll_s` and no worker is alive, the messages their feeder threads
    flushed before death are drained and the loop exits with a warning
    instead of blocking on `q.get()` forever. A worker `error` for a level
    whose `level` header already arrived drops the half-built grid and its
    embeddings in flight (a faulty slide must not pin memory for the rest of
    the run). `stage_fn` (or None) moves a host batch towards `device`."""
    import queue as _squeue

    dev = torch.device(device)
    open_levels: dict = {}   # key -> [cand, grid, in_flight]
    done = 0

    def handle(msg) -> None:
        nonlocal done
        kind, payload = msg
        if kind == "done":
            done += 1
        elif kind == "error":
            slide_id, power, tb = payload
            open_levels.pop((slide_id, power), None)
            print(f"FAILED ON SLIDE {slide_id} AT POWER {power}")
            print(tb)
        elif kind == "level":
            key, n_rows, n_cols, cand = payload
            open_levels[key] = [cand,
                                np.zeros((n_rows, n_cols, dim), grid_dtype),
                                []]
            if verbose:
                print(f"{key[0]} @ {key[1]}: {len(cand)}/"
                      f"{n_rows * n_cols} cells pass tissue threshold")
        elif kind == "batch" and payload[0] in open_levels:
            key, arr, s, e = payload
            x = _staged(stage_fn(arr) if stage_fn is not None else arr)
            open_levels[key][2].append((encode(x.to(dev)), s, e))
        elif kind == "flush" and payload in open_levels:
            cand, grid, in_flight = open_levels.pop(payload)
            slide_id, power = payload
            try:
                _drain_level(in_flight, cand, grid)
                store.save(slide_id, power, grid)
            except Exception:
                print(f"FAILED ON SLIDE {slide_id} AT POWER {power}")
                traceback.print_exc()

    while done < len(procs):
        try:
            handle(q.get(timeout=poll_s))
        except _squeue.Empty:
            if any(p.is_alive() for p in procs):
                continue
            while True:   # drain what the feeders flushed before dying
                try:
                    handle(q.get_nowait())
                except _squeue.Empty:
                    break
            if done < len(procs):
                print(f"WARNING: {len(procs) - done} decode worker(s) "
                      "exited without finishing; their remaining slides "
                      "were skipped (a rerun resumes via skip-if-exists)")
            break


def _process_slides_mp(items, encode_fn, dim, magnifications, store, *,
                       decode_workers, patch_size, tissue_threshold,
                       downscale, batch_size, threads, default_power,
                       batches_ahead, stage_h2d, load_mode, store_dtype,
                       stats, device, verbose) -> None:
    """Multi-process decode fan-in: `decode_workers` spawn processes decode
    slide shards in parallel and feed one bounded queue; the parent stages
    each batch (pinned, on the stager's own stream) and encodes it. Spawn,
    not fork: the parent holds a CUDA context and threads."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=max(batches_ahead, decode_workers))
    opts = {"patch_size": patch_size, "tissue_threshold": tissue_threshold,
            "downscale": downscale, "batch_size": batch_size,
            "threads": threads, "default_power": default_power,
            "load_mode": load_mode, "store_dtype": store_dtype}
    shards = [list(items)[i::decode_workers] for i in range(decode_workers)]
    procs = [ctx.Process(target=_decode_worker,
                         args=(i, shards[i], list(magnifications),
                               store.root, opts, q), daemon=True)
             for i in range(decode_workers) if shards[i]]
    for p in procs:
        p.start()

    stage_fn = _make_stager(stage_h2d, device)
    # staged on the stager's thread, as the single-producer path does, so
    # the same counters fill; the consumer waits for each copy
    stager = _AsyncStager(stage_fn) if stage_fn is not None else None
    try:
        _consume_decode_queue(q, procs, encode=encode_fn, stage_fn=stager,
                              dim=dim, store=store, verbose=verbose,
                              grid_dtype=_grid_dtype(store_dtype),
                              device=device)
    finally:
        for p in procs:
            p.terminate()
            p.join(timeout=5)
        if stager is not None:
            if stats is not None:
                stats["h2d_busy_s"] = stager.busy_s
                stats["h2d_bytes"] = stager.bytes_staged
            stager.shutdown()


def process_slides(items: Sequence, encode_fn: Callable, dim: int,
                   magnifications: Sequence[float], store: FeatureStore, *,
                   patch_size: int = 256, tissue_threshold: float = 0.1,
                   downscale: int = 4, batch_size: int = 64, threads: int = 8,
                   default_power: float = 40.0, batches_ahead: int = 6,
                   stage_h2d: bool = True, decode_workers: int = 0,
                   load_mode: int = 0, store_dtype="float32",
                   stats: Optional[dict] = None, device="cuda",
                   verbose: bool = False) -> None:
    """Pipelined multi-slide preprocessing: a producer thread walks every
    (slide, magnification), masks, reads patch batches, and stages them to
    the card through a bounded queue; the consumer encodes and scatters
    grids. Host decode of slide k+1 overlaps the encode of slide k.
    Skip-if-exists resume and per-(slide, power) fault tolerance match
    `process_slide`.

    :param items: sequence of (path, slide_id)
    :param batches_ahead: bound on staged batches (host+device memory cap)
    :param stage_h2d: issue the host->device copy from the producer side
        (overlapping the encode). False keeps batches on the host until the
        encode takes them.
    :param decode_workers: 0/1 keeps the single producer thread; >= 2 spawns
        that many decode processes (slides sharded round-robin) feeding one
        bounded queue; the grids are the same.
    :param load_mode: 0 reads each patch rect from the slide; 1 reads the
        WHOLE level image once and slices patches from host RAM.
    :param store_dtype: on-disk grid dtype, "float32" or "float16".
    :param stats: optional dict the run fills with `h2d_busy_s` (cumulative
        seconds the staging thread spent pinning and copying) and
        `h2d_bytes`.
    :param device: where `encode_fn` expects its batches.
    """
    if decode_workers and decode_workers >= 2:
        _process_slides_mp(
            items, encode_fn, dim, magnifications, store,
            decode_workers=decode_workers, patch_size=patch_size,
            tissue_threshold=tissue_threshold, downscale=downscale,
            batch_size=batch_size, threads=threads,
            default_power=default_power, batches_ahead=batches_ahead,
            stage_h2d=stage_h2d, load_mode=load_mode,
            store_dtype=store_dtype, stats=stats, device=device,
            verbose=verbose)
        return

    q: "queue.Queue" = queue.Queue(maxsize=max(batches_ahead, 1))
    END = ("end", None)
    cancelled = threading.Event()

    def put(item) -> bool:
        """Bounded put that unblocks when the consumer abandons the loop
        (exception in encode/store) so the producer thread can exit instead
        of holding an open WSI handle and staged device buffers."""
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    stage_fn = _make_stager(stage_h2d, device)
    # the copy on its own thread: the producer decodes batch k+1 while batch
    # k crosses the link, so the wall tracks max(decode, copy), not the sum
    stager = _AsyncStager(stage_fn) if stage_fn is not None else None
    grid_dtype = _grid_dtype(store_dtype)
    dev = torch.device(device)

    def produce():
        pool = ThreadPoolExecutor(max_workers=threads)
        try:
            for path, slide_id in items:
                try:
                    wsi = open_wsi(path, default_power)
                except Exception:
                    if not put(("error", (slide_id, None,
                                          traceback.format_exc()))):
                        return
                    continue
                try:
                    for power in magnifications:
                        if cancelled.is_set():
                            return
                        if store.exists(slide_id, power):
                            _warn_skip_dtype(store, slide_id, power,
                                             store_dtype)
                            continue
                        try:
                            n_rows, n_cols, cand = _level_plan(
                                wsi, power, patch_size, tissue_threshold,
                                downscale, camelyon=False)
                            if not put(("level", (slide_id, power, n_rows,
                                                  n_cols, cand))):
                                return
                            src = _patch_source(wsi, load_mode, power,
                                                n_rows, n_cols, patch_size)
                            nb = math.ceil(len(cand) / batch_size)
                            for bi in range(nb):
                                if not put(("batch", _read_batch(
                                        src, cand, bi, power, patch_size,
                                        batch_size, pool, False, stager))):
                                    return
                            if not put(("flush", None)):
                                return
                        except Exception:
                            if not put(("error", (slide_id, power,
                                                  traceback.format_exc()))):
                                return
                finally:
                    wsi.close()
        finally:
            pool.shutdown(wait=False)
            put(END)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()

    cur = None          # (slide_id, power, cand, grid, in_flight)
    try:
        while True:
            kind, payload = q.get()
            if kind == "end":
                break
            if kind == "error":
                slide_id, power, tb = payload
                cur = None
                print(f"FAILED ON SLIDE {slide_id} AT POWER {power}")
                print(tb)
            elif kind == "level":
                slide_id, power, n_rows, n_cols, cand = payload
                grid = np.zeros((n_rows, n_cols, dim), grid_dtype)
                cur = (slide_id, power, cand, grid, [])
                if verbose:
                    print(f"{slide_id} @ {power}: {len(cand)}/"
                          f"{n_rows * n_cols} cells pass tissue threshold")
            elif kind == "batch" and cur is not None:
                arr, s, e = payload
                cur[4].append((encode_fn(_staged(arr).to(dev)), s, e))
            elif kind == "flush" and cur is not None:
                slide_id, power, cand, grid, in_flight = cur
                try:
                    _drain_level(in_flight, cand, grid)
                    store.save(slide_id, power, grid)
                except Exception:
                    print(f"FAILED ON SLIDE {slide_id} AT POWER {power}")
                    traceback.print_exc()
                cur = None
    finally:
        cancelled.set()
        producer.join(timeout=10)
        if stager is not None:
            if stats is not None:
                stats["h2d_busy_s"] = stager.busy_s
                stats["h2d_bytes"] = stager.bytes_staged
            stager.shutdown()
