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
  * with a data mesh (`parallel.mesh.make_mesh`), every bucket rounds up to
    a multiple of the mesh size, the staging thread copies each device's
    contiguous slice of a batch to that device, one encoder per device
    encodes its slice, and the level's embeddings come back in order: the
    grids are those of one device
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
from paths_tpu_torch.profiling import count, record_span, span


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
        t0 = time.time_ns()
        try:
            return self._fn(arr)
        finally:
            t1 = time.time_ns()
            self.busy_s += (t1 - t0) * 1e-9
            record_span("paths.preprocess.stage", t0, t1, bytes=arr.nbytes)

    def __call__(self, arr) -> "Future":
        return self._pool.submit(self._run, arr)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)


def _staged(arr, shards: int = 1) -> list:
    """Resolve a staged batch into the tensors the encode may read, one per
    shard: the Future an `_AsyncStager` returned (a transfer error re-raises
    here, at the consuming site), a list of `_StagedBatch` or host tensors,
    or a host array when staging is off (split into `shards` contiguous
    slices). Each shard's stream waits for its copy's event, and the tensor
    is recorded on it so that its memory is not reused while the encode
    reads."""
    if isinstance(arr, Future):
        arr = arr.result()
    if isinstance(arr, np.ndarray):
        return [torch.from_numpy(a) for a in np.split(arr, shards)]
    out = []
    for part in arr:
        if isinstance(part, _StagedBatch):
            stream = torch.cuda.current_stream(part.dev.device)
            stream.wait_event(part.event)
            part.dev.record_stream(stream)
            part = part.dev
        out.append(part)
    return out


def _make_stager(stage_h2d: bool, devices):
    """The host->device staging step, run off the consumer's thread so the
    copy overlaps the card's encode of the previous batch. Returns None when
    staging is off. A batch splits into one contiguous slice per device of
    `devices`. To a CUDA device: pin the slice, copy it with
    `non_blocking=True` on a stream of the stager's own for that device,
    record an event; the staging thread waits for every slice's event. On
    the CPU: wrap the slice."""
    if not stage_h2d:
        return None
    devices = [torch.device(d) for d in devices]
    streams = {d: torch.cuda.Stream(d) for d in devices if d.type == "cuda"}

    def stage(arr: np.ndarray) -> list:
        out = []
        for part, device in zip(np.split(arr, len(devices)), devices):
            if device.type != "cuda":
                out.append(torch.from_numpy(part))
                continue
            host = torch.from_numpy(part).pin_memory()
            with torch.cuda.stream(streams[device]):
                dev = host.to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(streams[device])
            out.append(_StagedBatch(dev, event, host))
        for part in out:
            if isinstance(part, _StagedBatch):
                part.event.synchronize()
        return out

    return stage


def _shard_encoders(encode_fn, device, mesh):
    """(encoders, devices): `encode_fn` on `device`, or with a mesh one
    encoder per mesh device (a sequence as long as the mesh)."""
    if mesh is None:
        return [encode_fn], [torch.device(device)]
    encoders = list(encode_fn)
    if len(encoders) != len(mesh.devices):
        raise ValueError(f"{len(encoders)} encoder(s) for a mesh of "
                         f"{len(mesh.devices)} device(s)")
    return encoders, mesh.devices


def _encode_shards(encoders, devices, staged, valid: int) -> list:
    """Each shard's embeddings, encoded on its own device, under the span
    `paths.preprocess.encode`; while it records, its attribute `rows` is the
    batch's `valid` patches and its counters `vit_rows` the rows the
    dispatch sends through the encoder, bucket padding included, and
    `vit_pad_rows` that padding (with the recorder off, nothing is
    counted)."""
    with span("paths.preprocess.encode") as recorded:
        parts = _staged(staged, len(devices))
        if recorded is not None:
            sent = sum(x.shape[0] for x in parts)
            count("rows", valid)
            count("vit_rows", sent)
            count("vit_pad_rows", sent - valid)
        return [enc(x.to(d)) for enc, d, x in zip(encoders, devices, parts)]


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
                camelyon: bool, stage_fn=None, bucket_mult: int = 1):
    """Host stage 2: read one padded patch batch (thread-pooled rects),
    padded to a multiple of `bucket_mult` (the mesh size). With `stage_fn`
    the copy to the card is issued here, from the reader's side, so it
    overlaps the card's encode of the previous batch."""
    p = patch_size

    def read_cell(rc):
        r, c = rc
        img = wsi.read_rect((r * p, c * p), (p, p), power)
        return camelyon_map(img) if camelyon else img

    s = bi * batch_size
    e = min(s + batch_size, len(cand))
    with span("paths.preprocess.read", patches=e - s):
        imgs = list(pool.map(read_cell, cand[s:e]))
        arr = np.zeros((_bucket(e - s, batch_size, bucket_mult), p, p, 3),
                       np.uint8)
        arr[: e - s] = np.stack(imgs)
        if stage_fn is not None:
            arr = stage_fn(arr)
    return arr, s, e


def _drain_level(in_flight, cand, grid) -> None:
    """Scatter a level's embeddings with ONE device->host copy per shard.
    `in_flight` holds (per-shard embeddings, s, e) per batch. Batch widths
    vary (the tail is bucketed), so rows are consumed by each shard's own
    padded width, shard after shard within a batch."""
    if not in_flight:
        return
    with span("paths.preprocess.drain"):
        host = []
        for j in range(len(in_flight[0][0])):
            embs = [shards[j] for shards, _, _ in in_flight]
            host.append((embs[0] if len(embs) == 1 else torch.cat(embs))
                        .cpu().numpy())
        offs = [0] * len(host)
        for shards, s, e in in_flight:
            rows = []
            for j, emb_dev in enumerate(shards):
                rows.append(host[j][offs[j]: offs[j] + emb_dev.shape[0]])
                offs[j] += emb_dev.shape[0]
            emb = rows[0] if len(rows) == 1 else np.concatenate(rows)
            rs, cs = cand[s:e, 0], cand[s:e, 1]
            grid[rs, cs] = emb[: e - s]


def process_level(wsi: WSIReader, encode_fn: Callable, dim: int, power: float,
                  *, patch_size: int = 256, tissue_threshold: float = 0.1,
                  downscale: int = 4, batch_size: int = 64, threads: int = 8,
                  camelyon: bool = False, load_mode: int = 0,
                  store_dtype="float32", device="cuda", mesh=None,
                  verbose: bool = False) -> np.ndarray:
    """One (slide, magnification) -> (rows/P, cols/P, D) grid in
    `store_dtype`. `encode_fn` takes a (B, P, P, 3) uint8 tensor on `device`
    and returns (B, dim) float32 there; with a `mesh`, it is one such
    function per mesh device, each encoding that device's slice."""
    with span("paths.preprocess.level", power=power):
        with span("paths.preprocess.plan"):
            n_rows, n_cols, cand = _level_plan(
                wsi, power, patch_size, tissue_threshold, downscale, camelyon)
        count("patches", len(cand))
        if verbose:
            print(f"  power {power}: {len(cand)}/{n_rows * n_cols} cells pass "
                  f"tissue threshold")

        grid = np.zeros((n_rows, n_cols, dim), _grid_dtype(store_dtype))
        if len(cand) == 0:
            return grid

        encoders, devices = _shard_encoders(encode_fn, device, mesh)
        stager = _AsyncStager(_make_stager(True, devices))
        src = _patch_source(wsi, load_mode, power, n_rows, n_cols, patch_size)
        pool = ThreadPoolExecutor(max_workers=threads)
        try:
            n_batches = math.ceil(len(cand) / batch_size)

            # software pipeline: read batch k+1 while the card encodes k,
            # and the copy of batch k overlaps the decode of k+1 (stager)
            def read(bi):
                return pool.submit(_read_batch, src, cand, bi, power,
                                   patch_size, batch_size, pool, camelyon,
                                   stager, len(devices))

            pending = read(0)
            in_flight = []  # (per-shard embeddings on their devices, s, e)
            for bi in range(n_batches):
                with span("paths.preprocess.read_wait"):
                    arr, s, e = pending.result()
                if bi + 1 < n_batches:
                    pending = read(bi + 1)
                in_flight.append(
                    (_encode_shards(encoders, devices, arr, e - s), s, e))

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
                  store_dtype="float32", device="cuda", mesh=None,
                  verbose: bool = False) -> None:
    """All magnifications for one slide, with skip-if-exists resume and
    per-(slide, power) fault tolerance (`encode_fn` and `mesh` as in
    `process_level`)."""
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
                    device=device, mesh=mesh, verbose=verbose)
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
                                opts["batch_size"], pool, False,
                                bucket_mult=opts["bucket_mult"])
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
                          mesh=None, poll_s: float = 5.0) -> None:
    """Parent-side consumer of the decode workers' message stream.

    Runs until every worker's `done` sentinel arrives, but survives workers
    that die without one (segfault, OOM kill): when the queue stays quiet
    past `poll_s` and no worker is alive, the messages their feeder threads
    flushed before death are drained and the loop exits with a warning
    instead of blocking on `q.get()` forever. A worker `error` for a level
    whose `level` header already arrived drops the half-built grid and its
    embeddings in flight (a faulty slide must not pin memory for the rest of
    the run). `stage_fn` (or None) moves a host batch towards `device` (or
    the mesh's devices; `encode` as in `process_level`)."""
    import queue as _squeue

    encoders, devices = _shard_encoders(encode, device, mesh)
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
            staged = stage_fn(arr) if stage_fn is not None else arr
            open_levels[key][2].append(
                (_encode_shards(encoders, devices, staged, e - s), s, e))
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
                       stats, device, mesh, verbose) -> None:
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
            "load_mode": load_mode, "store_dtype": store_dtype,
            "bucket_mult": 1 if mesh is None else len(mesh.devices)}
    shards = [list(items)[i::decode_workers] for i in range(decode_workers)]
    procs = [ctx.Process(target=_decode_worker,
                         args=(i, shards[i], list(magnifications),
                               store.root, opts, q), daemon=True)
             for i in range(decode_workers) if shards[i]]
    for p in procs:
        p.start()

    stage_fn = _make_stager(
        stage_h2d, [device] if mesh is None else mesh.devices)
    # staged on the stager's thread, as the single-producer path does, so
    # the same counters fill; the consumer waits for each copy
    stager = _AsyncStager(stage_fn) if stage_fn is not None else None
    try:
        _consume_decode_queue(q, procs, encode=encode_fn, stage_fn=stager,
                              dim=dim, store=store, verbose=verbose,
                              grid_dtype=_grid_dtype(store_dtype),
                              device=device, mesh=mesh)
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
                   stats: Optional[dict] = None, device="cuda", mesh=None,
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
    :param mesh: a data mesh (`parallel.mesh.make_mesh`): `encode_fn` is then
        one encoder per mesh device, and each batch is sharded over them.
    """
    if decode_workers and decode_workers >= 2:
        _process_slides_mp(
            items, encode_fn, dim, magnifications, store,
            decode_workers=decode_workers, patch_size=patch_size,
            tissue_threshold=tissue_threshold, downscale=downscale,
            batch_size=batch_size, threads=threads,
            default_power=default_power, batches_ahead=batches_ahead,
            stage_h2d=stage_h2d, load_mode=load_mode,
            store_dtype=store_dtype, stats=stats, device=device, mesh=mesh,
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

    encoders, devices = _shard_encoders(encode_fn, device, mesh)
    stage_fn = _make_stager(stage_h2d, devices)
    # the copy on its own thread: the producer decodes batch k+1 while batch
    # k crosses the link, so the wall tracks max(decode, copy), not the sum
    stager = _AsyncStager(stage_fn) if stage_fn is not None else None
    grid_dtype = _grid_dtype(store_dtype)

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
                                        batch_size, pool, False, stager,
                                        len(devices)))):
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
                cur[4].append((_encode_shards(encoders, devices, arr, e - s),
                               s, e))
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
