"""The training loop (counterpart of `paths_tpu.train.loop` on one device).

AdamW with per-epoch exponential LR decay, a per-batch end-to-end
hierarchical forward and backward, periodic validation with optional
best-val early stopping, resume from `train_stats["epoch"]`, and a final
test evaluation. PyTorch runs the step eagerly: forward through all levels,
backward (through the hand-written flash-attention kernels under
`attention_impl: "pallas"`), an optional global-norm clip written to optax's
rule, and the optimizer. Batches are collated on a background thread and
padded to the full batch width with zero-weighted duplicates, so every
batch of a run has one shape.

`config.engine` picks the fused engine (every level's tables on the
device), the streaming engine (`engine/streaming.py`: the deeper tables stay
on the host) or "auto" (`engine/auto.py`: fused when the fused batch fits
the device's memory).

With `remat`, each level's forward is recomputed in the backward
(`engine/hierarchy.py`): between forward and backward only the levels'
inputs are held. Checkpoints go to `model.npz` / `opt.npz` or, under
`checkpoint_backend: "orbax"`, to an Orbax checkpoint (`train/state.py`).

Data parallelism (the JAX package's `data` mesh) runs one process per card
under `torchrun` (`parallel/mesh.py::mesh_from_config`). Every rank builds
the same padded global batches, collates only its own contiguous block of
rows, and divides its loss by the global batch's weight sum; after the
backward one all-reduce sums the gradients, and every rank clips and steps
alike. Predictions and losses are gathered to every rank in global row
order, so evaluators and early stopping see what one process sees. Rank 0
alone writes checkpoints and logs.

Sequence parallelism (`mesh_shape` [dp, sp>1]) runs dp * sp processes: the
sp ranks of a data index share its block of rows, each collating only its
block of every level-0 bag (`data/dataset.py::collate_bag0`'s `seq`), and
run the recursion together (`engine/hierarchy.py`). Each differentiates its
loss scaled by 1 / sp, so the one all-reduce over the world gives the
global gradient (`parallel/mesh.py`); logged losses are not scaled. A rank
draws dropout from the stream of its data index, so the ranks of a group
draw the same masks, and predictions and losses are registered once per
data index (from sequence index 0).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.data.dataset import (
    SlideDataset,
    collate_bag0,
    collate_batch,
    labels_on,
    pad_batch_indices,
    union_pads,
)
from paths_tpu_torch.engine.auto import resolve_engine
from paths_tpu_torch.engine.hierarchy import end2end_loss
from paths_tpu_torch.engine.streaming import StreamingEngine
from paths_tpu_torch.models.jax_init import fresh_model
from paths_tpu_torch.models.recursive import RecursiveModel  # noqa: F401
from paths_tpu_torch.models.recursive import narrow_params
from paths_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    data_axis_size,
    gather_objects,
    mesh_from_config,
    replicate,
    seq_axis_size,
    world_size,
)
from paths_tpu_torch.parallel.seq_attention import SeqSharding
from paths_tpu_torch.profiling import host_rss_mb, span
from paths_tpu_torch.train.evaluators import make_evaluator
from paths_tpu_torch.train.logging import MetricsLogger
from paths_tpu_torch.train.state import load_state, save_state


def set_matmul_precision(compute_dtype: str) -> None:
    """f32 configs get exact f32 matmuls (TF32 off), as the JAX package asks
    of XLA (`paths_tpu.runtime.set_matmul_precision`). bf16 configs keep
    torch's defaults: at the flagship's bf16 products cuBLAS gives the same
    results with its reduced-precision reduction allowed or not
    (`chip_smoke.py`'s `[bf16]` probe on an H100)."""
    if compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def make_optimizer(config: Config, params) -> torch.optim.AdamW:
    """AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay) at
    `config.lr`: the update of the JAX package's optax AdamW. The step
    clips gradients first when `config.clip_grad_norm` is set."""
    return torch.optim.AdamW(params, lr=config.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=config.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's `clip_by_global_norm`, in place: when the global norm is at
    least `max_norm`, every gradient becomes g / norm * max_norm
    (`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm, so it differs).
    The host does not wait for the norm."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def optimizer_step(config: Config, optimizer: torch.optim.Optimizer,
                   mesh=None, model=None) -> None:
    """Apply the gradients in `.grad`: summed over the ranks of `mesh` (the
    sums of `model`'s `narrow_params` rounded to the compute type), the
    optional global-norm clip, then AdamW. Both engines' train steps end
    here."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    narrow = (narrow_params(model, config)
              if model is not None and world_size(mesh) > 1 else ())
    all_reduce_grads(mesh, params, narrow, getattr(torch, config.compute_dtype))
    if config.clip_grad_norm:
        clip_by_global_norm_([p.grad for p in params if p.grad is not None],
                             config.clip_grad_norm)
    optimizer.step()


def epoch_lr(config: Config, epoch: int) -> float:
    """The learning rate of `epoch` (counted from 1): exponential decay."""
    return config.lr * config.lr_decay_per_epoch ** (epoch - 1)


def make_step_fns(config: Config, optimizer: torch.optim.Optimizer,
                  mesh=None):
    """(update, evaluate), both eager.

    `update(model, bag0, tables, labels, generator, epoch=None, denom=None)
    -> (loss, aux)`: one optimizer step on the batch, in training mode
    (dropout masks from `generator`), the gradients summed over the ranks of
    `mesh`; with `epoch` (counted from 1) the learning rate is set to
    `config.lr * lr_decay_per_epoch ** (epoch - 1)`. `evaluate(model, bag0,
    tables, labels, denom=None) -> (loss, aux)`: the loss without dropout or
    gradient. `denom` is the global batch's weight sum where the batch is
    one rank's share (`hierarchy.task_loss`). The returned tensors are
    detached and stay on the device. When `mesh` has a `model` axis, bag0
    is this rank's level-0 block, the recursion runs over its sequence group
    with `config.seq_attention`'s schedule, and `update` differentiates
    loss / sp (module docstring) but returns the loss."""
    seq_mesh = SeqSharding.from_mesh(mesh, config.seq_attention)
    scale = 1.0 / seq_axis_size(mesh)

    def update(model, bag0, tables, labels, generator=None, epoch=None,
               denom=None):
        if epoch is not None:
            set_lr(optimizer, epoch_lr(config, epoch))
        optimizer.zero_grad(set_to_none=True)
        with span("paths.forward"):
            loss, aux = end2end_loss(model, config, bag0, tables, labels,
                                     training=True, generator=generator,
                                     denom=denom, seq_mesh=seq_mesh)
        (loss * scale).backward()
        optimizer_step(config, optimizer, mesh, model)
        return loss.detach(), _detach(aux)

    @torch.no_grad()
    def evaluate(model, bag0, tables, labels, denom=None):
        return end2end_loss(model, config, bag0, tables, labels, denom=denom,
                            seq_mesh=seq_mesh)

    return update, evaluate


def _detach(aux: dict) -> dict:
    return {"pred": aux["pred"].detach(), "logits": aux["logits"].detach(),
            "importances": [i.detach() for i in aux["importances"]]}


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` in a background thread with a bounded queue, so host
    collation and the copy to the card overlap the step. Exceptions reach
    the consumer. If the consumer stops early (an exception mid-epoch, the
    generator closed), a cancel event unblocks the producer's put, so the
    thread exits instead of holding staged batches."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    cancelled = threading.Event()

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancelled.set()


def _padded_batches(dataset: SlideDataset, batch_size: int, shuffle: bool,
                    seed: int, pads, mesh):
    """(padded global indices, their weights, this rank's block of rows) of
    every batch of an epoch. The order is shuffled with
    `np.random.default_rng(seed)`. Batches pad to a multiple of the data
    axis with duplicates of weight 0 and, under static shapes (`pads`), the
    last partial batch pads to ceil(batch_size / W) * W, so every batch of a
    run has one shape (`paths_tpu/train/loop.py::_epoch_batches`)."""
    size = data_axis_size(mesh)
    target = -(-batch_size // size) * size if pads is not None else size
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for s in range(0, len(order), batch_size):
        idx, w = pad_batch_indices(order[s: s + batch_size].tolist(), target)
        rows = mesh.rows(len(idx)) if size > 1 else slice(None)
        yield idx, w, rows


def seq_block(mesh):
    """`collate_bag0`'s `seq` for this rank: (sequence index, sp), or None
    without a `model` axis."""
    return (mesh.seq_index, mesh.seq) if seq_axis_size(mesh) > 1 else None


def _epoch_batches(dataset: SlideDataset, batch_size: int, *, shuffle: bool,
                   seed: int, config: Config, pads=None, device="cuda",
                   mesh=None):
    """Yield (bag0, tables, labels, weights) on `device`, collated on a
    background thread (`_prefetch`); batches as `_padded_batches` makes
    them. The labels carry the weights of their rows as "weight"; bag0,
    tables and labels hold this rank's rows only, and `weights` is the
    global batch's (numpy)."""

    def gen():
        for idx, w, rows in _padded_batches(dataset, batch_size, shuffle,
                                            seed, pads, mesh):
            own = idx[rows]
            bag0, tables = collate_batch(
                dataset, own, level0_bucket=config.level0_bucket, pads=pads,
                device=device, seq=seq_block(mesh))
            labels = labels_on(dataset, own, device)
            labels["weight"] = torch.from_numpy(w[rows]).to(device)
            yield bag0, tables, labels, w

    yield from _prefetch(gen())


def _epoch_batches_streaming(dataset: SlideDataset, batch_size: int, *,
                             shuffle: bool, seed: int, config: Config,
                             pads=None, device="cuda", mesh=None):
    """Streaming-engine batches: (bag0 on `device`, per-slide host table
    lists, labels on `device`, weights, slides). The deeper tables never
    leave host memory. A background thread (`_prefetch`) loads the next
    batch's tables and collates its level-0 bag while the card runs the
    current one. Batches as `_padded_batches` makes them: all but `weights`
    (the global batch's) hold this rank's rows only."""

    def gen():
        for idx, w, rows in _padded_batches(dataset, batch_size, shuffle,
                                            seed, pads, mesh):
            own = idx[rows]
            bag0 = collate_bag0(dataset, own,
                                level0_bucket=config.level0_bucket, pads=pads,
                                device=device, seq=seq_block(mesh))
            slides = [dataset.slides[i] for i in own]
            host_tables = [s_.tables for s_ in slides]
            labels = labels_on(dataset, own, device)
            labels["weight"] = torch.from_numpy(w[rows]).to(device)
            yield bag0, host_tables, labels, w, slides

    yield from _prefetch(gen())


class _DeferredRegister:
    """Register batch k's outputs with an evaluator only when batch k+1's
    are pushed: reading the loss and predictions waits for the card, and
    doing it one step late lets the host queue the next step first. Under
    a data mesh, each rank's rows (labels, predictions) are gathered in rank
    order, which is global row order, and the ranks' losses summed: every
    rank registers the global batch, trimmed to its real rows (`weights` is
    the global batch's). The ranks of a sequence group hold the same rows
    and loss, so only sequence index 0's count."""

    def __init__(self, evaluator, mesh=None):
        self.ev = evaluator
        self.mesh = mesh
        self.pending = None

    def push(self, labels, pred, loss, w):
        self.flush()
        self.pending = (labels, pred, loss, w)

    def flush(self):
        if self.pending is None:
            return
        labels, pred, loss, w = self.pending
        self.pending = None
        parts = gather_objects(self.mesh, (
            {k: v.cpu().numpy() for k, v in labels.items()},
            pred.float().cpu().numpy(), float(loss)))
        parts = parts[::max(1, seq_axis_size(self.mesh))]
        n_real = int(w.sum())
        host = {k: np.concatenate([p[0][k] for p in parts])[:n_real]
                for k in parts[0][0]}
        self.ev.register(host, np.concatenate([p[1] for p in parts])[:n_real],
                         sum(p[2] for p in parts))


class _NoLog:
    """The logger of ranks other than 0: rank 0 writes the run's metrics."""

    def log(self, metrics: dict) -> None:
        pass

    def finish(self) -> None:
        pass


def rank_batch(batch_size: int, mesh) -> int:
    """Rows of a padded global batch that one rank holds: ceil(batch_size /
    W)."""
    return -(-batch_size // data_axis_size(mesh))


def dropout_seed(config: Config, mesh) -> int:
    """The seed of a rank's dropout generator: data index 0 draws the
    one-process stream, every other data index a stream of its own (JAX
    draws one global mask, which no split over processes reproduces:
    ROADMAP.md Queue 3 note 9). The ranks of a sequence group share their
    data index's stream, so they draw the same masks."""
    return config.seed + 1 + 1_000_003 * (mesh.data_index if mesh else 0)


def train_loop(config: Config, model_dir: str, train_ds: SlideDataset,
               val_ds: Optional[SlideDataset], test_ds: SlideDataset,
               logger: Optional[MetricsLogger] = None, verbose: bool = True,
               device="cuda") -> dict:
    """Train on `train_ds`, validating on `val_ds` every `eval_epochs`, and
    evaluate on `test_ds` at the end; checkpoints go to `model_dir`, and a
    run there resumes from its saved epoch. Returns train_stats. Under a
    process group (`runtime.maybe_init_distributed`) the run is data
    parallel over its ranks (`parallel/mesh.py::mesh_from_config`), each on
    its own `device`."""
    mesh = mesh_from_config(config)
    rank0 = mesh.rank == 0
    verbose = verbose and rank0
    set_matmul_precision(config.compute_dtype)
    device = torch.device(device)
    if rank0:
        log = logger or MetricsLogger(model_dir, config.to_dict(),
                                      use_wandb="no")
    else:
        log = _NoLog()
    splits = [d for d in (train_ds, val_ds, test_ds) if d is not None]
    batch_size = config.batch_size[0]

    engine = config.engine
    if engine == "auto":
        # price the fused engine's residency from the full-shape scan; the
        # same pads then drive static collation. A rank prices its share of
        # the batch against its card; JAX prices the global batch against
        # one device (`paths_tpu/engine/auto.py`), though each device holds
        # a share there too: the two agree on one device
        auto_pads = union_pads(*(d.global_pads() for d in splits))
        engine = resolve_engine(config, auto_pads, rank_batch(batch_size, mesh),
                                verbose=verbose, device=device,
                                sp=seq_axis_size(mesh))
    streaming = engine == "streaming"

    # one padded shape for train and both eval splits; the streaming engine
    # pads only the level-0 bag, so its scan reads one grid per slide
    pads = None
    if config.static_shapes:
        if config.engine == "auto":
            pads = auto_pads   # full pads; streaming reads n0 only
        else:
            pads = union_pads(*(d.global_pads(level0_only=streaming)
                                for d in splits))

    # a fresh run starts from the JAX package's initial weights for the
    # seed (`models/jax_init.py`); a saved state replaces them below
    model = fresh_model(config, config.seed).to(device)
    optimizer = make_optimizer(config, model.parameters())
    clip = config.clip_grad_norm
    model, optimizer, train_stats = load_state(
        model_dir, model, optimizer, clip_grad_norm=clip,
        checkpoint_backend=config.checkpoint_backend)
    replicate(mesh, model, optimizer)
    start_epoch = train_stats["epoch"]
    metric = "c-index" if config.task == "survival" else "AUC"
    for key in ["train_loss", f"train_{metric}", "val_loss", f"val_{metric}"]:
        train_stats.setdefault(key, {})

    def save() -> None:
        """Rank 0 writes; the others wait until the files are there."""
        if rank0:
            save_state(model_dir, model, optimizer, train_stats,
                       clip_grad_norm=clip, backend=config.checkpoint_backend)
        barrier(mesh)

    update, evaluate = make_step_fns(config, optimizer, mesh)
    eng = StreamingEngine(config, device, mesh) if streaming else None
    generator = torch.Generator(device=device).manual_seed(
        dropout_seed(config, mesh))
    best_val_score = -1.0
    eval_cache: dict = {}   # id(dataset) -> batches kept on the device
    batches = dict(config=config, pads=pads, device=device, mesh=mesh)

    def eval_batches(dataset, cacheable):
        """The val split's batches are the same every pass; with
        `cache_eval_batches` they stay on the device after the first. The
        test split runs once and stays lazy."""
        cacheable = cacheable and config.cache_eval_batches
        if cacheable and id(dataset) in eval_cache:
            return eval_cache[id(dataset)]
        out = _epoch_batches(dataset, batch_size, shuffle=False, seed=0,
                             **batches)
        if cacheable:
            eval_cache[id(dataset)] = list(out)
            return eval_cache[id(dataset)]
        return out

    def streaming_eval_batches(dataset, cacheable):
        """Streaming counterpart of `eval_batches`: the cache holds the
        device side of each batch (level-0 bag, labels, weights) and the
        slides, whose tables are rebuilt from the store when they were
        unloaded; the lookups ship fresh every pass (they follow the live
        weights' selections)."""
        cacheable = cacheable and config.cache_eval_batches
        cached = eval_cache.get(id(dataset)) if cacheable else None
        if cached is not None:
            for bag0, labels, w, slides in cached:
                yield bag0, [s_.tables for s_ in slides], labels, w, slides
            return
        fresh = []
        for bag0, host_tables, labels, w, slides in _epoch_batches_streaming(
                dataset, batch_size, shuffle=False, seed=0, **batches):
            if cacheable:
                fresh.append((bag0, labels, w, slides))
            yield bag0, host_tables, labels, w, slides
        if cacheable:
            eval_cache[id(dataset)] = fresh

    def unload(dataset, slides):
        if not dataset.cache_slides:
            for s_ in slides:
                s_.unload()

    def run_eval(dataset, evaluator, cacheable=False):
        reg = _DeferredRegister(evaluator, mesh)
        if streaming:
            for bag0, host_tables, labels, w, slides in \
                    streaming_eval_batches(dataset, cacheable):
                loss, pred = eng.evaluate(model, bag0, host_tables, labels,
                                          denom=float(w.sum()))
                reg.push(labels, pred, loss, w)
                unload(dataset, slides)
        else:
            for bag0, tables, labels, w in eval_batches(dataset, cacheable):
                loss, aux = evaluate(model, bag0, tables, labels,
                                     denom=float(w.sum()))
                reg.push(labels, aux["pred"], loss, w)
        reg.flush()

    if verbose:
        ranks = f", {mesh.size} ranks" if mesh.size > 1 else ""
        if seq_axis_size(mesh) > 1:
            ranks += f" as {mesh.shape}, seq_attention {config.seq_attention}"
        print(f"Training starts at epoch {start_epoch} (device {device}, "
              f"engine {engine}{ranks})")

    train_eval = make_evaluator(config, "train")
    val_eval = make_evaluator(config, "val")

    for e in range(start_epoch, config.num_epochs + 1):
        t0 = time.time()
        reg = _DeferredRegister(train_eval, mesh)
        seed = config.seed * 100_003 + e
        if streaming:
            set_lr(optimizer, epoch_lr(config, e))
            for bag0, host_tables, labels, w, slides in _epoch_batches_streaming(
                    train_ds, batch_size, shuffle=True, seed=seed, **batches):
                loss, pred, _ = eng.loss_and_grad(model, bag0, host_tables,
                                                  labels, generator=generator,
                                                  denom=float(w.sum()))
                optimizer_step(config, optimizer, mesh, model)
                reg.push(labels, pred, loss, w)
                unload(train_ds, slides)
        else:
            for bag0, tables, labels, w in _epoch_batches(
                    train_ds, batch_size, shuffle=True, seed=seed, **batches):
                loss, aux = update(model, bag0, tables, labels, generator,
                                   epoch=e, denom=float(w.sum()))
                reg.push(labels, aux["pred"], loss, w)
        reg.flush()
        log.log(train_eval.calculate(train_stats, e) | {"epoch": e})
        train_eval.reset()
        # run telemetry: wall time and host memory per epoch, so long runs
        # show both stay bounded
        train_stats.setdefault("epoch_wall_s", {})[e] = round(
            time.time() - t0, 2)
        rss = host_rss_mb()
        if rss is not None:
            train_stats.setdefault("host_rss_mb", {})[e] = rss
        if verbose:
            print(f"Epoch {e}/{config.num_epochs} ({time.time() - t0:.1f}s, "
                  f"rss {rss or 0:.0f}MB) "
                  f"train_loss={train_stats['train_loss'].get(e, float('nan')):.4f}")

        # periodic checkpoint; under early stopping the saved checkpoint
        # stays the best-val one
        if (config.save_epochs and e % config.save_epochs == 0
                and not config.early_stopping):
            train_stats["epoch"] = e + 1
            save()

        if e % config.eval_epochs == 0 and val_ds is not None and len(val_ds):
            run_eval(val_ds, val_eval, cacheable=True)
            log_dict = val_eval.calculate(train_stats, e) | {"epoch": e}
            log.log(log_dict)
            val_eval.reset()
            val_score = log_dict[f"val_{metric}"]
            if (config.early_stopping and val_score > best_val_score
                    and e >= config.min_epochs):
                best_val_score = val_score
                train_stats["epoch"] = e + 1
                save()

    if config.early_stopping:
        model, optimizer, s = load_state(
            model_dir, model, optimizer, clip_grad_norm=clip,
            checkpoint_backend=config.checkpoint_backend)
        replicate(mesh, model, optimizer)
        if verbose:
            print(f"Early stopping: loading from epoch {s['epoch']}")

    train_stats["epoch"] = config.num_epochs
    save()

    test_eval = make_evaluator(config, "test")
    run_eval(test_ds, test_eval)
    log.log(test_eval.calculate(train_stats) | {"epoch": config.num_epochs})
    log.finish()
    return train_stats
