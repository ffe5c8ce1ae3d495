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
`checkpoint_backend: "orbax"`, to an Orbax checkpoint (`train/state.py`). Not
ported: a mesh over more than one device raises NotImplementedError.
"""
from __future__ import annotations

import math
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
from paths_tpu_torch.models.recursive import RecursiveModel
from paths_tpu_torch.profiling import host_rss_mb
from paths_tpu_torch.train.evaluators import make_evaluator
from paths_tpu_torch.train.logging import MetricsLogger
from paths_tpu_torch.train.state import load_state, save_state


def set_matmul_precision(compute_dtype: str) -> None:
    """f32 configs get exact f32 matmuls (TF32 off), as the JAX package asks
    of XLA (`paths_tpu.runtime.set_matmul_precision`)."""
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


def optimizer_step(config: Config, optimizer: torch.optim.Optimizer) -> None:
    """Apply the gradients in `.grad`: the optional global-norm clip, then
    AdamW. Both engines' train steps end here."""
    if config.clip_grad_norm:
        clip_by_global_norm_([p.grad for g in optimizer.param_groups
                              for p in g["params"] if p.grad is not None],
                             config.clip_grad_norm)
    optimizer.step()


def epoch_lr(config: Config, epoch: int) -> float:
    """The learning rate of `epoch` (counted from 1): exponential decay."""
    return config.lr * config.lr_decay_per_epoch ** (epoch - 1)


def make_step_fns(config: Config, optimizer: torch.optim.Optimizer):
    """(update, evaluate), both eager.

    `update(model, bag0, tables, labels, generator, epoch=None) -> (loss,
    aux)`: one optimizer step on the batch, in training mode (dropout
    masks from `generator`); with `epoch` (counted from 1) the learning
    rate is set to `config.lr * lr_decay_per_epoch ** (epoch - 1)`. `evaluate(model, bag0, tables, labels) -> (loss, aux)`:
    the loss without dropout or gradient. The returned tensors are detached
    and stay on the device."""

    def update(model, bag0, tables, labels, generator=None, epoch=None):
        if epoch is not None:
            set_lr(optimizer, epoch_lr(config, epoch))
        optimizer.zero_grad(set_to_none=True)
        loss, aux = end2end_loss(model, config, bag0, tables, labels,
                                 training=True, generator=generator)
        loss.backward()
        optimizer_step(config, optimizer)
        return loss.detach(), _detach(aux)

    @torch.no_grad()
    def evaluate(model, bag0, tables, labels):
        return end2end_loss(model, config, bag0, tables, labels)

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


def _epoch_batches(dataset: SlideDataset, batch_size: int, *, shuffle: bool,
                   seed: int, config: Config, pads=None, device="cuda"):
    """Yield (bag0, tables, labels, weights) on `device`, collated on a
    background thread (`_prefetch`). Under static shapes (`pads`), the last
    partial batch is padded to the full batch width with duplicates of
    weight 0, so every batch has one shape; the labels carry those weights
    as "weight". The order is shuffled with `np.random.default_rng(seed)`."""
    target = batch_size if pads is not None else 1

    def gen():
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx, w = pad_batch_indices(order[s: s + batch_size].tolist(),
                                       target)
            bag0, tables = collate_batch(
                dataset, idx, level0_bucket=config.level0_bucket, pads=pads,
                device=device)
            labels = labels_on(dataset, idx, device)
            labels["weight"] = torch.from_numpy(w).to(device)
            yield bag0, tables, labels, w

    yield from _prefetch(gen())


def _epoch_batches_streaming(dataset: SlideDataset, batch_size: int, *,
                             shuffle: bool, seed: int, config: Config,
                             pads=None, device="cuda"):
    """Streaming-engine batches: (bag0 on `device`, per-slide host table
    lists, labels on `device`, weights, slides). The deeper tables never
    leave host memory. A background thread (`_prefetch`) loads the next
    batch's tables and collates its level-0 bag while the card runs the
    current one. Under static shapes (`pads`) the last partial batch is
    padded to the full width, as in `_epoch_batches`."""
    target = batch_size if pads is not None else 1

    def gen():
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx, w = pad_batch_indices(order[s: s + batch_size].tolist(),
                                       target)
            bag0 = collate_bag0(dataset, idx,
                                level0_bucket=config.level0_bucket, pads=pads,
                                device=device)
            slides = [dataset.slides[i] for i in idx]
            host_tables = [s_.tables for s_ in slides]
            labels = labels_on(dataset, idx, device)
            labels["weight"] = torch.from_numpy(w).to(device)
            yield bag0, host_tables, labels, w, slides

    yield from _prefetch(gen())


class _DeferredRegister:
    """Register batch k's outputs with an evaluator only when batch k+1's
    are pushed: reading the loss and predictions waits for the card, and
    doing it one step late lets the host queue the next step first."""

    def __init__(self, evaluator):
        self.ev = evaluator
        self.pending = None

    def push(self, labels, pred, loss, w):
        self.flush()
        self.pending = (labels, pred, loss, w)

    def flush(self):
        if self.pending is None:
            return
        labels, pred, loss, w = self.pending
        self.pending = None
        n_real = int(w.sum())
        host = {k: v.cpu().numpy()[:n_real] for k, v in labels.items()}
        self.ev.register(host, pred.float().cpu().numpy()[:n_real],
                         float(loss))


def _refuse_unported(config: Config) -> None:
    if config.mesh_shape and math.prod(config.mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh_shape={config.mesh_shape}: the port trains on one device "
            "(ROADMAP.md Queue 1 item 8, 'Parallel')")


def train_loop(config: Config, model_dir: str, train_ds: SlideDataset,
               val_ds: Optional[SlideDataset], test_ds: SlideDataset,
               logger: Optional[MetricsLogger] = None, verbose: bool = True,
               device="cuda") -> dict:
    """Train on `train_ds`, validating on `val_ds` every `eval_epochs`, and
    evaluate on `test_ds` at the end; checkpoints go to `model_dir`, and a
    run there resumes from its saved epoch. Returns train_stats."""
    _refuse_unported(config)
    set_matmul_precision(config.compute_dtype)
    device = torch.device(device)
    log = logger or MetricsLogger(model_dir, config.to_dict(), use_wandb="no")
    splits = [d for d in (train_ds, val_ds, test_ds) if d is not None]

    engine = config.engine
    if engine == "auto":
        # price the fused engine's residency from the full-shape scan; the
        # same pads then drive static collation
        auto_pads = union_pads(*(d.global_pads() for d in splits))
        engine = resolve_engine(config, auto_pads, config.batch_size[0],
                                verbose=verbose, device=device)
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

    model = RecursiveModel(
        config, generator=torch.Generator().manual_seed(config.seed)).to(device)
    optimizer = make_optimizer(config, model.parameters())
    clip = config.clip_grad_norm
    model, optimizer, train_stats = load_state(
        model_dir, model, optimizer, clip_grad_norm=clip,
        checkpoint_backend=config.checkpoint_backend)
    start_epoch = train_stats["epoch"]
    metric = "c-index" if config.task == "survival" else "AUC"
    for key in ["train_loss", f"train_{metric}", "val_loss", f"val_{metric}"]:
        train_stats.setdefault(key, {})

    update, evaluate = make_step_fns(config, optimizer)
    eng = StreamingEngine(config, device) if streaming else None
    batch_size = config.batch_size[0]
    generator = torch.Generator(device=device).manual_seed(config.seed + 1)
    best_val_score = -1.0
    eval_cache: dict = {}   # id(dataset) -> batches kept on the device

    def eval_batches(dataset, cacheable):
        """The val split's batches are the same every pass; with
        `cache_eval_batches` they stay on the device after the first. The
        test split runs once and stays lazy."""
        cacheable = cacheable and config.cache_eval_batches
        if cacheable and id(dataset) in eval_cache:
            return eval_cache[id(dataset)]
        batches = _epoch_batches(dataset, batch_size, shuffle=False, seed=0,
                                 config=config, pads=pads, device=device)
        if cacheable:
            eval_cache[id(dataset)] = list(batches)
            return eval_cache[id(dataset)]
        return batches

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
                dataset, batch_size, shuffle=False, seed=0, config=config,
                pads=pads, device=device):
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
        reg = _DeferredRegister(evaluator)
        if streaming:
            for bag0, host_tables, labels, w, slides in \
                    streaming_eval_batches(dataset, cacheable):
                loss, pred = eng.evaluate(model, bag0, host_tables, labels)
                reg.push(labels, pred, loss, w)
                unload(dataset, slides)
        else:
            for bag0, tables, labels, w in eval_batches(dataset, cacheable):
                loss, aux = evaluate(model, bag0, tables, labels)
                reg.push(labels, aux["pred"], loss, w)
        reg.flush()

    if verbose:
        print(f"Training starts at epoch {start_epoch} (device {device}, "
              f"engine {engine})")

    train_eval = make_evaluator(config, "train")
    val_eval = make_evaluator(config, "val")

    for e in range(start_epoch, config.num_epochs + 1):
        t0 = time.time()
        reg = _DeferredRegister(train_eval)
        seed = config.seed * 100_003 + e
        if streaming:
            set_lr(optimizer, epoch_lr(config, e))
            for bag0, host_tables, labels, w, slides in _epoch_batches_streaming(
                    train_ds, batch_size, shuffle=True, seed=seed,
                    config=config, pads=pads, device=device):
                loss, pred, _ = eng.loss_and_grad(model, bag0, host_tables,
                                                  labels, generator=generator)
                optimizer_step(config, optimizer)
                reg.push(labels, pred, loss, w)
                unload(train_ds, slides)
        else:
            for bag0, tables, labels, w in _epoch_batches(
                    train_ds, batch_size, shuffle=True, seed=seed,
                    config=config, pads=pads, device=device):
                loss, aux = update(model, bag0, tables, labels, generator,
                                   epoch=e)
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
            save_state(model_dir, model, optimizer, train_stats,
                       clip_grad_norm=clip, backend=config.checkpoint_backend)

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
                save_state(model_dir, model, optimizer, train_stats,
                           clip_grad_norm=clip,
                           backend=config.checkpoint_backend)

    if config.early_stopping:
        model, optimizer, s = load_state(
            model_dir, model, optimizer, clip_grad_norm=clip,
            checkpoint_backend=config.checkpoint_backend)
        if verbose:
            print(f"Early stopping: loading from epoch {s['epoch']}")

    train_stats["epoch"] = config.num_epochs
    save_state(model_dir, model, optimizer, train_stats, clip_grad_norm=clip,
               backend=config.checkpoint_backend)

    test_eval = make_evaluator(config, "test")
    run_eval(test_ds, test_eval)
    log.log(test_eval.calculate(train_stats) | {"epoch": config.num_epochs})
    log.finish()
    return train_stats
