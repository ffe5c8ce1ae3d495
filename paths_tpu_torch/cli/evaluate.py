"""Standalone evaluation of a trained model on a dataset split
(counterpart of `paths_tpu.cli.evaluate`):

    python -m paths_tpu_torch.cli.evaluate -m models/DIR [--split test] \
        [--batch-size N] [--device cuda]

Loads the model directory's `model.npz` (or the reference's `model.pt`),
runs the split through the model's engine (fused, streaming, or auto priced
from the split's shapes) and prints the loss and c-index / AUC as JSON. Runs on the card unless `--device cpu`
is given. Under `torchrun --nproc-per-node N` the split is evaluated over
the config's `mesh_shape` ([N], or [dp, sp] with dp * sp = N for sequence
parallelism), one card per process, and rank 0 prints the metrics.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model-dir", required=True)
    parser.add_argument("--split", choices=["train", "val", "test"],
                        default="test")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to evaluate on (default: cuda)")
    args = parser.parse_args(argv)

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import load_splits
    from paths_tpu_torch.engine.auto import resolve_engine
    from paths_tpu_torch.engine.streaming import StreamingEngine
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.parallel.mesh import (
        mesh_from_config,
        replicate,
        seq_axis_size,
    )
    from paths_tpu_torch.runtime import maybe_init_distributed, rank_device
    from paths_tpu_torch.train.evaluators import make_evaluator
    from paths_tpu_torch.train.loop import (
        _DeferredRegister,
        _epoch_batches,
        _epoch_batches_streaming,
        make_optimizer,
        make_step_fns,
        rank_batch,
        set_matmul_precision,
    )
    from paths_tpu_torch.train.state import load_state

    maybe_init_distributed(device=args.device)   # no-op without torchrun
    device = rank_device(args.device)
    config = Config.load(args.model_dir)
    set_matmul_precision(config.compute_dtype)
    np.random.seed(config.seed)
    mesh = mesh_from_config(config)
    rank0 = mesh.rank == 0

    splits = load_splits([0.7, 0.15, 0.15], config.seed, config)
    ds = {"train": splits[0], "val": splits[1], "test": splits[2]}[args.split]
    if ds is None or not len(ds):
        raise ValueError(f"split '{args.split}' is empty")

    model, _, stats = load_state(
        args.model_dir, RecursiveModel(config),
        checkpoint_backend=config.checkpoint_backend)
    model = model.to(device).eval()
    replicate(mesh, model)
    if rank0:
        print(f"Loaded checkpoint from epoch {stats.get('epoch')}")

    evaluator = make_evaluator(config, args.split)
    reg = _DeferredRegister(evaluator, mesh)
    bs = args.batch_size or config.batch_size[0]

    # honour the trained model's engine: streaming keeps the deeper tables
    # on the host; "auto" prices this rank's share of a batch from this
    # split's shapes (as `train_loop` does)
    engine = config.engine
    if engine == "auto":
        engine = resolve_engine(config, ds.global_pads(), rank_batch(bs, mesh),
                                verbose=rank0, device=device,
                                sp=seq_axis_size(mesh))

    batches = dict(shuffle=False, seed=0, config=config, device=device,
                   mesh=mesh)
    if engine == "streaming":
        eng = StreamingEngine(config, device, mesh)
        for bag0, host_tables, labels, w, slides in _epoch_batches_streaming(
                ds, bs, **batches):
            loss, pred = eng.evaluate(model, bag0, host_tables, labels,
                                      denom=float(w.sum()))
            reg.push(labels, pred, loss, w)
            if not ds.cache_slides:
                for s_ in slides:
                    s_.unload()
    else:
        _, evaluate = make_step_fns(config,
                                    make_optimizer(config, model.parameters()),
                                    mesh)
        for bag0, tables, labels, w in _epoch_batches(ds, bs, **batches):
            loss, aux = evaluate(model, bag0, tables, labels,
                                 denom=float(w.sum()))
            reg.push(labels, aux["pred"], loss, w)
    reg.flush()

    out = evaluator.calculate()
    if rank0:
        print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
