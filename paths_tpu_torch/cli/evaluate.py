"""Standalone evaluation of a trained model on a dataset split
(counterpart of `paths_tpu.cli.evaluate`):

    python -m paths_tpu_torch.cli.evaluate -m models/DIR [--split test] \
        [--batch-size N] [--device cuda]

Loads the model directory's `model.npz` (or the reference's `model.pt`),
runs the split through the model's engine (fused, streaming, or auto priced
from the split's shapes) and prints the loss and c-index / AUC as JSON. Runs on the card unless `--device cpu`
is given.
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
    from paths_tpu_torch.train.evaluators import make_evaluator
    from paths_tpu_torch.train.loop import (
        _DeferredRegister,
        _epoch_batches,
        _epoch_batches_streaming,
        make_optimizer,
        make_step_fns,
        set_matmul_precision,
    )
    from paths_tpu_torch.train.state import load_state

    config = Config.load(args.model_dir)
    set_matmul_precision(config.compute_dtype)
    np.random.seed(config.seed)
    device = torch.device(args.device)

    splits = load_splits([0.7, 0.15, 0.15], config.seed, config)
    ds = {"train": splits[0], "val": splits[1], "test": splits[2]}[args.split]
    if ds is None or not len(ds):
        raise ValueError(f"split '{args.split}' is empty")

    model, _, stats = load_state(
        args.model_dir, RecursiveModel(config),
        checkpoint_backend=config.checkpoint_backend)
    model = model.to(device).eval()
    print(f"Loaded checkpoint from epoch {stats.get('epoch')}")

    evaluator = make_evaluator(config, args.split)
    reg = _DeferredRegister(evaluator)
    bs = args.batch_size or config.batch_size[0]

    # honour the trained model's engine: streaming keeps the deeper tables
    # on the host; "auto" prices the fused batch from this split's shapes
    engine = config.engine
    if engine == "auto":
        engine = resolve_engine(config, ds.global_pads(), bs, device=device)

    if engine == "streaming":
        eng = StreamingEngine(config, device)
        for bag0, host_tables, labels, w, slides in _epoch_batches_streaming(
                ds, bs, shuffle=False, seed=0, config=config, device=device):
            loss, pred = eng.evaluate(model, bag0, host_tables, labels)
            reg.push(labels, pred, loss, w)
            if not ds.cache_slides:
                for s_ in slides:
                    s_.unload()
    else:
        _, evaluate = make_step_fns(config,
                                    make_optimizer(config, model.parameters()))
        for bag0, tables, labels, w in _epoch_batches(
                ds, bs, shuffle=False, seed=0, config=config, device=device):
            loss, aux = evaluate(model, bag0, tables, labels)
            reg.push(labels, aux["pred"], loss, w)
    reg.flush()

    out = evaluator.calculate()
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
