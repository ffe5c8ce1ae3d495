"""Batch inference: per-slide predictions from a trained model
(counterpart of `paths_tpu.cli.predict`):

    python -m paths_tpu_torch.cli.predict -m models/DIR [--split test] \
        [-o out.csv] [--batch-size N] [--device cuda]

Writes a CSV of slide-level outputs over a dataset split (`--split all`:
every slide of the metadata). Survival columns: slide_id, risk (= -sum of
the cumulative survival), hazard_0..n. Subtype columns: slide_id, pred
(argmax), p_<class> softmax probabilities. The live model runs on the fused
engine, as in the JAX package, on the card unless `--device cpu` is given.
`--artifact` runs the split through a `cli.export` artifact instead
(`ServingSession(artifact=...)`): no model code runs. Under `torchrun`
every process predicts the whole split on its own card, as JAX's processes
each run a one-device program, and rank 0 writes the CSV.
"""
from __future__ import annotations

import argparse
import csv
import sys

import numpy as np


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model-dir", required=True)
    parser.add_argument("--split", choices=["train", "val", "test", "all"],
                        default="test")
    parser.add_argument("-o", "--out", default=None,
                        help="Output CSV path (default: stdout)")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--artifact", default=None,
                        help="run the split through a cli.export artifact "
                             "instead of the live model")
    parser.add_argument("--device", default="cuda",
                        help="torch device to predict on (default: cuda)")
    args = parser.parse_args(argv)

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import load_splits
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.parallel.mesh import ProcessMesh
    from paths_tpu_torch.runtime import maybe_init_distributed, rank_device
    from paths_tpu_torch.serve import prediction_rows
    from paths_tpu_torch.train.loop import (
        _epoch_batches,
        make_optimizer,
        make_step_fns,
        set_matmul_precision,
    )
    from paths_tpu_torch.train.state import load_state

    maybe_init_distributed(device=args.device)   # no-op without torchrun
    device = rank_device(args.device)
    rank0 = ProcessMesh.current().rank == 0
    config = Config.load(args.model_dir)
    set_matmul_precision(config.compute_dtype)
    np.random.seed(config.seed)

    if args.split == "all":
        ds = load_splits([0.7, 0.15, 0.15], config.seed, config, combined=True)
    else:
        splits = load_splits([0.7, 0.15, 0.15], config.seed, config)
        ds = {"train": splits[0], "val": splits[1],
              "test": splits[2]}[args.split]
    if ds is None or not len(ds):
        raise ValueError(f"split '{args.split}' is empty")

    def csv_row(r):
        if config.task == "survival":
            return [r["slide_id"], f"{r['risk']:.6f}",
                    *[f"{h:.6f}" for h in r["hazards"]]]
        return [r["slide_id"], r["pred"],
                *[f"{r['probs'][c]:.6f}" for c in config.filter_to_subtypes]]

    if args.artifact:
        from paths_tpu_torch.serve import ServingSession

        # a split sweep never repeats a batch: no device batch cache
        session = ServingSession(args.model_dir, artifact=args.artifact,
                                 batch_size=args.batch_size, cache_batches=0,
                                 device=device)
        rows = [csv_row(r) for r in session.predict(ds.slide_ids)]
    else:
        model, _, stats = load_state(
            args.model_dir, RecursiveModel(config),
            checkpoint_backend=config.checkpoint_backend)
        model = model.to(device).eval()
        if rank0:
            print(f"Loaded checkpoint from epoch {stats.get('epoch')}",
                  file=sys.stderr)

        _, evaluate = make_step_fns(config,
                                    make_optimizer(config, model.parameters()))
        bs = args.batch_size or config.batch_size[0]
        rows = []
        pos = 0
        for bag0, tables, labels, w in _epoch_batches(
                ds, bs, shuffle=False, seed=0, config=config, device=device):
            _, aux = evaluate(model, bag0, tables, labels)
            n_real = int(w.sum())
            sids = ds.slide_ids[pos: pos + n_real]
            pos += n_real
            pred = aux["pred"][:n_real].float().cpu().numpy()
            rows.extend(csv_row(r)
                        for r in prediction_rows(config, sids, pred))

    if config.task == "survival":
        header = ["slide_id", "risk"] + [f"hazard_{i}"
                                         for i in range(config.nbins)]
    else:
        header = ["slide_id", "pred"] + [f"p_{c}"
                                         for c in config.filter_to_subtypes]

    if not rank0:
        return rows
    out = open(args.out, "w", newline="") if args.out else sys.stdout
    try:
        writer = csv.writer(out)
        writer.writerow(header)
        writer.writerows(rows)
    finally:
        if args.out:
            out.close()
            print(f"Wrote {len(rows)} predictions to {args.out}",
                  file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
