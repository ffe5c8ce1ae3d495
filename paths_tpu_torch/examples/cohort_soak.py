"""Epoch-scale cohort soak on the port: streaming-engine training at
reference-like cohort size, with host-RAM telemetry (counterpart of
`examples/cohort_soak.py`).

    python -m paths_tpu_torch.examples.cohort_soak [--record] \
        [--slides 300] [--epochs 10] [--task subtype] [--device cuda]

The dress rehearsals prove learning on 48 / 80 slides. This run proves the
operational story at the scale a real cohort trains at:

* a synthetic cohort of 300+ slides with a BRCA-like size spread (about a
  3x range of patch counts), a float16 store of about 10 GB on disk, read
  memory-mapped and never held whole in RAM;
* 10 epochs of the flagship model, batch 32, through
  `paths_tpu_torch.cli.train` on the streaming engine (the tables stay on
  the host; the level-0 bag and each level's gathered children cross to the
  card), validation every 2 epochs from batches kept on the card
  (`cache_eval_batches`), `attention_impl` "pallas" (the port's departure
  from the JAX recipe: evaluations run kernel #1);
* per-epoch wall and host RSS recorded by the train loop
  (`train_stats["epoch_wall_s"]`, `["host_rss_mb"]`), a background sampler
  for the peak, and the least-squares RSS slope from epoch 2 on.

`--keep-store` (with a named `--workdir`) reuses the work dir's store where
it was made with the same slides and seed, and rewrites only its metadata
(for the task asked), so both tasks can run over one store; a store made
otherwise raises. Without `--workdir` the run works in a new temp dir and
removes it, store and all, at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import threading
import time

import numpy as np

from paths_tpu_torch.config import Config
from paths_tpu_torch.examples import (
    FLAGSHIP_DIR,
    RECORDS,
    card_name,
    flash_launches,
    require_device,
    reset_flash_launches,
    stamp_store,
    store_made_with,
    work_dir,
)
from paths_tpu_torch.profiling import host_rss_mb

NOTE = ("Streaming keeps the f16 store memory-mapped: the cohort's features "
        "are never held whole in RAM, and the pages a run reads count in its "
        "RSS while they stay mapped. The port has no counterpart of the TPU "
        "client's per-transfer host leak that the JAX record's slope "
        "measures; its slope is the host memory the process keeps from "
        "epoch to epoch: mapped store pages, the page-locked staging buffers "
        "and the allocator's caches. The reference instead preloads the "
        "whole cohort into RAM (dataset.py:172-180), ~2 GB per 100 f32 "
        "slides.")


def record_dir(task: str) -> str:
    name = "cohort_soak" if task == "survival" else "cohort_soak_subtype"
    return os.path.join(RECORDS, name)


class RssSampler:
    """Background thread sampling host RSS for the true inter-epoch peak."""

    def __init__(self, period_s: float = 0.5):
        self._period = period_s
        self._stop = threading.Event()
        self.samples: list = []
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            rss = host_rss_mb()
            if rss is not None:
                self.samples.append((round(time.time(), 1), rss))
            self._stop.wait(self._period)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)

    def peak_mb(self):
        return max((r for _, r in self.samples), default=None)


def rss_slope(rss: dict):
    """MB per epoch, least squares over the per-epoch RSS from epoch 2 on
    (epoch 1 pays the first touch of every buffer); None under 3 epochs."""
    es = sorted(rss)
    if len(es) < 3:
        return None
    xs = np.asarray(es[1:], float)
    ys = np.asarray([rss[e] for e in es[1:]], float)
    return float(np.polyfit(xs, ys, 1)[0])


def recipe(task: str, workdir: str, epochs: int = 10, seed: int = 0) -> Config:
    """The soak's config: `models/brca_paths_0` with the recipe's
    overrides, its data under `workdir`."""
    cfg = Config.load(FLAGSHIP_DIR, test_mode=True)
    cfg.csv_path = os.path.join(workdir, "meta.csv.zip")
    cfg.preprocess_dir = os.path.join(workdir, "store")
    cfg.wsi_dir = os.path.join(workdir, "brca")
    cfg.hipt_splits = False          # synthetic slides: random 0.7/0.15/0.15
    cfg.seed = seed
    cfg.num_epochs = epochs
    cfg.batch_size = [32]            # the flagship batch (config.json)
    cfg.lr = 5e-4                    # in-budget signal recovery
    cfg.eval_epochs = 2
    cfg.engine = "streaming"
    cfg.cache_eval_batches = True
    cfg.attention_impl = "pallas"    # the port's departure: kernel #1
    if task == "subtype":
        cfg.task = "subtype_classification"
        cfg.filter_to_subtypes = ["IDC", "ILC"]
    return cfg


def write_cohort(cfg: Config, slides: int, seed: int, subtype: bool,
                 keep_store: bool) -> None:
    """The f16 signal store (unless kept) and its metadata for the task."""
    from paths_tpu_torch.data.synthetic import (
        make_signal_metadata,
        make_signal_store,
        signal_direction_z,
    )

    made_with = dict(slides=slides, seed=seed, width=cfg.model_config
                     .patch_embed_dim, levels=cfg.num_levels, base_hw=[4, 5],
                     size_jitter=6, dtype="float16")
    if keep_store and store_made_with(cfg.preprocess_dir, **made_with):
        # the store's ids and latent risks, without drawing its grids again
        ids = [f"SYN-{i:04d}-01Z-00" for i in range(slides)]
        _, z = signal_direction_z(np.random.default_rng(seed),
                                  cfg.model_config.patch_embed_dim, slides)
    else:
        print(f"== 1/4 synthesize {slides} BRCA-shaped signal slides "
              f"(f16 store, ~3x size spread, seed {seed})", flush=True)
        ids, z = make_signal_store(
            cfg.preprocess_dir, cfg, num_slides=slides, seed=seed,
            base_hw=(4, 5), size_jitter=6, store_dtype=np.float16)
        stamp_store(cfg.preprocess_dir, **made_with)
    make_signal_metadata(cfg.csv_path, ids, z, seed=seed,
                         subtypes=["IDC", "ILC"] if subtype else None,
                         label_noise=0.25)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="default: a new temp dir, removed at the end")
    ap.add_argument("--task", choices=["survival", "subtype"],
                    default="survival",
                    help="subtype: IDC-vs-ILC labels from the same latent "
                         "signal (reports AUC)")
    ap.add_argument("--slides", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep-store", action="store_true",
                    help="reuse the named work dir's store where it was made "
                         "with these slides and seed (skip synthesis)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--record", action="store_true",
                    help="copy the run record into "
                         "paths_tpu_torch/examples/records/")
    args = ap.parse_args(argv)
    if args.keep_store and not args.workdir:
        ap.error("--keep-store reuses the store of a named --workdir")
    device = require_device(args.device)
    wd, made = work_dir(args.workdir, "paths_tpu_torch_cohort_soak")
    try:
        return run(args, device, wd)
    finally:
        if made:
            shutil.rmtree(wd, ignore_errors=True)


def run(args, device, wd: str) -> dict:
    """The soak in the work dir `wd`: cohort, training with telemetry,
    test, summary."""
    from paths_tpu_torch.cli.evaluate import main as evaluate
    from paths_tpu_torch.cli.train import main as train

    if not args.keep_store:
        shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd, exist_ok=True)
    subtype = args.task == "subtype"
    cfg = recipe(args.task, wd, args.epochs, args.seed)

    t0 = time.time()
    write_cohort(cfg, args.slides, args.seed, subtype, args.keep_store)
    store_gb = sum(
        os.path.getsize(os.path.join(cfg.preprocess_dir, f))
        for f in os.listdir(cfg.preprocess_dir)) / 1e9
    print(f"   store: {store_gb:.1f} GB on disk in {time.time() - t0:.0f}s",
          flush=True)

    mdir = os.path.join(wd, "model")
    shutil.rmtree(mdir, ignore_errors=True)
    cfg.save(mdir)

    print(f"== 2/4 train {args.epochs} epochs x ~{(args.slides * 7) // 320} "
          f"steps on {device} (streaming engine, batch 32) with RSS "
          "telemetry", flush=True)
    rss_start = host_rss_mb()
    reset_flash_launches()
    t0 = time.time()
    with RssSampler() as sampler:
        train(["-m", mdir, "--no-wandb", "--device", str(device)])
    train_wall = time.time() - t0

    print("== 3/4 evaluate the held-out test split", flush=True)
    test_metrics = evaluate(["-m", mdir, "--split", "test",
                             "--device", str(device)])
    launches = flash_launches()

    with open(os.path.join(mdir, "train_stats.json")) as f:
        stats = json.load(f)
    walls = {int(k): v for k, v in stats.get("epoch_wall_s", {}).items()}
    rss = {int(k): v for k, v in stats.get("host_rss_mb", {}).items()}
    slope = rss_slope(rss)
    last = str(max(int(k) for k in stats["train_loss"]))
    metric = "AUC" if subtype else "c-index"
    summary = {
        "task": cfg.task,
        "engine": "streaming",
        "slides": args.slides,
        "epochs": args.epochs,
        "seed": args.seed,
        "batch_size": 32,
        "store_gb": round(store_gb, 2),
        "store_dtype": "float16",
        "train_wall_s": round(train_wall, 1),
        "epoch_wall_s": walls,
        "host_rss_mb": rss,
        "rss_mb_start": rss_start,
        "rss_mb_peak": sampler.peak_mb(),
        "rss_mb_end": host_rss_mb(),
        "rss_slope_mb_per_epoch": (round(slope, 1) if slope is not None
                                   else None),
        "final_train_loss": stats["train_loss"][last],
        f"final_train_{metric}": stats[f"train_{metric}"][last],
        f"val_{metric}_history": stats.get(f"val_{metric}"),
        "test_metrics": test_metrics,
        "backend": device.type,
        "device": card_name(device),
        "attention_impl": cfg.attention_impl,
        "kernel_launches": launches,
        "command": (f"python -m paths_tpu_torch.examples.cohort_soak --record "
                    f"--slides {args.slides} --epochs {args.epochs}"
                    + (" --task subtype" if subtype else "")),
        "note": NOTE,
    }
    print("== 4/4 summary", flush=True)
    print(json.dumps(summary, indent=2), flush=True)

    if args.record:
        rdir = record_dir(args.task)
        os.makedirs(rdir, exist_ok=True)
        for f in ("config.json", "metrics.jsonl"):
            shutil.copy(os.path.join(mdir, f), os.path.join(rdir, f))
        with open(os.path.join(rdir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
            f.write("\n")
        print(f"record written to {rdir}", flush=True)
    return summary


if __name__ == "__main__":
    main()
