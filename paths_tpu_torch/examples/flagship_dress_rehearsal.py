"""Flagship dress rehearsal on the port: the reproducible held-out learning
proof (counterpart of `examples/flagship_dress_rehearsal.py`).

    python -m paths_tpu_torch.examples.flagship_dress_rehearsal [--record] \
        [--task subtype] [--device cuda]

The full `brca_paths_0` model (1024-d features, `trans_dim` 128, 4 heads,
2 + 2 layers, 5 levels at 0.625x..10x, top-K 20, LSTM context, 2-D PE,
dropout 0.05; `models/brca_paths_0/config.json`) trains for 40 epochs
through `paths_tpu_torch.cli.train` on the streaming engine, over 48
synthetic BRCA-shaped slides whose features carry a latent risk signal
(`make_signal_store`) from which the survival labels derive
(`make_signal_metadata`, label noise 0.25). Training must recover that
mapping on held-out slides: `cli.evaluate --split test` scores the test
split. `--task subtype` runs the classification twin (IDC vs ILC labels
thresholded from the same signal, AUC) on 80 slides.

The recipe is the JAX package's (random 0.7 / 0.15 / 0.15 splits, seed 0,
batch 12, lr 5e-4, streaming engine; a fresh port run starts from JAX's
initial weights for the seed) with one departure: `attention_impl`
"pallas", so that every evaluation (eval mode, no dropout) runs the
hand-written flash forward (#1) at every level. Training at the published
dropout 0.05 takes the plain attention route in both packages by design
(`nn/attention.py`); the summary records that route and #1-#3's launches.
`--record` writes `config.json`, `train_stats.json`, `metrics.jsonl` and
`summary.json` under `paths_tpu_torch/examples/records/`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from paths_tpu_torch.config import Config
from paths_tpu_torch.examples import (
    FLAGSHIP_DIR,
    RECORDS,
    card_name,
    flash_launches,
    require_device,
    reset_flash_launches,
    work_dir,
)

TRAIN_ROUTE = ("plain attention: dropout {dropout} is active in training, "
               "and the kernel route runs only without it (as in the JAX "
               "package); evaluations run kernel #1")


def record_dir(task: str) -> str:
    name = ("flagship_dress_rehearsal" if task == "survival"
            else "flagship_dress_rehearsal_subtype")
    return os.path.join(RECORDS, name)


def default_slides(task: str) -> int:
    return 80 if task == "subtype" else 48


def recipe(task: str, workdir: str, epochs: int = 40, seed: int = 0) -> Config:
    """The rehearsal's config: `models/brca_paths_0` with the recipe's
    overrides, its data under `workdir`."""
    cfg = Config.load(FLAGSHIP_DIR, test_mode=True)
    cfg.csv_path = os.path.join(workdir, "meta.csv.zip")
    cfg.preprocess_dir = os.path.join(workdir, "store")
    cfg.wsi_dir = os.path.join(workdir, "brca")
    cfg.hipt_splits = False          # synthetic slides: random 0.7/0.15/0.15
    cfg.seed = seed
    cfg.num_epochs = epochs
    cfg.batch_size = [12]            # 33 train slides: 3 steps an epoch
    cfg.lr = 5e-4                    # ~1/30th of a real cohort's steps
    cfg.engine = "streaming"
    cfg.attention_impl = "pallas"    # the port's departure: kernel #1
    if task == "subtype":
        cfg.task = "subtype_classification"
        cfg.filter_to_subtypes = ["IDC", "ILC"]
    return cfg


def write_signal_data(cfg: Config, slides: int, seed: int, subtype: bool,
                      **store_kw) -> None:
    """The signal store and its metadata (label noise 0.25)."""
    from paths_tpu_torch.data.synthetic import (
        make_signal_metadata,
        make_signal_store,
    )

    ids, z = make_signal_store(cfg.preprocess_dir, cfg, num_slides=slides,
                               seed=seed, **store_kw)
    make_signal_metadata(cfg.csv_path, ids, z, seed=seed,
                         subtypes=["IDC", "ILC"] if subtype else None,
                         label_noise=0.25)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="emptied and used (default: a new temp dir, removed "
                         "at the end)")
    ap.add_argument("--task", choices=["survival", "subtype"],
                    default="survival",
                    help="subtype: IDC-vs-ILC labels derived from the same "
                         "latent signal (reports AUC)")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--slides", type=int, default=None,
                    help="default 48 (survival) / 80 (subtype)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--record", action="store_true",
                    help="copy the run record into "
                         "paths_tpu_torch/examples/records/")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    wd, made = work_dir(args.workdir, "paths_tpu_torch_dress_rehearsal")
    try:
        return run(args, device, wd)
    finally:
        if made:
            shutil.rmtree(wd, ignore_errors=True)


def run(args, device, wd: str) -> dict:
    """The rehearsal in the work dir `wd`: data, training, test, summary."""
    from paths_tpu_torch.cli.evaluate import main as evaluate
    from paths_tpu_torch.cli.train import main as train

    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    subtype = args.task == "subtype"
    slides = args.slides or default_slides(args.task)
    cfg = recipe(args.task, wd, args.epochs, args.seed)

    print(f"== 1/4 synthesize {slides} BRCA-shaped signal slides "
          f"(1024-d, 5 levels, seed {args.seed}, task {cfg.task})", flush=True)
    t0 = time.time()
    write_signal_data(cfg, slides, args.seed, subtype)
    print(f"   store built in {time.time() - t0:.0f}s", flush=True)

    mdir = os.path.join(wd, "model")
    cfg.save(mdir)

    print(f"== 2/4 train {args.epochs} epochs via cli.train on {device} "
          f"(streaming engine, batch 12, lr 5e-4)", flush=True)
    reset_flash_launches()
    t0 = time.time()
    train(["-m", mdir, "--no-wandb", "--device", str(device)])
    train_wall = time.time() - t0
    print(f"   trained in {train_wall:.0f}s", flush=True)

    print("== 3/4 evaluate the held-out test split", flush=True)
    test_metrics = evaluate(["-m", mdir, "--split", "test",
                             "--device", str(device)])
    launches = flash_launches()

    with open(os.path.join(mdir, "train_stats.json")) as f:
        stats = json.load(f)
    last = str(max(int(k) for k in stats["train_loss"]))
    metric = "AUC" if subtype else "c-index"
    summary = {
        "task": cfg.task,
        "epochs": args.epochs, "slides": slides, "seed": args.seed,
        "train_wall_s": round(train_wall, 1),
        "final_train_loss": stats["train_loss"][last],
        f"final_train_{metric}": stats[f"train_{metric}"][last],
        f"val_{metric}_history": stats.get(f"val_{metric}"),
        "test_metrics": test_metrics,
        "backend": device.type,
        "device": card_name(device),
        "attention_impl": cfg.attention_impl,
        "train_attention_route": TRAIN_ROUTE.format(
            dropout=cfg.model_config.dropout),
        "kernel_launches": launches,
        "command": ("python -m paths_tpu_torch.examples."
                    "flagship_dress_rehearsal --record"
                    + (" --task subtype" if subtype else "")),
    }
    print("== 4/4 summary", flush=True)
    print(json.dumps(summary, indent=2), flush=True)

    if args.record:
        rdir = record_dir(args.task)
        os.makedirs(rdir, exist_ok=True)
        for f in ("config.json", "train_stats.json", "metrics.jsonl"):
            shutil.copy(os.path.join(mdir, f), os.path.join(rdir, f))
        with open(os.path.join(rdir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
            f.write("\n")
        print(f"record written to {rdir}", flush=True)
    return summary


if __name__ == "__main__":
    main()
