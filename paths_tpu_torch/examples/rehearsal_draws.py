"""The flagship dress rehearsal over several seeds, from two initial
weights: how far its held-out metric moves from one draw to the next.

    python -m paths_tpu_torch.examples.rehearsal_draws [--seeds 5] \
        [--tasks survival,subtype] [--json draws.json] [--device cuda]

For each task the rehearsal's slides are made once, at seed 0, as
`flagship_dress_rehearsal` makes them. Then for each seed s and each
initial weights the recipe trains for its epochs with `seed` s, which
draws the random 0.7 / 0.15 / 0.15 split, the batch order and the dropout
masks:

* `jax`: the port's fresh model, JAX's `recursive_init(PRNGKey(s))`
  (`models/jax_init.py`), which `cli.train` starts from;
* `module`: the module tree's own placeholder draw after
  `torch.manual_seed(s)` (torch's Linear defaults, Xavier in the
  transformer layers, normal special tokens), saved as the starting state.

Seed 0 with `jax` is the rehearsal itself. Each trained model scores its
test split twice, on the kernel route (`attention_impl` "pallas") and on
the plain one ("xla"). The summary gives, per task and initial weights,
the test metric of every seed, how many met the rehearsal's 0.80 bar, and
the largest kernel-vs-plain gap in the test metric and loss.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

from paths_tpu_torch.examples import (
    card_name,
    flagship_dress_rehearsal as reh,
    require_device,
    work_dir,
)

INITS = ("jax", "module")
BAR = 0.80


def draw(task: str, wd: str, seed: int, init: str, epochs: int,
         device) -> dict:
    """One training of the recipe at `seed` from `init`; its losses, last
    val metric, and test metric and loss on both attention routes."""
    from paths_tpu_torch.cli.evaluate import main as evaluate
    from paths_tpu_torch.cli.train import main as train
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.state import save_state

    cfg = reh.recipe(task, wd, epochs, seed)
    mdir = os.path.join(wd, f"{init}_{seed}")
    shutil.rmtree(mdir, ignore_errors=True)
    cfg.save(mdir)
    if init == "module":
        torch.manual_seed(seed)
        save_state(mdir, RecursiveModel(cfg))
    stats = train(["-m", mdir, "--no-wandb", "--device", str(device)])
    metric = "AUC" if task == "subtype" else "c-index"
    row = {"task": task, "seed": seed, "init": init,
           "train_loss_first": stats["train_loss"][1],
           "train_loss_last": stats["train_loss"][epochs],
           f"val_{metric}": stats[f"val_{metric}"][epochs]}
    for impl in ("pallas", "xla"):
        cfg.attention_impl = impl
        cfg.save(mdir)
        test = evaluate(["-m", mdir, "--split", "test",
                         "--device", str(device)])
        row[f"test_{metric}_{impl}"] = test[f"test_{metric}"]
        row[f"test_loss_{impl}"] = test["test_loss"]
    shutil.rmtree(mdir, ignore_errors=True)
    return row


def summarize(rows) -> dict:
    """Per task and initial weights: the test metric (kernel route) by
    seed, how many met the bar, and the kernel-vs-plain gaps."""
    out = {}
    for row in rows:
        metric = "AUC" if row["task"] == "subtype" else "c-index"
        s = out.setdefault(f"{row['task']}/{row['init']}", {
            "metric": f"test_{metric}", "by_seed": {}, "met_bar": 0,
            "max_route_gap_metric": 0.0, "max_route_gap_loss": 0.0})
        value = row[f"test_{metric}_pallas"]
        s["by_seed"][row["seed"]] = value
        s["met_bar"] += int(value >= BAR)
        s["max_route_gap_metric"] = max(
            s["max_route_gap_metric"],
            abs(value - row[f"test_{metric}_xla"]))
        s["max_route_gap_loss"] = max(
            s["max_route_gap_loss"],
            abs(row["test_loss_pallas"] - row["test_loss_xla"]))
    for s in out.values():
        s["mean"] = sum(s["by_seed"].values()) / len(s["by_seed"])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", default="survival,subtype")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--slides", type=int, default=None,
                    help="default 48 (survival) / 80 (subtype)")
    ap.add_argument("--workdir", default=None,
                    help="emptied and used (default: a new temp dir, removed "
                         "at the end)")
    ap.add_argument("--json", default=None, help="also write rows and summary")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    wd, made = work_dir(args.workdir, "paths_tpu_torch_rehearsal_draws")
    rows = []
    try:
        for task in args.tasks.split(","):
            twd = os.path.join(wd, task)
            shutil.rmtree(twd, ignore_errors=True)
            os.makedirs(twd)
            slides = args.slides or reh.default_slides(task)
            reh.write_signal_data(reh.recipe(task, twd, args.epochs, 0),
                                  slides, 0, task == "subtype")
            for seed in range(args.seeds):
                for init in INITS:
                    rows.append(draw(task, twd, seed, init, args.epochs,
                                     device))
                    print("DRAW", json.dumps(rows[-1]), flush=True)
    finally:
        if made:
            shutil.rmtree(wd, ignore_errors=True)
    out = {"rows": rows, "summary": summarize(rows),
           "epochs": args.epochs, "device": card_name(device),
           "command": "python -m paths_tpu_torch.examples.rehearsal_draws "
                      + " ".join(sys.argv[1:] if argv is None else argv)}
    print(json.dumps(out["summary"], indent=2), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
