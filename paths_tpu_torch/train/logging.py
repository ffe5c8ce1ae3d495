"""Metric logging: JSONL file always; wandb when installed (the port's own
copy of `paths_tpu.train.logging`).

The reference hard-requires wandb (`train.py:5,136-148`). Here wandb is
optional: every `log()` call appends a JSON line to `<model_dir>/metrics.jsonl`
(machine-readable history that survives without network access) and is
forwarded to a wandb run when the package is importable. The wandb run id
is persisted to `<model_dir>/wandb_id` so resumed runs continue the same
run (`utils.py:158-166`).
"""
from __future__ import annotations

import json
import os
import random
import string
from typing import Optional


def _get_run_id(folder: str) -> str:
    path = os.path.join(folder, "wandb_id")
    if os.path.isfile(path):
        with open(path) as f:
            return f.readline().strip()
    rid = "".join(random.choices(string.ascii_lowercase + string.digits, k=8))
    with open(path, "w") as f:
        f.write(rid)
    return rid


class MetricsLogger:
    def __init__(self, model_dir: str, config_dict: Optional[dict] = None,
                 project: str = "PATHS", use_wandb: str = "auto"):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, "metrics.jsonl")
        self.wandb = None
        if use_wandb in ("auto", "yes"):
            try:
                import wandb

                name = os.path.split(model_dir.rstrip("/"))[-1]
                self.wandb = wandb.init(
                    project=project, name=name, config=config_dict,
                    resume="allow", id=_get_run_id(model_dir))
                wandb.define_metric("epoch")
                for split in ["train", "test", "val"]:
                    for m in ["loss", "accuracy", "c-index", "AUC"]:
                        wandb.define_metric(f"{split}_{m}", step_metric="epoch")
            except ImportError:
                if use_wandb == "yes":
                    raise

    def log(self, metrics: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics)

    def finish(self) -> None:
        if self.wandb is not None:
            self.wandb.finish()
