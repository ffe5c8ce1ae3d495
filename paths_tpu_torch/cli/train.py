"""Training entry point (counterpart of `paths_tpu.cli.train`).

    python -m paths_tpu_torch.cli.train -m models/my_experiment [--no-wandb] \
        [--device cuda] [--profile DIR]

The model directory must contain a `config.json`; checkpoints, metrics and
train stats are written back into it in the JAX package's layout, and an
interrupted run resumes from the last saved epoch. Training runs on the card
unless `--device cpu` is given. `--profile DIR` records the whole run with
`torch.profiler` into a `*.pt.trace.json` under DIR (Perfetto, TensorBoard).

Across cards, one process per card:

    torchrun --nproc-per-node N -m paths_tpu_torch.cli.train -m DIR --no-wandb

trains data parallel (`train/loop.py`); rank r runs on `cuda:{LOCAL_RANK}`,
and rank 0 writes the metrics and checkpoints. A config whose `mesh_shape` is
[dp, sp] with sp > 1 trains sequence parallel on dp * sp processes: each
level-0 bag is cut over the sp ranks of a data index (`parallel/mesh.py`).
"""
from __future__ import annotations

import argparse

import numpy as np

from paths_tpu_torch.config import Config
from paths_tpu_torch.data.dataset import load_splits
from paths_tpu_torch.parallel.mesh import ProcessMesh
from paths_tpu_torch.runtime import maybe_init_distributed, rank_device
from paths_tpu_torch.train.logging import MetricsLogger
from paths_tpu_torch.train.loop import train_loop


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model-dir", required=True,
                        help="Path to model directory containing config.json")
    parser.add_argument("--wandb-project-name", type=str, default="PATHS")
    parser.add_argument("--no-wandb", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="record a torch.profiler trace of the run into "
                             "DIR (Perfetto/TensorBoard)")
    args = parser.parse_args(argv)

    maybe_init_distributed(device=args.device)   # no-op without torchrun
    device = rank_device(args.device)
    config = Config.load(args.model_dir)
    np.random.seed(config.seed)

    train, val, test = load_splits([0.7, 0.15, 0.15], config.seed, config)
    if config.early_stopping and not (val is not None and len(val)):
        raise ValueError("early stopping needs a validation set")

    logger = None   # ranks other than 0 log nothing
    if ProcessMesh.current().rank == 0:
        logger = MetricsLogger(args.model_dir, config.to_dict(),
                               project=args.wandb_project_name,
                               use_wandb="no" if args.no_wandb else "auto")
    if args.profile:
        from paths_tpu_torch.profiling import trace

        with trace(args.profile):
            return train_loop(config, args.model_dir, train, val, test,
                              logger=logger, device=device)
    return train_loop(config, args.model_dir, train, val, test, logger=logger,
                      device=device)


if __name__ == "__main__":
    main()
