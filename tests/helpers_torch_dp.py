"""A rank of the port's data-parallel CPU tests (`tests/test_torch_dp_train.py`).

Started by `launch` below with the environment torchrun sets (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); joins a process group
(gloo on the CPU unless told otherwise) with a 60-s collective timeout,
runs the jobs of a JSON file in order and writes what each returns to
`<out>/rank<r>.json` (arrays to `<out>/<job>_rank<r>.npz`). Imports torch
and the port only, so the card tests (`tests/test_torch_cuda.py -k dp`)
use it too.

Jobs (`kind`):
  step     one AdamW update on this rank's rows of a padded batch
  train    `train_loop` over a model directory's splits
  load     `load_state` then `replicate`: what a resuming rank starts from
  evaluate `cli.evaluate` on a split
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60
CHILD_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world: int, spec: str, out: str) -> list:
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, out], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _wait(procs: list, deadline: float) -> list:
    """(stdout, stderr) of every rank; all are killed at the deadline."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, e = p.communicate()
            logs.append((o, e + f"\nkilled after {CHILD_TIMEOUT_S} s"))
    return logs


def launch(*runs, device="cpu", backend=None) -> list:
    """Run each `(world, jobs, out)` of `runs` on `world` ranks, all runs at
    once, every rank on `device` (an unindexed "cuda": its own card) over
    `backend` (`maybe_init_distributed`'s choice when None); returns each
    run's per-rank results. Every rank is killed past CHILD_TIMEOUT_S. A run
    whose rendezvous failed (a loaded host) is relaunched once; any other
    failure raises with the ranks' output."""
    specs = []
    for world, jobs, out in runs:
        os.makedirs(out, exist_ok=True)
        specs.append(os.path.join(out, "jobs.json"))
        with open(specs[-1], "w") as f:
            json.dump({"device": device, "backend": backend, "jobs": jobs}, f)
    todo = list(range(len(runs)))
    for attempt in range(2):
        started = {i: _start(runs[i][0], specs[i], runs[i][2]) for i in todo}
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        failed = []
        for i, procs in started.items():
            logs = _wait(procs, deadline)
            if all(p.returncode == 0 for p in procs):
                continue
            rendezvous = any("DistNetworkError" in e or "DistStoreError" in e
                             for _, e in logs)
            if attempt == 1 or not rendezvous:
                tails = "\n---\n".join(
                    f"rank {r} rc={p.returncode}:\n{o[-2000:]}\n{e[-4000:]}"
                    for r, (p, (o, e)) in enumerate(zip(procs, logs)))
                raise AssertionError(f"ranks failed:\n{tails}")
            failed.append(i)
        todo = failed
        if not todo:
            break
    results = []
    for world, _, out in runs:
        results.append([])
        for rank in range(world):
            with open(os.path.join(out, f"rank{rank}.json")) as f:
                results[-1].append(json.load(f))
    return results


def _run(job: dict, rank: int, out: str, device):
    import torch

    from paths_tpu_torch import convert
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data import dataset as tdata
    from paths_tpu_torch.data.feature_store import FeatureStore
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.parallel.mesh import mesh_from_config, replicate
    from paths_tpu_torch.train import loop as tloop
    from paths_tpu_torch.train import state as tstate

    kind, d = job["kind"], job["dir"]
    arrays = {}
    if kind == "step":
        cfg = Config.load(d)
        mesh = mesh_from_config(cfg)
        model = RecursiveModel(cfg).to(device)
        opt = tloop.make_optimizer(cfg, model.parameters())
        model, opt, _ = tstate.load_state(d, model, opt)
        replicate(mesh, model, opt)
        idx, w = job["idx"], np.asarray(job["labels"]["weight"], np.float32)
        rows = mesh.rows(len(idx))
        # the padded batch's own widths (as JAX collates it whole), so each
        # rank's block has the global batch's shapes
        store = FeatureStore(cfg.preprocess_dir)
        ds = tdata.SlideDataset(job["ids"], cfg, store)
        pads = tdata.SlideDataset([job["ids"][i] for i in idx], cfg,
                                  store).global_pads()
        bag, tables = tdata.collate_batch(ds, idx[rows], level0_bucket=32,
                                          pads=pads, device=device)
        labels = {k: torch.from_numpy(np.asarray(v)[rows]).to(device)
                  for k, v in job["labels"].items()}
        update, _ = tloop.make_step_fns(cfg, opt, mesh)
        loss, _ = update(model, bag, tables, labels, epoch=1,
                         denom=float(w.sum()))
        arrays = convert.to_jax_flat(model)
        result = {"loss": float(loss)}
    elif kind == "train":
        cfg = Config.load(d)
        splits = tdata.load_splits(job.get("props", [0.7, 0.15, 0.15]),
                                   cfg.seed, cfg)
        stats = tloop.train_loop(cfg, d, *splits, device=device,
                                 verbose=False)
        model = RecursiveModel(cfg)
        arrays = convert.to_jax_flat(tstate.load_model(d, model))
        result = {"train_loss": stats["train_loss"],
                  "val_loss": stats.get("val_loss", {})}
    elif kind == "load":
        cfg = Config.load(d)
        model = RecursiveModel(cfg)
        opt = tloop.make_optimizer(cfg, model.parameters())
        model, opt, _ = tstate.load_state(d, model, opt)
        replicate(mesh_from_config(cfg), model, opt)
        arrays = {**convert.to_jax_flat(model),
                  **tstate.optimizer_to_jax_flat(model, opt, None)}
        result = {}
    elif kind == "evaluate":
        from paths_tpu_torch.cli.evaluate import main

        result = main(["-m", d, "--split", "test", "--device", str(device)])
    else:
        raise ValueError(kind)
    if arrays:
        np.savez(os.path.join(out, f"{job['name']}_rank{rank}.npz"), **arrays)
    return result


def main(spec: str, out: str) -> None:
    from paths_tpu_torch.runtime import maybe_init_distributed, rank_device

    with open(spec) as f:
        spec = json.load(f)
    assert maybe_init_distributed(spec["backend"], spec["device"],
                                  timeout=GROUP_TIMEOUT_S)
    device = rank_device(spec["device"])
    rank = int(os.environ["RANK"])
    results = {job["name"]: _run(job, rank, out, device)
               for job in spec["jobs"]}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
