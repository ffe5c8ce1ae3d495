"""A rank of the port's data- and sequence-parallel CPU tests
(`tests/test_torch_dp_train.py`, `tests/test_torch_seq_attention.py`,
`tests/test_torch_seq_train.py`).

Started by `launch` below with the environment torchrun sets (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); joins a process group
(gloo on the CPU unless told otherwise) with a 60-s collective timeout,
runs the jobs of a JSON file in order and writes what each returns to
`<out>/rank<r>.json` (arrays to `<out>/<job>_rank<r>.npz`). Imports torch
and the port only, so the card tests (`tests/test_torch_cuda.py -k dp`)
use it too.

Jobs (`kind`):
  step     one AdamW update on this rank's rows of a padded batch (under a
           `model` axis, its level-0 block of them); the parameters and,
           with "grads", the world's gradients
  train    `train_loop` over a model directory's splits
  load     `load_state` then `replicate`: what a resuming rank starts from
  evaluate `cli.evaluate` on a split
  seq_attn both sequence-parallel schedules over the world on this rank's
           block of an npz's q, k, v: outputs and gradients (f32), the ring
           in bf16
  level0   level 0 under a config's (data x model) mesh on this rank's block
           of an npz's whole bag (its features in the config's table type),
           on the routes and schedules asked: logits and the gathered
           importance; with "tables" also `end2end_loss`
  affine   a bf16 affine map on this rank's rows of an npz's x and cotangent
           g, its weight's gradient summed over the world by
           `all_reduce_grads` (rounded to bf16 with "narrow")
  sums     the sequence group's sums of this rank's row of an npz's bf16
           parts over the world: `sum_`, `reduce_` and `scatter_sum`
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

    kind, d = job["kind"], job.get("dir")
    arrays = {}
    if kind == "step":
        cfg = Config.load(d)
        mesh = mesh_from_config(cfg)
        # parameters in the config's compute type when it is f64 (the f64
        # yardstick of an f32 rounding gap), else f32
        model = RecursiveModel(cfg).to(device, torch.promote_types(
            getattr(torch, cfg.compute_dtype), torch.float32))
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
                                          pads=pads, device=device,
                                          seq=tloop.seq_block(mesh))
        labels = {k: torch.from_numpy(np.asarray(v)[rows]).to(device)
                  for k, v in job["labels"].items()}
        update, _ = tloop.make_step_fns(cfg, opt, mesh)
        loss, _ = update(model, bag, tables, labels, epoch=1,
                         denom=float(w.sum()))
        arrays = convert.to_jax_flat(model)
        if job.get("grads"):
            arrays.update({"grad/" + n: p.grad.cpu().numpy()
                           for n, p in model.named_parameters()
                           if p.grad is not None})
        result = {"loss": float(loss), "seq_index": mesh.seq_index}
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
    elif kind == "seq_attn":
        arrays, result = _seq_attn(job, device)
    elif kind == "level0":
        arrays, result = _level0(job, device)
    elif kind == "affine":
        arrays, result = _affine(job, device), {}
    elif kind == "sums":
        arrays, result = _sums(job, device), {}
    else:
        raise ValueError(kind)
    if arrays:
        np.savez(os.path.join(out, f"{job['name']}_rank{rank}.npz"), **arrays)
    return result


def _seq_attn(job: dict, device):
    """Each schedule over the whole world on this rank's blocks of q, k, v
    (B, H, N, D): the output block and the gradients of sum(out * w) (f32),
    each ring step's partial output, lse and dq, and the ring's output and
    gradients in bf16 (as f32)."""
    import torch

    from paths_tpu_torch.parallel import seq_attention as sa

    with np.load(job["inputs"]) as f:
        inp = dict(f)
    arrays = {}
    for impl in sa.IMPLS:
        sharding = sa.SeqSharding(None, impl)
        m = inp["q"].shape[2] // sharding.size
        rows = slice(sharding.index * m, (sharding.index + 1) * m)
        block = {k: torch.from_numpy(inp[k][:, :, rows].copy()).to(device)
                 for k in ("q", "k", "v", "w")}
        lengths = torch.from_numpy(inp["lengths"]).to(device)
        q, k, v = (block[n].requires_grad_() for n in "qkv")
        parts = {"o": [], "lse": [], "dq": []}
        fwd, bwd = sa.masked_flash_attention_fwd, sa.masked_flash_attention_bwd

        def fwd_kept(*args):
            o, lse = fwd(*args)
            parts["o"].append(o)
            parts["lse"].append(lse)
            return o, lse

        def bwd_kept(*args):
            dq, dk, dv = bwd(*args)
            parts["dq"].append(dq)
            return dq, dk, dv

        sa.masked_flash_attention_fwd = fwd_kept
        sa.masked_flash_attention_bwd = bwd_kept
        try:
            out = sharding.attend(q, k, v, lengths, block_k=job["block_k"])
            (out * block["w"]).sum().backward()
        finally:
            sa.masked_flash_attention_fwd = fwd
            sa.masked_flash_attention_bwd = bwd
        if impl == "ring":
            # each step's partial, the step axis after the row axis (the
            # test joins the ranks' blocks along the rows)
            arrays.update({f"ring_part_{n}": torch.stack(t, 3).cpu().numpy()
                           for n, t in parts.items()})
        arrays.update({f"{impl}_out": out.detach().cpu().numpy(),
                       f"{impl}_dq": q.grad.cpu().numpy(),
                       f"{impl}_dk": k.grad.cpu().numpy(),
                       f"{impl}_dv": v.grad.cpu().numpy()})
        if impl == "ring":
            bf = [block[n].detach().bfloat16().requires_grad_() for n in "qkv"]
            out = sharding.attend(*bf, lengths, block_k=job["block_k"])
            (out * block["w"].bfloat16()).sum().backward()
            arrays["ring_bf16_out"] = out.detach().float().cpu().numpy()
            arrays.update({f"ring_bf16_d{n}": t.grad.float().cpu().numpy()
                           for n, t in zip("qkv", bf)})
            result = {"bf16_dtype": str(out.dtype)}
    return arrays, result


def _affine(job: dict, device):
    """d(sum(affine(x, w, b) * g))/dw and /db on this rank's block of rows,
    in bf16 from f32 parameters, summed over the world."""
    import torch

    from paths_tpu_torch.nn.core import affine
    from paths_tpu_torch.parallel.mesh import ProcessMesh, all_reduce_grads

    mesh = ProcessMesh.current()
    with np.load(job["inputs"]) as f:
        inp = dict(f)
    rows = mesh.rows(inp["x"].shape[0])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    w = t(inp["w"]).requires_grad_()
    b = t(inp["b"]).requires_grad_()
    bf = torch.bfloat16
    out = affine(t(inp["x"][rows]).to(bf), w.to(bf), b.to(bf))
    out.backward(t(inp["g"][rows]).to(bf))
    all_reduce_grads(mesh, [w, b], [w, b] if job["narrow"] else (), bf)
    return {"w": w.grad.cpu().numpy(), "b": b.grad.cpu().numpy()}


def _sums(job: dict, device):
    """This rank's row of the npz's (world, n) parts in bf16, summed over
    the world as a sequence group: in place (`sum_`), into rank 0
    (`reduce_`) and this rank's block of the sum (`scatter_sum`)."""
    import torch

    from paths_tpu_torch.parallel.seq_attention import SeqSharding

    sh = SeqSharding(None)
    with np.load(job["inputs"]) as f:
        part = torch.from_numpy(f["parts"][sh.index]).to(device).bfloat16()
    arrays = {"sum": sh.sum_(part.clone()).float(),
              "scatter": sh.scatter_sum(part.clone(), 0).float()}
    reduced = sh.reduce_(part.clone()).float()
    if sh.index == 0:
        arrays["reduce"] = reduced
    return {k: v.cpu().numpy() for k, v in arrays.items()}


def _level0(job: dict, device):
    """Level 0 (and with "tables" the whole recursion's loss) of this rank's
    block under the config's mesh, for each (route, schedule) of the job."""
    import dataclasses

    import torch

    from paths_tpu_torch import convert
    from paths_tpu_torch.config import Config
    from paths_tpu_torch.engine import hierarchy as th
    from paths_tpu_torch.engine.tables import LevelTable
    from paths_tpu_torch.models.batch import PatchBag, shard_bag_patches
    from paths_tpu_torch.models.recursive import recursive_apply
    from paths_tpu_torch.parallel.mesh import mesh_from_config
    from paths_tpu_torch.parallel.seq_attention import SeqSharding

    cfg = Config.load(job["dir"], test_mode=True)
    mesh = mesh_from_config(cfg)
    with np.load(job["params"]) as f:
        model = convert.from_jax_flat(dict(f), cfg).to(device)
    with np.load(job["inputs"]) as f:
        inp = dict(f)
    rows = mesh.rows(inp["fts"].shape[0])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)  # noqa: E731
    dt = getattr(torch, cfg.table_dtype)
    whole = PatchBag(fts=t(inp["fts"]).to(dt), locs=t(inp["locs"]).long(),
                     mask=t(inp["mask"]), parent_inds=t(inp["parent"]).long(),
                     ctx_slide=t(inp["ctx_slide"]).to(dt),
                     ctx_patch=t(inp["ctx_patch"]).to(dt))
    bag = shard_bag_patches(whole, mesh.seq_index, mesh.seq)
    arrays, result = {}, {}
    for impl_attn, impl_seq in job["routes"]:
        c = dataclasses.replace(cfg, attention_impl=impl_attn,
                                seq_attention=impl_seq)
        seq = SeqSharding.from_mesh(mesh, impl_seq)
        name = f"{impl_attn}_{impl_seq}"
        with torch.no_grad():
            out = th.gather_level0(
                bag, recursive_apply(model, c, 0, bag, seq_mesh=seq), seq)
        arrays[f"{name}_logits"] = out["logits"].float().cpu().numpy()
        arrays[f"{name}_importance"] = out["importance"].float().cpu().numpy()
        if job.get("tables"):
            tables = [LevelTable(**{k[len(f"t{i}_"):]: t(v) for k, v in
                                    inp.items() if k.startswith(f"t{i}_")})
                      for i in range(cfg.num_levels - 1)]
            tables = [dataclasses.replace(tb, fts=tb.fts.to(dt))
                      for tb in tables]
            labels = {k: t(inp[f"label_{k}"]) for k in ("survival_bin",
                                                        "censored")}
            labels["weight"] = torch.ones(len(labels["censored"]))
            with torch.no_grad():
                loss, _ = th.end2end_loss(model, c, bag, tables, labels,
                                          denom=float(inp["fts"].shape[0]),
                                          seq_mesh=seq)
            result[f"{name}_loss"] = float(loss)
    result["seq_index"] = mesh.seq_index
    return arrays, result


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
