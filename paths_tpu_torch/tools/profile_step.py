"""Kernel-level device-time profile of the port's flagship train step (or
its single-slide inference step); counterpart of `tools/profile_step.py`.

    python -m paths_tpu_torch.tools.profile_step                # train step
    python -m paths_tpu_torch.tools.profile_step --what eval    # inference
    python -m paths_tpu_torch.tools.profile_step --steps 20 --top 40 \
        --json out.json

It builds the JAX repository's benchmark workload (`brca_paths_0` as
published, dropout 0.05, batch 32, a `make_synthetic_store` of 32 slides of
base grid (8, 10) and tissue 0.55, `level0_bucket` from the config) with
`attention_impl` "pallas", warms 3 steps, and records `--steps` steps under
`paths_tpu_torch.profiling.trace` (torch.profiler), after timing as many
untraced (the profiler adds host time to every operation). From the
`*.pt.trace.json` it keeps the device's events only (`cat` kernel,
gpu_memcpy, gpu_memset), groups kernel names into families (template
arguments, argument lists and instance suffixes stripped, the functor or
kernel instance a generic kernel runs kept as a tag), and prints wall
ms a step between CUDA events, device-busy ms a step and its share of the
wall, and the top families. At dropout 0.05 the train step takes the plain
attention route (as in the JAX package); the eval step runs kernel #1.

Device time is the sum of the device events' durations: kernels that
overlap on two streams count twice. The tool needs a card: the CPU has no
device events, and `--device cpu` raises. The store is written into a new
temp dir, removed at the end, unless `--workdir` names one; a named work
dir's store is reused only where it was made with the same workload.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import tempfile

import torch

from paths_tpu_torch.examples import (
    FLAGSHIP_DIR,
    card_name,
    require_device,
    stamp_store,
    store_made_with,
    work_dir,
)

B = 32
WARMUP = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_SUFFIX = re.compile(r"[._-]?\d+$")


def _strip_templates(name: str) -> str:
    """Drop every balanced `<...>`; a `>` outside one (as in `->`) stays."""
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def _strip_call(name: str) -> str:
    """Drop a trailing balanced `(...)`: a kernel's argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if not depth:
                return name[:i]
    return name


# what names a generic kernel's work inside its template arguments: a
# functor or kernel body (`CUDAFunctor_add`, `where_kernel_impl`,
# `sum_functor`), never the dispatch wrapper around it
_TAG = re.compile(r"[A-Za-z_]\w*(?:Functor|functor|_kernel)\w*")
_WRAPPERS = ("gpu_kernel",)


def _template_args(name: str) -> str:
    """The text inside the outermost `<...>` of a kernel name, or ''."""
    start = name.find("<")
    if start < 0:
        return ""
    depth = 0
    for i in range(start, len(name)):
        if name[i] == "<":
            depth += 1
        elif name[i] == ">":
            depth -= 1
            if not depth:
                return name[start + 1:i]
    return ""


def _op_family(name: str) -> str:
    """A kernel's family: its name without template arguments, argument
    list and instance suffix, tagged with what its template arguments say
    it computes where they name it: the first functor or kernel body
    (`at::native::vectorized_elementwise_kernel<CUDAFunctor_add>`), else a
    first argument that is a kernel instance
    (`cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nt_align1>`).
    `Memcpy HtoD (Pageable -> Device)` -> `Memcpy HtoD`;
    `gemm_kernel_7` -> `gemm_kernel`."""
    if name.startswith("void "):
        name = name[len("void "):]
    base = _SUFFIX.sub("", _strip_call(_strip_templates(name)).strip())
    args = _template_args(name)
    tags = [t for t in _TAG.findall(args) if not t.startswith(_WRAPPERS)]
    first = _strip_templates(args.split(",")[0]).strip()
    if tags:
        return f"{base}<{tags[0]}>"
    if "_" in first and not first[0].isdigit():
        return f"{base}<{first.split('::')[-1]}>"
    return base or name


def load_trace(logdir: str) -> dict:
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    with open(sorted(paths)[-1]) as f:
        return json.load(f)


def device_op_table(trace: dict) -> tuple[dict, dict, float]:
    """Sum the device events' durations (us) by exact name and by family.

    A torch.profiler trace holds host events (`cat` cpu_op, cuda_runtime,
    python_function, user_annotation, ...) beside the device's (kernel,
    gpu_memcpy, gpu_memset); annotations mirrored onto the device's
    timeline (gpu_user_annotation) enclose kernels and would count them
    twice. Only the device's own events are kept. A trace without any
    raises: it was not taken on a card.
    Returns (by_op_us, by_family_us, total_us)."""
    by_op: dict = collections.defaultdict(float)
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_op[e.get("name", "")] += float(e.get("dur", 0.0))
    if not by_op:
        raise ValueError("the trace holds no device event (cat kernel, "
                         "gpu_memcpy or gpu_memset): it was not taken on a "
                         "card, and host time is no device time")
    by_family: dict = collections.defaultdict(float)
    for name, us in by_op.items():
        by_family[_op_family(name)] += us
    return dict(by_op), dict(by_family), sum(by_op.values())


def flagship_config(workdir: str):
    """`models/brca_paths_0` as published, pointed at the benchmark's
    synthetic store, with the flash kernel route."""
    from paths_tpu_torch.config import Config

    cfg = Config.load(FLAGSHIP_DIR, test_mode=True)
    cfg.csv_path = os.path.join(workdir, "meta.csv.zip")
    cfg.preprocess_dir = os.path.join(workdir, "store")
    cfg.wsi_dir = os.path.join(workdir, "brca")
    cfg.hipt_splits = False        # synthetic slides use a random split
    cfg.batch_size = [B]
    cfg.attention_impl = "pallas"
    return cfg


def build_workload(what: str, device, cfg, batch: int = B,
                   base_hw=(8, 10), seed: int = 0):
    """`step() -> loss`: one train step (`what` "train": AdamW over `batch`
    slides, dropout from the config) or one single-slide evaluation
    ("eval"). The store is written where `cfg` points unless one made with
    this workload is there; one made otherwise raises."""
    from paths_tpu_torch.data.dataset import collate_batch, labels_on, load_splits
    from paths_tpu_torch.data.synthetic import (
        make_synthetic_metadata,
        make_synthetic_store,
    )
    from paths_tpu_torch.models.jax_init import fresh_model
    from paths_tpu_torch.train.loop import (
        make_optimizer,
        make_step_fns,
        set_matmul_precision,
    )

    if what not in ("train", "eval"):
        raise ValueError(f"unknown --what {what!r} (train|eval)")
    device = torch.device(device)
    made_with = dict(slides=batch, seed=seed, base_hw=list(base_hw),
                     tissue_fraction=0.55, width=cfg.model_config
                     .patch_embed_dim, levels=cfg.num_levels)
    if not store_made_with(cfg.preprocess_dir, **made_with):
        ids = make_synthetic_store(cfg.preprocess_dir, cfg, num_slides=batch,
                                   base_hw=base_hw, seed=seed,
                                   tissue_fraction=0.55)
        make_synthetic_metadata(cfg.csv_path, ids, seed=seed)
        stamp_store(cfg.preprocess_dir, **made_with)
    set_matmul_precision(cfg.compute_dtype)
    ds = load_splits([1.0, 0.0, 0.0], seed=0, config=cfg)[0]
    idx = list(range(min(batch, len(ds)))) if what == "train" else [0]
    bag, tables = collate_batch(ds, idx, level0_bucket=cfg.level0_bucket,
                                device=device)
    labels = labels_on(ds, idx, device)
    model = fresh_model(cfg, cfg.seed).to(device)
    update, evaluate = make_step_fns(cfg,
                                     make_optimizer(cfg, model.parameters()))
    if what == "train":
        gen = torch.Generator(device=device).manual_seed(cfg.seed)

        return lambda: update(model, bag, tables, labels, gen, epoch=1)[0]
    model.eval()
    return lambda: evaluate(model, bag, tables, labels)[0]


def cuda_ms(step, steps: int, device) -> float:
    """Mean ms a step between CUDA events over `steps` steps in a row."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / steps


def profile(step, steps: int, device, logdir: str):
    """Warm `WARMUP` steps, time `steps` steps, then trace `steps` more:
    (wall ms a step between CUDA events untraced, the same traced,
    by_op_us, by_family_us, total_us)."""
    from paths_tpu_torch.profiling import trace

    for _ in range(WARMUP):
        loss = step()
    float(loss)
    wall_ms = cuda_ms(step, steps, device)
    with trace(logdir):
        traced_ms = cuda_ms(step, steps, device)
    return (wall_ms, traced_ms, *device_op_table(load_trace(logdir)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="train", choices=["train", "eval"])
    ap.add_argument("--steps", type=int, default=10,
                    help="steps inside the trace window")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None,
                    help="also write the full table as JSON")
    ap.add_argument("--logdir", default=None,
                    help="keep the raw trace here (default: a temp dir)")
    ap.add_argument("--workdir", default=None,
                    help="where the benchmark store is written, and reused "
                         "from (default: a new temp dir, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default: cuda); the CPU has no device "
                         "events and raises")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if device.type != "cuda":
        raise ValueError(f"--device {device}: profile_step times the card's "
                         "kernels, and the CPU has none")

    wd, made = work_dir(args.workdir, "paths_tpu_torch_bench")
    logdir = args.logdir or tempfile.mkdtemp(prefix="paths_tpu_torch_prof_")
    try:
        os.makedirs(wd, exist_ok=True)
        cfg = flagship_config(wd)
        step = build_workload(args.what, device, cfg)
        wall_ms, traced_ms, by_op, by_family, total_us = profile(
            step, args.steps, device, logdir)
    finally:
        if not args.logdir:
            shutil.rmtree(logdir, ignore_errors=True)
        if made:
            shutil.rmtree(wd, ignore_errors=True)
    busy_ms = total_us / args.steps / 1e3

    gpu = card_name(device)
    print(f"# {args.what} step profile - {args.steps} steps on {gpu} "
          f"(dropout {cfg.model_config.dropout}, attention_impl "
          f"{cfg.attention_impl}, batch {B if args.what == 'train' else 1})")
    print(f"wall {wall_ms:.2f} ms/step between CUDA events ({traced_ms:.2f} "
          f"under the profiler), device-busy {busy_ms:.2f} ms/step "
          f"({busy_ms / wall_ms * 100:.1f}% of the untraced wall)")
    print(f"\n{'us/step':>10}  {'% dev':>6}  kernel family")
    fam = sorted(by_family.items(), key=lambda kv: -kv[1])
    for name, us in fam[:args.top]:
        print(f"{us / args.steps:>10.1f}  {us / total_us * 100:>6.1f}  {name}")
    rest = sum(us for _, us in fam[args.top:])
    if rest:
        print(f"{rest / args.steps:>10.1f}  {rest / total_us * 100:>6.1f}  "
              f"(+{len(fam) - args.top} more)")
    out = {"what": args.what, "steps": args.steps,
           "wall_ms_per_step": wall_ms, "traced_wall_ms_per_step":
           traced_ms, "device_us_per_step":
           total_us / args.steps, "by_family_us": by_family,
           "by_op_us": by_op, "device": gpu,
           "dropout": cfg.model_config.dropout,
           "attention_impl": cfg.attention_impl}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
        print(f"\nfull table -> {args.json}")
    if args.logdir:
        print(f"raw trace -> {args.logdir}")
    return out


if __name__ == "__main__":
    main()
