"""The readings that a cell's correctness limits are set from: for each
seed, the numbers the check compares for the program, and for the control
(the program or the reference one precision below the configuration's:
the port's int8 route for a bf16 encoder, the reference in TF32 for an f32
model).

    python3 -m benchmark.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> ...] [--fault <name>]

One JSON line per seed. Set-up, a short window at the cell's own load and
the check run as in a benchmark run; the benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import shutil
import sys
import tempfile
import time

from benchmark import faults, harness


def readings(cell: str, config: dict, traffic: dict, seed: int,
             seconds: float, control: bool, device: str = "cuda",
             fault: str = "") -> dict:
    import importlib

    import torch

    tmp = tempfile.mkdtemp(prefix="bench-control-")
    run = harness.Run(cell=cell, config=config, traffic=traffic, seed=seed,
                      seconds=seconds, device=device, tmp=tmp)
    drv = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}").Driver(run)
    try:
        t0 = time.perf_counter()
        with (faults.planted(traffic["driver"], fault) if fault
              else contextlib.nullcontext()):
            drv.setup()
            win = drv.window(seconds)
            drv.release()
        checks = drv.check()
        out = {"seed": seed, "fault": fault, "attempted": win["attempted"],
               "program": {k: v for k, (v, _) in checks.items()},
               "limits": {k: lim for k, (_, lim) in checks.items()}}
        if control:
            out["control"] = drv.control()
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        drv.close()
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--fault", default="",
                    help="plant this fault (benchmark/faults.py) under the program")
    args = ap.parse_args(argv)
    harness.cache_env()
    _, cell, config, traffic = harness.load_cell(args.workload)
    for seed in args.seeds:
        r = readings(args.workload, config, traffic, seed, args.seconds,
                     seed in set(args.control_seeds), fault=args.fault)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
