"""The benchmark's command: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (`correct`, `attempted`, `failed`, `metrics`, `device`, with
`--trace 1` also `breakdown`, and last `checks`: every number compared with
its limit); the last lines of standard error repeat the checks. Without a
CUDA card, or with fewer than the cell asks for, it prints no result and
exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_env()
    bench, cell, config, traffic = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the port on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if args.seed < 0:
        print("--seed takes a whole number >= 0", file=sys.stderr)
        return 2
    result = harness.execute(
        args.workload, config, traffic, args.seed, args.seconds,
        bool(args.trace), harness.metrics_of(bench, args.workload, "end_to_end"),
        harness.metrics_of(bench, args.workload, "per_layer"),
        chips=cell["chips"], t_start=T_START)
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
