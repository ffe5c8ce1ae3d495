"""Clone a fold-0 experiment config across N cross-validation folds.

Counterpart of `paths_tpu.cli.mk_folds` (the reference's
`scripts/mk_folds.py`), stdlib only: given `models/NAME_0`
with a config.json, create `models/NAME_1..NAME_{folds-1}` whose configs
differ only in `seed` (= fold index). Existing directories are left alone
unless their config differs, in which case a diff is printed and `--force`
overwrites.

    python -m paths_tpu_torch.cli.mk_folds -n NAME [-f 5] [--root models] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
from copy import deepcopy


def config_diff(a: dict, b: dict) -> list:
    keys = sorted(set(a) | set(b))
    return [f"  {k}: {a.get(k)!r} -> {b.get(k)!r}"
            for k in keys if a.get(k) != b.get(k)]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", "--name", required=True, type=str)
    parser.add_argument("-f", "--folds", type=int, default=5)
    parser.add_argument("--root", type=str, default="models")
    parser.add_argument("--force", action="store_true",
                        help="Overwrite differing configs without prompting")
    args = parser.parse_args(argv)

    src_dir = os.path.join(args.root, f"{args.name}_0")
    src_path = os.path.join(src_dir, "config.json")
    assert os.path.isfile(src_path), f"Fold-0 config not found: {src_path}"
    with open(src_path) as f:
        base = json.load(f)

    for i in range(args.folds):
        target = deepcopy(base)
        target["seed"] = i
        tdir = os.path.join(args.root, f"{args.name}_{i}")
        tpath = os.path.join(tdir, "config.json")

        if os.path.isfile(tpath):
            with open(tpath) as f:
                existing = json.load(f)
            diff = config_diff(existing, target)
            if not diff:
                print(f"{tdir}: up to date")
                continue
            print(f"{tdir}: differs:")
            print("\n".join(diff))
            if not args.force:
                resp = input(f"Overwrite {tpath}? [y/N] ").strip().lower()
                if resp != "y":
                    continue
        os.makedirs(tdir, exist_ok=True)
        with open(tpath, "w") as f:
            json.dump(target, f, indent=2)
        print(f"Wrote {tpath} (seed={i})")


if __name__ == "__main__":
    main()
