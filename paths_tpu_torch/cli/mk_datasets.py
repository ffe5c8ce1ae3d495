"""Clone an experiment config across the five TCGA datasets.

Counterpart of `paths_tpu.cli.mk_datasets` (the reference's
`scripts/mk_datasets.py`), stdlib only: given a source
experiment dir whose config points at one dataset (e.g. brca), create
sibling dirs for the other datasets with `wsi_dir` / `csv_path` /
`preprocess_dir` rewritten by substring substitution, mirroring the
reference's path-rewrite-by-dataset-name behavior
(`scripts/mk_datasets.py:45-61`).

    python -m paths_tpu_torch.cli.mk_datasets -s models/brca_paths_0 \
        [--datasets brca coadread kirc kirp luad] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
from copy import deepcopy

DEFAULT_DATASETS = ["brca", "coadread", "kirc", "kirp", "luad"]
PATH_KEYS = ["wsi_dir", "csv_path", "preprocess_dir"]


def detect_source_dataset(config: dict, datasets) -> str:
    for ds in datasets:
        if ds in str(config.get("wsi_dir", "")):
            return ds
    raise ValueError(
        f"Couldn't detect source dataset from wsi_dir={config.get('wsi_dir')!r}; "
        f"expected one of {datasets} to appear in the path")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--source", required=True, type=str,
                        help="Source experiment dir (contains config.json)")
    parser.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args(argv)

    src_path = os.path.join(args.source, "config.json")
    assert os.path.isfile(src_path), f"config.json not found in {args.source}"
    with open(src_path) as f:
        base = json.load(f)

    src_ds = detect_source_dataset(base, args.datasets)
    src_name = os.path.basename(args.source.rstrip("/"))
    assert src_ds in src_name, (
        f"Source dir name '{src_name}' should contain '{src_ds}' so sibling "
        f"names can be derived")
    root = os.path.dirname(args.source.rstrip("/")) or "."

    for ds in args.datasets:
        if ds == src_ds:
            continue
        cfg = deepcopy(base)
        for key in PATH_KEYS:
            if key in cfg and cfg[key]:
                cfg[key] = cfg[key].replace(src_ds, ds)
        tdir = os.path.join(root, src_name.replace(src_ds, ds))
        tpath = os.path.join(tdir, "config.json")
        if os.path.isfile(tpath) and not args.force:
            with open(tpath) as f:
                if json.load(f) == cfg:
                    print(f"{tdir}: up to date")
                    continue
            print(f"{tdir}: exists and differs; use --force to overwrite")
            continue
        os.makedirs(tdir, exist_ok=True)
        with open(tpath, "w") as f:
            json.dump(cfg, f, indent=2)
        print(f"Wrote {tpath}")


if __name__ == "__main__":
    main()
