"""Heatmap entry point (counterpart of `paths_tpu.cli.heatmap`):

    python -m paths_tpu_torch.cli.heatmap -m models/DIR -s slide.svs \
        [-a annotations.xml] -o out/heatmap.pdf [--weights uni.pt] \
        [--block-impl fused] [--device cuda]
    python -m paths_tpu_torch.cli.heatmap -m models/DIR --slide-id ID \
        -o out/heatmap.pdf

With `--slide-path`, the raw slide's patches are encoded on the fly at every
depth (`--encoder`, `--weights`, `--block-impl` as in `cli.preprocess`);
with `--slide-id`, the heatmap comes from the preprocessed grids of the
config's feature store. The model directory's `model.npz` or reference
`model.pt` is loaded. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model-dir", required=True, type=str)
    parser.add_argument("-s", "--slide-path", default=None, type=str)
    parser.add_argument("--slide-id", default=None, type=str,
                        help="render from PREPROCESSED grids in the "
                             "config's feature store (no raw WSI or "
                             "encoder needed) instead of --slide-path")
    parser.add_argument("-a", "--annotation-path", default=None, type=str,
                        help="CAMELYON17 annotation XML (optional)")
    parser.add_argument("-o", "--out", default=None, type=str,
                        help="Output PDF path")
    parser.add_argument("--encoder", type=str, default="UNI")
    parser.add_argument("--weights", type=str, default=None,
                        help="torch state_dict for the patch encoder")
    parser.add_argument("--block-impl", type=str, default="auto",
                        choices=("auto", "fused", "fused1", "flash", "xla",
                                 "int8"),
                        help="encoder block kernels (see cli.preprocess)")
    parser.add_argument("--tissue-threshold", type=float, default=0.025)
    parser.add_argument("--default-power", type=float, default=40.0)
    parser.add_argument("--no-camelyon", action="store_true",
                        help="Disable the CAMELYON black-background remap")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import set_matmul_precision
    from paths_tpu_torch.train.state import load_state

    config = Config.load(args.model_dir, test_mode=True)
    np.random.seed(config.seed)
    if (args.slide_path is None) == (args.slide_id is None):
        parser.error("exactly one of --slide-path / --slide-id required")
    set_matmul_precision(config.compute_dtype)
    device = torch.device(args.device)

    model, _, stats = load_state(args.model_dir, RecursiveModel(config),
                                 checkpoint_backend=config.checkpoint_backend)
    model = model.to(device).eval()
    print("Loaded from epoch", stats.get("epoch"))

    if args.slide_id is not None:
        from paths_tpu_torch.data.feature_store import FeatureStore
        from paths_tpu_torch.viz.heatmap import heatmap_from_store

        out = heatmap_from_store(config, model, args.slide_id,
                                 FeatureStore(config.preprocess_dir),
                                 args.out, device=device)
    else:
        from paths_tpu_torch.encoders.registry import from_name
        from paths_tpu_torch.viz.heatmap import heatmap_slide

        encode, _, _ = from_name(args.encoder, weights_path=args.weights,
                                 block_impl=args.block_impl,
                                 device=args.device)
        out = heatmap_slide(config, model, encode, args.slide_path,
                            args.annotation_path, args.out,
                            tissue_threshold=args.tissue_threshold,
                            camelyon=not args.no_camelyon,
                            default_power=args.default_power, device=device)
    if out:
        print("Wrote", out)
    return out


if __name__ == "__main__":
    main()
