"""Export a trained model as a serving artifact (counterpart of
`paths_tpu.cli.export`):

    python -m paths_tpu_torch.cli.export -m models/DIR -o model.pt2z \
        [--batch-size N] [--freeze] [--poly-batch] [--platforms cuda cpu]

The artifact holds one `torch.export` program per platform
(`paths_tpu_torch.export`); `ServingSession(artifact=...)`,
`cli.predict --artifact` and `cli.serve --artifact` run it. The weights come
from the model directory (`orbax/`, `model.npz` or the reference's
`model.pt`). Input shapes are fixed at export time from the dataset's global
pads, over all splits, and the first training batch in `cli.train`'s order:
the single-shape contract of the trainer (`config.static_shapes`).
`--platforms` defaults to `cuda`; a `cuda` program needs a card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> bytes:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model-dir", required=True)
    parser.add_argument("-o", "--out", required=True,
                        help="output artifact path")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="serving batch size (default: train batch)")
    parser.add_argument("--freeze", action="store_true",
                        help="bake weights into the artifact (self-"
                             "contained, call(bag, tables))")
    parser.add_argument("--poly-batch", action="store_true",
                        help="export the batch axis as a symbolic "
                             "dimension (one artifact, any batch size)")
    parser.add_argument("--platforms", nargs="+", default=["cuda"],
                        help="programs to trace, e.g. --platforms cuda cpu "
                             "(default: cuda)")
    args = parser.parse_args(argv)

    from paths_tpu_torch.config import Config
    from paths_tpu_torch.data.dataset import load_splits, union_pads
    from paths_tpu_torch.export import export_serving
    from paths_tpu_torch.models.recursive import RecursiveModel
    from paths_tpu_torch.train.loop import _epoch_batches, set_matmul_precision
    from paths_tpu_torch.train.state import load_state

    config = Config.load(args.model_dir)
    set_matmul_precision(config.compute_dtype)
    np.random.seed(config.seed)
    train, val, test = load_splits([0.7, 0.15, 0.15], config.seed, config)
    pads = union_pads(*(d.global_pads() for d in (train, val, test)
                        if d is not None))

    model, _, stats = load_state(args.model_dir, RecursiveModel(config),
                                 checkpoint_backend=config.checkpoint_backend)
    print(f"Exporting checkpoint from epoch {stats.get('epoch')}",
          file=sys.stderr)

    bs = args.batch_size or config.batch_size[0]
    batches = _epoch_batches(train, bs, shuffle=False, seed=0,
                             config=config, pads=pads, device="cpu")
    bag0, tables, _, _ = next(batches)
    batches.close()

    blob = export_serving(config, model, bag0, tables,
                          freeze_params=args.freeze,
                          poly_batch=args.poly_batch,
                          platforms=args.platforms)
    with open(args.out, "wb") as f:
        f.write(blob)
    kind = "frozen (weights baked in)" if args.freeze else "weights-as-args"
    batch = "symbolic" if args.poly_batch else str(bs)
    print(f"Wrote {args.out}: {len(blob) / 1e6:.2f} MB, {kind}, "
          f"batch={batch}, level0={bag0.fts.shape[1]} patches, platforms "
          f"{' '.join(args.platforms)}", file=sys.stderr)
    return blob


if __name__ == "__main__":
    main()
