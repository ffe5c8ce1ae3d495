"""Offline preprocessing entry point (counterpart of
`paths_tpu.cli.preprocess`, same flags plus `--device`):

    python -m paths_tpu_torch.cli.preprocess -m UNI -d /path/to/slide_dir \
        -o /path/to/out -b 64 --weights uni_state_dict.pt

`--weights` points at a torch state_dict of the timm encoder or the
torchvision resnet (there are no hub downloads; without it a ViT is randomly
initialised from seed 0, and `-m resnet50` / `resnet18` refuse to run);
`--ext` selects the slide extension (`.svs` via OpenSlide, `.npy` array
pyramids, `.tiles` JPEG-tiled pyramids); `-w N` (N >= 2) decodes in N spawn
processes. The run is on the card unless `--device cpu` asks otherwise.
`--data-shards N` shards every batch over the host's first N cards (or N
shards on one named `--device`, such as `cuda:0` or `cpu`): the encoder is
built once and its weights copied to each.
"""
from __future__ import annotations

import argparse
import os

from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.preprocess.pipeline import process_slides


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", type=str, default="UNI",
                        help="Patch processing model")
    parser.add_argument("--weights", type=str, default=None,
                        help="Path to a torch state_dict for the encoder")
    parser.add_argument("-d", "--dir", type=str, required=True,
                        help="Path to input data folder")
    parser.add_argument("-o", "--out", type=str, required=True,
                        help="Path to output data folder")
    parser.add_argument("-b", "--batch", type=int, default=64)
    parser.add_argument("-p", "--patch", type=int, default=256)
    parser.add_argument("-t", "--threads", type=int, default=8, dest="threads",
                        help="Patch-read threads of the decode producer")
    parser.add_argument("-w", "--workers", type=int, default=0,
                        dest="decode_workers",
                        help="Decode processes; 0 = single producer thread, "
                             "2 or more = that many spawn processes decoding "
                             "slide shards into one queue (the encode stays "
                             "in this process)")
    parser.add_argument("-ms", "--magnifications", type=float, nargs="+",
                        default=[0.625, 1.25, 2.5, 5.0, 10.0])
    parser.add_argument("-ds", "--downscale", type=int, default=4,
                        help="Downscale factor for the background mask")
    parser.add_argument("-lm", "--load_mode", type=int, default=0,
                        choices=(0, 1),
                        help="0: read each patch rect from the slide; "
                             "1: read the whole level image once and slice "
                             "patches from RAM")
    parser.add_argument("--tissue-threshold", type=float, default=0.1)
    parser.add_argument("--default-power", type=float, default=40.0,
                        help="Objective power assumed when the slide does "
                             "not declare one")
    parser.add_argument("--ext", type=str, default=".svs")
    parser.add_argument("--store-dtype", type=str, default="float32",
                        choices=("float32", "float16"),
                        help="On-disk feature-grid dtype; float16 halves the "
                             "store (the encoder computes in bf16)")
    parser.add_argument("--store-format", type=str, default="npy",
                        choices=("npy", "pt"),
                        help="npy (memory-mappable) or pt (reference-format "
                             "torch tensors)")
    parser.add_argument("--fast-math", action="store_true",
                        help="tanh-GELU encoder variant")
    parser.add_argument("--block-impl", type=str, default="auto",
                        choices=("auto", "fused", "fused1", "flash", "xla",
                                 "int8"),
                        help="encoder blocks: auto = the fused CUDA block "
                             "kernels on a card, plain torch on the CPU; "
                             "fused1 = the whole block in one launch; int8 = "
                             "int8 projections (weights quantised at start)")
    parser.add_argument("--data-shards", type=int, default=0,
                        help="Shard encode batches over this many devices "
                             "(0 = single device); with a named --device, "
                             "that many shards on it")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Where the encoder runs (cuda, or cpu on request)")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    from paths_tpu_torch.encoders.registry import from_name
    from paths_tpu_torch.parallel.mesh import device_mesh

    mesh = (device_mesh(args.data_shards, args.device)
            if args.data_shards else None)
    encode, dim, _ = from_name(args.model, weights_path=args.weights,
                               fast_math=args.fast_math,
                               block_impl=args.block_impl, device=args.device,
                               mesh=mesh)

    store = FeatureStore(args.out, create=True,
                         save_format=args.store_format)
    slide_files = sorted(f for f in os.listdir(args.dir)
                         if f.endswith(args.ext))
    print(f"Preprocessing {len(slide_files)} slides "
          f"({args.model}, dim {dim}, powers {args.magnifications})")

    items = [(os.path.join(args.dir, fname),
              ".".join(fname.split(".")[:-1])) for fname in slide_files]
    # pipelined across slides: the producer thread decodes and stages slide
    # k+1's patches while the card encodes slide k
    stats: dict = {}
    process_slides(
        items, encode, dim, args.magnifications, store,
        patch_size=args.patch, tissue_threshold=args.tissue_threshold,
        downscale=args.downscale, batch_size=args.batch,
        threads=args.threads, default_power=args.default_power,
        decode_workers=args.decode_workers, load_mode=args.load_mode,
        store_dtype=args.store_dtype, stats=stats, device=args.device,
        mesh=mesh, verbose=args.verbose)
    return stats


if __name__ == "__main__":
    main()
