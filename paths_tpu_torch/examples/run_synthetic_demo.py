"""End-to-end demo of the port on synthetic slides: every public entry point
in the order a user runs them (counterpart of
`examples/run_synthetic_demo.py`).

    python -m paths_tpu_torch.examples.run_synthetic_demo [--workdir DIR] \
        [--encoder NAME] [--device cuda]

1. fabricate raw WSIs (uint8 `.npy` images) and a TCGA-style metadata CSV
2. `cli.verify_conversion`: certify the encoder weights file (here a
   timm-keyed random checkpoint from `encoders/torch_mirror.py`, standing in
   for a downloaded one)
3. `cli.preprocess`: tissue masking and patch encoding into grids (on the
   card the fused ViT block kernels #4 and #5)
4. `cli.train`: hierarchical training with val evaluations (dropout 0 and
   `attention_impl` "pallas": on the card the flash kernels #1-#3)
5. `cli.evaluate`: test-split metrics
6. `cli.predict`: per-slide risk CSV
7. `cli.heatmap`: importance heatmap of one raw slide, encoded on the fly
8. `cli.export`: the serving artifact, reloaded by `export.load_serving`
9. `cli.serve.make_server`: the artifact served over HTTP

Runs on the card unless `--device cpu` is given. Without `--workdir` it
works in a new temp dir, which it keeps and names at the end. On a host
without matplotlib, stage 7 runs the recursion and draws no figure. The
encoder is randomly
initialised (no download); with real weights (`--weights uni.pt --encoder
UNI`) the same flow is the PATHS paper's setup.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from paths_tpu_torch.examples import require_device, work_dir


def make_raw_slides(slide_dir: str, n: int, seed: int = 0, size: int = 1024):
    """White-background slides with 1-3 dark tissue blobs each."""
    rng = np.random.default_rng(seed)
    ids = []
    os.makedirs(slide_dir, exist_ok=True)
    for i in range(n):
        img = np.full((size, size, 3), 243, np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.uniform(0.2, 0.8, 2) * size
            r = rng.uniform(0.1, 0.25) * size
            yy, xx = np.mgrid[0:size, 0:size]
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
            tissue = rng.integers(60, 170, (size, size, 3)).astype(np.uint8)
            img[blob] = tissue[blob]
        sid = f"DEMO-{i:04d}"
        np.save(os.path.join(slide_dir, f"{sid}.npy"), img)
        ids.append(sid)
    return ids


def make_metadata(csv_path: str, ids, seed: int = 0):
    rng = np.random.default_rng(seed)
    with open(csv_path, "w") as f:
        f.write("case_id,slide_id,survival_months,censorship,oncotree_code\n")
        for i, sid in enumerate(ids):
            f.write(f"CASE-{i:04d},{sid}.svs,"
                    f"{rng.uniform(2, 100):.1f},{rng.integers(0, 2)},IDC\n")


def demo_config(dim: int, epochs: int, wd: str, store_dir: str):
    """The demo's tiny model over the encoder's width: the JAX demo's, but
    for one attention head of 32 where JAX's has two of 16, since the flash
    kernels take a head dim of 32 or 64."""
    from paths_tpu_torch.config import Config, PATHSProcessorConfig

    return Config(
        model_config=PATHSProcessorConfig(
            patch_embed_dim=dim, trans_dim=32, trans_heads=1, trans_layers=1,
            importance_mlp_hidden_dim=16, hierarchical_ctx_mlp_hidden_dim=16,
            pos_encoding_mode="2d", patch_size=64, dropout=0.0),
        num_levels=5, top_k_patches=4, nbins=2, task="survival",
        num_epochs=epochs, lr=1e-3, batch_size=4, level0_bucket=8,
        attention_impl="pallas",
        csv_path=os.path.join(wd, "meta.csv"), preprocess_dir=store_dir,
        wsi_dir=os.path.join(wd, "brca"))


def heatmap_stage(model_dir: str, slide: str, pdf: str, encoder: str,
                  weights: str, device):
    """`cli.heatmap` on one raw slide, encoded on the fly. Returns the PDF's
    path, or None where no figure was drawn (no matplotlib)."""
    from paths_tpu_torch.cli.heatmap import main as heatmap

    return heatmap(["-m", model_dir, "-s", slide, "-o", pdf, "--encoder",
                    encoder, "--no-camelyon", "--tissue-threshold", "0.05",
                    "--default-power", "10", "--weights", weights,
                    "--device", str(device)])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="emptied and used (default: a new temp dir)")
    ap.add_argument("--encoder", default="kaiko-vits16")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--slides", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--store-dtype", default="float32",
                    choices=("float32", "float16"),
                    help="feature-store dtype (float16 halves the store)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    dev = ["--device", str(device)]

    wd, made = work_dir(args.workdir, "paths_tpu_torch_demo")
    if not made:
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
    slide_dir = os.path.join(wd, "slides")
    store_dir = os.path.join(wd, "preprocessed")
    model_dir = os.path.join(wd, "model")

    print("== 1/9 fabricate raw slides", flush=True)
    ids = make_raw_slides(slide_dir, args.slides)

    print("== 2/9 verify encoder weights (drop-in certification)", flush=True)
    weights = args.weights
    if weights is None:
        # stand-in for a real downloaded checkpoint: a timm-keyed random
        # state_dict of the chosen architecture, saved with torch
        import torch

        from paths_tpu_torch.encoders.registry import _VIT_SPECS
        from paths_tpu_torch.encoders.torch_mirror import timm_vit_mirror

        torch.manual_seed(0)
        spec, _ = _VIT_SPECS[args.encoder.lower()]
        weights = os.path.join(wd, "encoder_sd.pt")
        torch.save(timm_vit_mirror(spec).state_dict(), weights)
    from paths_tpu_torch.cli.verify_conversion import main as verify

    verify(["--model", args.encoder, "--weights", weights, "--images", "1",
            *dev])

    print("== 3/9 preprocess (tissue mask + patch encode)", flush=True)
    from paths_tpu_torch.cli.preprocess import main as preprocess

    # base objective power 10 so the demo pyramid spans 0.625x..10x
    preprocess(["-m", args.encoder, "-d", slide_dir, "-o", store_dir,
                "-b", "16", "-p", "64", "-ms", "0.625", "1.25", "2.5", "5",
                "10", "--ext", ".npy", "--default-power", "10",
                "--weights", weights, "--store-dtype", args.store_dtype, *dev])

    from paths_tpu_torch.data.feature_store import FeatureStore

    dim = FeatureStore(store_dir).load(ids[0], 0.625).shape[-1]
    print(f"== 4/9 train ({args.epochs} epochs, encoder dim {dim})",
          flush=True)
    make_metadata(os.path.join(wd, "meta.csv"), ids)
    demo_config(dim, args.epochs, wd, store_dir).save(model_dir)

    from paths_tpu_torch.cli.train import main as train

    stats = train(["-m", model_dir, "--no-wandb", *dev])

    print("== 5/9 evaluate", flush=True)
    from paths_tpu_torch.cli.evaluate import main as evaluate

    metrics = evaluate(["-m", model_dir, "--split", "test", *dev])

    print("== 6/9 predict", flush=True)
    from paths_tpu_torch.cli.predict import main as predict

    preds_csv = os.path.join(wd, "predictions.csv")
    predict(["-m", model_dir, "--split", "test", "-o", preds_csv, *dev])

    print("== 7/9 heatmap", flush=True)
    pdf = heatmap_stage(model_dir, os.path.join(slide_dir, f"{ids[0]}.npy"),
                        os.path.join(wd, "heatmap.pdf"), args.encoder,
                        weights, device)

    print("== 8/9 export serving artifact (torch.export)", flush=True)
    from paths_tpu_torch.cli.export import main as export
    from paths_tpu_torch.export import artifact_signature, load_serving

    artifact = os.path.join(wd, "model.pt2z")
    export(["-m", model_dir, "-o", artifact, "--freeze",
            "--batch-size", "2", "--platforms", device.type])
    with open(artifact, "rb") as f:
        exp = load_serving(f.read())
    frozen, batch, _ = artifact_signature(exp)
    print(f"artifact reloads: platforms={exp.platforms}, frozen={frozen}, "
          f"batch {batch}", flush=True)

    print("== 9/9 serve the artifact over HTTP", flush=True)
    import http.client
    import threading

    from paths_tpu_torch.cli.serve import make_server
    from paths_tpu_torch.serve import ServingSession

    session = ServingSession(model_dir, artifact=artifact, device=device)
    server = make_server(session, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("POST", "/predict",
                     body=json.dumps({"slide_ids": session.slide_ids[:2]}))
        served = json.loads(conn.getresponse().read())["predictions"]
        conn.close()
        for row in served:
            print(f"  {row['slide_id']}: risk {row['risk']:.4f}", flush=True)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)

    print("\n=== demo complete ===")
    print("metrics:", json.dumps(metrics))
    print("predictions:", preds_csv)
    print("heatmap:", pdf)
    print("serving artifact:", artifact)
    print("work dir:", wd)
    print("train loss:", stats["train_loss"], flush=True)
    return {"metrics": metrics, "served": served, "train_stats": stats,
            "predictions": preds_csv, "heatmap": pdf, "artifact": artifact}


if __name__ == "__main__":
    main()
