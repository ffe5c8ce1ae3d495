"""Driver of preprocessing cells: slides through the port's pipeline.

Set-up draws the traffic's slides on the device from the seed, holds each
in the port's array slide reader with its pyramid built (every
magnification the plan reads, and the masks' lower ones), draws the
encoder's weights from the seed into the port's ViT, and binds the encode
function as `encoders.registry.from_name` binds it. One pass of the first
slide warms every shape.

The window is a closed loop of passes, one job: slide after slide, each
pass runs `preprocess.pipeline.process_level` at every magnification and
stores each grid with `FeatureStore.save`, as `process_slide` does, under a
new slide id each pass. The metric counts the tissue patches the plan of
each completed pass holds.

The check: every completed pass's grids against the reference's tissue
plan (shape, and which rows hold features: exact), and a sample of patches
drawn from the seed, the reference encoding each from the slide's pixels in
float32, against the stored rows.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline
from benchmark.drivers.common import matmul_precision, sample_rng
from benchmark.inputs import slides as slide_inputs
from benchmark.inputs.weights import vit_weights
from benchmark.reference import uni as ref


def _spec(dims: dict):
    from paths_tpu_torch.encoders import vit

    return vit.ViTSpec(img_size=dims["img_size"], patch_size=dims["patch_size"],
                       embed_dim=dims["embed_dim"], depth=dims["depth"],
                       num_heads=dims["num_heads"], mlp_ratio=dims["mlp_ratio"],
                       layer_scale=dims["layer_scale"])


def build_vit(dims: dict, weights: Dict[str, torch.Tensor], device):
    """The port's ViT on `device` holding `weights`."""
    from paths_tpu_torch.encoders import vit

    with torch.device(device):
        model = vit.ViT(_spec(dims))
    with torch.no_grad():
        model.patch_embed.weight.copy_(weights["patch_embed/w"])
        model.patch_embed.bias.copy_(weights["patch_embed/b"])
        model.cls_token.copy_(weights["cls_token"])
        model.pos_embed.copy_(weights["pos_embed"])
        model.norm.weight.copy_(weights["norm/scale"])
        model.norm.bias.copy_(weights["norm/bias"])
        for i, blk in enumerate(model.blocks):
            b = f"blocks/{i}"
            for norm in ("norm1", "norm2"):
                getattr(blk, norm).weight.copy_(weights[f"{b}/{norm}/scale"])
                getattr(blk, norm).bias.copy_(weights[f"{b}/{norm}/bias"])
            for lin in ("qkv", "proj", "fc1", "fc2"):
                getattr(blk, lin).weight.copy_(weights[f"{b}/{lin}/w"])
                getattr(blk, lin).bias.copy_(weights[f"{b}/{lin}/b"])
            blk.ls1.copy_(weights[f"{b}/ls1"])
            blk.ls2.copy_(weights[f"{b}/ls2"])
    return model


def bind_encoder(model, compute_dtype: torch.dtype, block_impl: str):
    """`encoders.registry.from_name`'s encode function over `model`: uint8
    (B, P, P, 3) -> float [0, 1] -> UNI's transform -> `vit_apply`."""
    from paths_tpu_torch.encoders import transforms, vit

    def encode(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            x = transforms.apply_transform(images.float() / 255.0,
                                           transforms.UNI_TRANSFORM)
            return vit.vit_apply(model, x, compute_dtype=compute_dtype,
                                 block_impl=block_impl)
    return encode


class Driver:
    def __init__(self, run):
        self.run = run
        self.dims = run.config["model"]
        self.tr = run.traffic
        self.pipe = self.tr["pipeline"]
        self.powers: List[float] = self.tr["magnifications"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from paths_tpu_torch.data.feature_store import FeatureStore
        from paths_tpu_torch.preprocess.wsi import ArrayWSI

        run, tr, dev = self.run, self.tr, self.run.device
        sl = tr["slides"]
        self.bases = [slide_inputs.make_slide(run.seed, i, sl["height"],
                                              sl["width"], sl["tissue"], dev)
                      for i in range(sl["count"])]
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.wsis = [ArrayWSI(b, base_power=sl["base_power"]) for b in self.bases]
        for wsi in self.wsis:          # the pyramid a slide file holds
            for p in self.powers:
                for q in (p, p / self.pipe["downscale"]):
                    wsi.read_rect((0, 0), (1, 1), q)
        w = vit_weights(self.dims, run.seed, dev)
        self.model = build_vit(self.dims, w, dev)
        del w
        self.encode = bind_encoder(self.model, getattr(torch, self.dims["compute_dtype"]),
                                   self.dims["block_impl"])
        self.store = FeatureStore(os.path.join(run.tmp, "store"), create=True)
        self.passes: List[int] = []
        self._pass(0, "warmup")

    def _pass(self, slide: int, sid: str) -> None:
        from paths_tpu_torch.preprocess.pipeline import process_level

        p = self.pipe
        for power in self.powers:
            with self.run.span("bench.process_level"):
                grid = process_level(
                    self.wsis[slide], self.encode, self.dims["embed_dim"], power,
                    patch_size=p["patch_size"], tissue_threshold=p["tissue_threshold"],
                    downscale=p["downscale"], batch_size=p["batch_size"],
                    threads=p["threads"], store_dtype=p["store_dtype"],
                    device=self.run.device)
            with self.run.span("bench.store_save"):
                self.store.save(sid, power, grid)

    # ------------------------------------------------------------ window
    def _loop(self, seconds: float, ids: List[int]) -> float:
        t0 = time.perf_counter()
        while True:
            slide = len(self.passes) % len(self.wsis)
            self._pass(slide, f"pass{len(self.passes):05d}")
            self.passes.append(slide)
            ids.append(len(self.passes) - 1)
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        self.window_passes: List[int] = []
        self.window_s = self._loop(seconds, self.window_passes)
        self.plans = [self._plan(i) for i in range(len(self.wsis))]
        patches = sum(self._patches(self.passes[i]) for i in self.window_passes)
        return {"attempted": len(self.window_passes), "failed": 0,
                "metrics": {"encode_patches_per_s": patches / self.window_s}}

    def traced(self, seconds: float) -> None:
        self._loop(seconds, [])

    def _plan(self, slide: int) -> list:
        p = self.pipe
        return [ref.tissue_plan(self.bases[slide], self.tr["slides"]["base_power"],
                                power, p["patch_size"], p["tissue_threshold"],
                                p["downscale"]) for power in self.powers]

    def _patches(self, slide: int) -> int:
        return sum(len(cells) for _, _, cells in self.plans[slide])

    def release(self) -> None:
        self.model = self.encode = None
        if self.run.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Stop what the driver started (also after a failure)."""
        self.model = self.encode = None

    # ------------------------------------------------------------ check
    def _sample(self) -> List[tuple]:
        """(pass, level, cells) drawn from the seed: the last pass and one
        more, `sample_patches` cells each, spread over the levels."""
        rng = sample_rng(self.run.seed)
        ids = self.window_passes
        chosen = sorted({ids[-1], int(rng.choice(ids))})
        per = self.tr["check"]["sample_patches"]
        out = []
        for pid in chosen:
            plans = self.plans[self.passes[pid]]
            total = sum(len(c) for _, _, c in plans)
            for lvl, (_, _, cells) in enumerate(plans):
                if len(cells) == 0:
                    continue
                k = min(len(cells), max(1, math.ceil(per * len(cells) / total)))
                pick = np.sort(rng.choice(len(cells), size=k, replace=False))
                out.append((pid, lvl, cells[pick]))
        return out

    def _reference(self, sample, products: str = "exact") -> List[np.ndarray]:
        """The reference's features of the sampled cells, in float32 with
        TF32 off (`products` "fp8": the projections' operands in fp8)."""
        dev = self.run.device
        w = vit_weights(self.dims, self.run.seed, dev)
        feats = []
        with torch.no_grad(), matmul_precision(False):
            for pid, lvl, cells in sample:
                img = ref.level_image(self.bases[self.passes[pid]],
                                      self.tr["slides"]["base_power"],
                                      self.powers[lvl])
                px = torch.from_numpy(ref.patches(img, cells,
                                                  self.pipe["patch_size"])).to(dev)
                rows = []
                for s in range(0, len(px), 32):
                    x = ref.transform(px[s: s + 32], self.dims["img_size"]).float()
                    rows.append(ref.vit_forward(w, self.dims, x, products)
                                .double().cpu())
                feats.append(torch.cat(rows).numpy())
        del w
        return feats

    def _stored(self, sample) -> List[np.ndarray]:
        return [np.asarray(self.store.load(f"pass{pid:05d}", self.powers[lvl]))
                [cells[:, 0], cells[:, 1]].astype(np.float64)
                for pid, lvl, cells in sample]

    @staticmethod
    def _gap(got: List[np.ndarray], want: List[np.ndarray]) -> float:
        worst = 0.0
        for g, r in zip(got, want):
            rel = np.linalg.norm(g - r, axis=1) / np.linalg.norm(r, axis=1)
            worst = max(worst, float(rel.max()))
        return worst

    def plan_mismatches(self) -> int:
        bad = 0
        for pid in self.window_passes:
            for power, (nr, nc, cells) in zip(self.powers,
                                              self.plans[self.passes[pid]]):
                grid = np.asarray(self.store.load(f"pass{pid:05d}", power))
                if grid.shape != (nr, nc, self.dims["embed_dim"]):
                    bad += 1
                    continue
                want = np.zeros((nr, nc), bool)
                want[cells[:, 0], cells[:, 1]] = True
                bad += int(((grid != 0).any(-1) != want).sum())
        return bad

    def check(self) -> Dict[str, tuple]:
        lim = self.tr["check"]["limits"]
        self.sample = self._sample()
        self.ref_feats = self._reference(self.sample)
        return {"plan_mismatches": (self.plan_mismatches(), lim["plan_mismatches"]),
                "feature_gap": (self._gap(self._stored(self.sample), self.ref_feats),
                                lim["feature_gap"])}

    def control(self) -> Dict[str, Dict[str, float]]:
        """The compared numbers of the controls on the same patches: the
        port's int8 route (the precision below bf16 that the program has),
        encoded in batches of the pipeline's size, and the reference with
        its products in fp8."""
        from paths_tpu_torch.kernels import vit_int8

        dev = self.run.device
        model = vit_int8.quantize_vit_blocks(
            build_vit(self.dims, vit_weights(self.dims, self.run.seed, dev), dev))
        encode = bind_encoder(model, getattr(torch, self.dims["compute_dtype"]),
                              "int8")
        got = []
        bs = self.pipe["batch_size"]
        for pid, lvl, cells in self.sample:
            img = ref.level_image(self.bases[self.passes[pid]],
                                  self.tr["slides"]["base_power"], self.powers[lvl])
            px = ref.patches(img, cells, self.pipe["patch_size"])
            rows = []
            for s in range(0, len(px), bs):
                part = np.zeros((bs,) + px.shape[1:], np.uint8)
                n = min(bs, len(px) - s)
                part[:n] = px[s: s + n]
                rows.append(encode(torch.from_numpy(part).to(dev))[:n]
                            .double().cpu().numpy())
            got.append(np.concatenate(rows))
        del model, encode
        return {"int8 route": {"feature_gap": self._gap(got, self.ref_feats)},
                "fp8 reference": {"feature_gap": self._gap(
                    self._reference(self.sample, "fp8"), self.ref_feats)}}

    # ------------------------------------------------------------ layers
    def useful_flops(self, passes: List[int]) -> float:
        return roofline.vit_flops_per_image(self.dims) * sum(
            self._patches(self.passes[i]) for i in passes)
