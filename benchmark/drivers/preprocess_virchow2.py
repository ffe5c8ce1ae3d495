"""Driver of the Virchow2 preprocessing cell: `drivers/preprocess.py`'s
closed loop of slide passes, checks and readings, with the published
Virchow2 as the encoder.

What differs from UNI's driver:
  * the weights are drawn from the seed as timm's state dict
    (`reference.virchow2.vit_specs`: fc1 (6832, 1280), fc2 (1280, 3416),
    `reg_token` (1, 4, 1280), `pos_embed` (1, 261, 1280), `ls{1,2}.gamma`)
    and loaded through the port's converter
    (`encoders.convert_vit.vit_from_timm`) into `encoders.vit.VIRCHOW2`,
    which the configuration's spec must equal;
  * the encode function is bound as `encoders.registry.from_name` binds
    "virchow2" (`VIRCHOW2_TRANSFORM`);
  * a stored row is the encoder's 2560-d output;
  * the reference is `reference.virchow2`; `feature_gap` is the worse of
    the class-token half's gap and the patch-mean half's, so that neither
    half hides the other; the control is the reference with its products
    in fp8 (the port's int8 route takes no head_dim 80);
  * the useful operations are the published model's (`glu_vit`).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark import glu_vit
from benchmark.drivers import preprocess
from benchmark.drivers.common import matmul_precision
from benchmark.inputs import slides as slide_inputs
from benchmark.inputs.timm_weights import timm_weights
from benchmark.reference import uni
from benchmark.reference import virchow2 as ref


def _spec(dims: dict):
    """The port's spec of the configuration; it must be the registry's."""
    from paths_tpu_torch.encoders import vit

    spec = vit.ViTSpec(
        img_size=dims["img_size"], patch_size=dims["patch_size"],
        embed_dim=dims["embed_dim"], depth=dims["depth"],
        num_heads=dims["num_heads"], mlp_ratio=dims["mlp_ratio"],
        layer_scale=dims["layer_scale"], swiglu=True,
        glu_width=dims["glu_width"], num_reg_tokens=dims["reg_tokens"],
        pool=dims["pool"])
    if spec != vit.VIRCHOW2:
        raise ValueError(f"the configuration's spec {spec} is not the "
                         f"port's VIRCHOW2 {vit.VIRCHOW2}")
    return spec


def bind_encoder(model, compute_dtype: torch.dtype, block_impl: str):
    """`encoders.registry.from_name("virchow2")`'s encode function over
    `model`: uint8 (B, P, P, 3) -> float [0, 1] -> Virchow2's transform ->
    `vit_apply`."""
    from paths_tpu_torch.encoders import transforms, vit

    def encode(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            x = transforms.apply_transform(images.float() / 255.0,
                                           transforms.VIRCHOW2_TRANSFORM)
            return vit.vit_apply(model, x, compute_dtype=compute_dtype,
                                 block_impl=block_impl)
    return encode


class Driver(preprocess.Driver):
    def __init__(self, run):
        super().__init__(run)
        self.vit_dims = run.config["model"]
        self.spec = _spec(self.vit_dims)
        # what the base driver reads of `dims` is the width of a stored row
        self.dims = dict(self.vit_dims, embed_dim=self.spec.out_dim)

    def _weights(self) -> Dict[str, torch.Tensor]:
        return timm_weights(ref.vit_specs(self.vit_dims), self.run.seed,
                            self.run.device)

    def setup(self) -> None:
        from paths_tpu_torch.data.feature_store import FeatureStore
        from paths_tpu_torch.encoders.convert_vit import vit_from_timm
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
        sd = {k: v.cpu().numpy() for k, v in self._weights().items()}
        with torch.device(dev):
            self.model = vit_from_timm(sd, self.spec)
        del sd
        self.encode = bind_encoder(self.model,
                                   getattr(torch, self.vit_dims["compute_dtype"]),
                                   self.vit_dims["block_impl"])
        self.store = FeatureStore(os.path.join(run.tmp, "store"), create=True)
        self.passes: List[int] = []
        self._pass(0, "warmup")

    # ------------------------------------------------------------ check
    def _reference(self, sample, products: str = "exact") -> List[np.ndarray]:
        """The reference's features of the sampled cells, in float32 with
        TF32 off (`products` "fp8": the projections' operands in fp8)."""
        dev = self.run.device
        w = self._weights()
        feats = []
        with torch.no_grad(), matmul_precision(False):
            for pid, lvl, cells in sample:
                img = uni.level_image(self.bases[self.passes[pid]],
                                      self.tr["slides"]["base_power"],
                                      self.powers[lvl])
                px = torch.from_numpy(uni.patches(img, cells,
                                                  self.pipe["patch_size"])).to(dev)
                rows = []
                for s in range(0, len(px), 32):
                    x = uni.transform(px[s: s + 32],
                                      self.vit_dims["img_size"]).float()
                    rows.append(ref.vit_forward(w, self.vit_dims, x, products)
                                .double().cpu())
                feats.append(torch.cat(rows).numpy())
        del w
        return feats

    def _gap(self, got: List[np.ndarray], want: List[np.ndarray]) -> float:
        d = self.spec.embed_dim
        halves = [preprocess.Driver._gap([g[:, part] for g in got],
                                         [r[:, part] for r in want])
                  for part in (slice(0, d), slice(d, None))]
        print(f"feature_gap: class-token half {halves[0]!r}, patch-mean half "
              f"{halves[1]!r}", file=sys.stderr)
        return max(halves)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The compared number of the control on the same patches: the
        reference with its products in fp8."""
        return {"fp8 reference": {"feature_gap": self._gap(
            self._reference(self.sample, "fp8"), self.ref_feats)}}

    # ------------------------------------------------------------ layers
    def useful_flops(self, passes: List[int]) -> float:
        return glu_vit.flops_per_image(self.vit_dims) * sum(
            self._patches(self.passes[i]) for i in passes)
