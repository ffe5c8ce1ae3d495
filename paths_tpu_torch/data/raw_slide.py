"""RawSlide: inference on slides that were never preprocessed: patches are
read from the WSI and encoded on the fly (counterpart of
`paths_tpu.data.raw_slide`).

A slide holds *load regions* (patch-size x multiplier squares at the current
power); `load_patches()` reads them, Otsu-masks them with one shared
threshold, patchifies, and keeps patches above a tissue threshold, halving
the threshold while nothing passes and keeping one patch when the slide is
all background; `recurse()` keeps the top-K patches by importance and maps
their locations x multiplier into the next power's load regions.

Reading and masking are host numpy. `encode_bag` sends the patches to the
device as uint8, casts them there, and encodes them in power-of-two buckets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from paths_tpu_torch.models.batch import PatchBag
from paths_tpu_torch.preprocess.masking import tissue_masks
from paths_tpu_torch.preprocess.pipeline import _bucket, next_multiple
from paths_tpu_torch.preprocess.wsi import WSIReader, camelyon_map, open_wsi


def patchify_locs(img: np.ndarray, patch_size: int, im_loc) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, C) -> ((H/P*W/P, P, P, C) patches, (H/P*W/P, 2) pixel locs),
    row-major over the grid."""
    h, w, c = img.shape
    p = patch_size
    assert h % p == 0 and w % p == 0, (h, w, p)
    h2, w2 = h // p, w // p
    patches = img.reshape(h2, p, w2, p, c).transpose(0, 2, 1, 3, 4)
    patches = patches.reshape(h2 * w2, p, p, c)
    ys = np.repeat(np.arange(h2), w2) * p + int(im_loc[0])
    xs = np.tile(np.arange(w2), h2) * p + int(im_loc[1])
    return patches, np.stack([ys, xs], axis=1).astype(np.int64)


class RawSlide:
    def __init__(self, path: str, power: float, patch_size: int,
                 load_locs: np.ndarray, load_size: Tuple[int, int],
                 ctx_slide: np.ndarray, parent_ctx_patch: Optional[np.ndarray],
                 tissue_threshold: float = 0.1,
                 ctx_patch_dim: Optional[int] = None, keep_inds=None,
                 subtype=None, camelyon: bool = False,
                 default_power: float = 40.0):
        self.path = path
        self.power = power
        self.patch_size = patch_size
        self.load_locs = np.asarray(load_locs, np.int64)   # (L, 2) (y, x) px
        self.load_size = load_size
        self.ctx_slide = ctx_slide
        self.parent_ctx_patch = parent_ctx_patch
        self.tissue_threshold = tissue_threshold
        self.ctx_patch_dim = ctx_patch_dim
        self.keep_inds = keep_inds
        self.subtype = subtype
        self.camelyon = camelyon
        self.default_power = default_power

        self.patches = None        # (N, P, P, 3) uint8 after load_patches
        self.locs = None           # (N, 2) pixel coords at this power
        self.parent_inds = None    # (N,) index into load_locs
        self.ctx_patch = None      # (N, depth, Dp)
        self.size_pixels = None

    def parent_ind_map(self):
        """Map from my patch indices to indices in my parent slide."""
        return self.keep_inds[self.parent_inds]

    def unload_patches(self):
        self.patches = self.locs = self.parent_inds = self.ctx_patch = None

    def view_at_power(self, power: float) -> np.ndarray:
        wsi = open_wsi(self.path, self.default_power)
        try:
            dims = wsi.slide_dimensions(power)
            out = wsi.read_rect((0, 0), dims, power)
        finally:
            wsi.close()
        return camelyon_map(out) if self.camelyon else out

    def load_patches(self, wsi: Optional[WSIReader] = None) -> "RawSlide":
        if self.patches is not None:
            print("load_patches(): patches already resident; skipping "
                  "reload.")
            return self

        h, w = self.load_size
        p = self.patch_size
        assert h % p == 0 and w % p == 0, (
            f"Load size {self.load_size} is not divisible by patch size {p}.")

        own = wsi is None
        if own:
            wsi = open_wsi(self.path, self.default_power)
        try:
            ht, wt = wsi.slide_dimensions(self.power)
            self.size_pixels = (next_multiple(ht, p), next_multiple(wt, p))
            ims = [wsi.read_rect(tuple(loc), self.load_size, self.power)
                   for loc in self.load_locs]
        finally:
            if own:
                wsi.close()
        if self.camelyon:
            ims = [camelyon_map(i) for i in ims]

        masks = tissue_masks(ims)        # one Otsu threshold over all loads

        all_patches, all_locs, all_parents = [], [], []
        mask_patches = []
        for i, (im, mk) in enumerate(zip(ims, masks)):
            pt, lc = patchify_locs(im, p, self.load_locs[i])
            mp, _ = patchify_locs(mk[..., None].astype(np.float32), p, (0, 0))
            all_patches.append(pt)
            all_locs.append(lc)
            all_parents.append(np.full(pt.shape[0], i, np.int64))
            mask_patches.append(mp)
        patches = np.concatenate(all_patches)
        locs = np.concatenate(all_locs)
        parent_inds = np.concatenate(all_parents)
        proportions = np.concatenate(mask_patches).mean(axis=(1, 2, 3))

        # tissue filter, halving the threshold while nothing passes
        threshold = self.tissue_threshold
        indices = proportions > threshold
        while indices.sum() == 0 and threshold > 1e-6:
            print(f"no patch passes tissue threshold {threshold} "
                  f"({self.path}); halving threshold and retrying")
            threshold /= 2
            indices = proportions > threshold
        if threshold <= 1e-6:
            print("slide appears fully background; keeping one patch as a "
                  "fallback")
            indices = np.zeros(len(proportions), bool)
            indices[0] = True

        self.patches = patches[indices]
        self.locs = locs[indices]
        self.parent_inds = parent_inds[indices]

        if self.parent_ctx_patch is None:
            n = self.patches.shape[0]
            self.ctx_patch = np.zeros((n, 0, self.ctx_patch_dim), np.float32)
        else:
            self.ctx_patch = self.parent_ctx_patch[self.parent_inds]
        return self

    def recurse(self, multiplier: int, ctx_slide: np.ndarray,
                ctx_patch: np.ndarray, importance: np.ndarray,
                keep_patches: int = -1) -> "RawSlide":
        """Top-K by importance -> the next power's RawSlide (exact ties go
        to the lower index)."""
        assert importance.ndim == 1, importance.shape
        if self.patches is None:
            raise RuntimeError("recurse() called before load_patches()")

        ctx_slide = np.concatenate([self.ctx_slide, ctx_slide[None]], axis=0)
        ctx_patch = np.concatenate([self.ctx_patch, ctx_patch[:, None]], axis=1)

        keep_locs = self.locs
        if keep_patches != -1:
            count = min(importance.shape[0], keep_patches)
            keep_inds = np.argsort(-importance, kind="stable")[:count]
            ctx_patch = ctx_patch[keep_inds]
            keep_locs = keep_locs[keep_inds]
        else:
            keep_inds = np.arange(importance.shape[0])

        return RawSlide(
            self.path, self.power * multiplier, self.patch_size,
            keep_locs * multiplier,
            (self.patch_size * multiplier, self.patch_size * multiplier),
            ctx_slide, ctx_patch, tissue_threshold=self.tissue_threshold,
            keep_inds=keep_inds, subtype=self.subtype, camelyon=self.camelyon,
            default_power=self.default_power)

    def __repr__(self):
        n = "?" if self.patches is None else self.patches.shape[0]
        return (f"RawSlide(num_patches={n}, ctx_depth={self.ctx_slide.shape[0]}, "
                f"power={self.power})")


def load_raw_slide(path: str, base_power: float, patch_size: int,
                   ctx_dim: Tuple[int, int], tissue_threshold: float = 0.1,
                   prepatch: bool = True, subtype=None,
                   camelyon: bool = False,
                   default_power: float = 40.0) -> RawSlide:
    """Open a WSI as a single full-slide load region at `base_power`."""
    wsi = open_wsi(path, default_power)
    try:
        h, w = wsi.slide_dimensions(base_power)
        h, w = next_multiple(h, patch_size), next_multiple(w, patch_size)
        slide = RawSlide(path, base_power, patch_size,
                         np.array([[0, 0]]), (h, w),
                         np.zeros((0, ctx_dim[0]), np.float32), None,
                         tissue_threshold, ctx_patch_dim=ctx_dim[1],
                         subtype=subtype, camelyon=camelyon,
                         default_power=default_power)
        if prepatch:
            slide.load_patches(wsi)
    finally:
        wsi.close()
    return slide


def encode_bag(slide: RawSlide, encode_fn, batch_size: int = 256,
               device="cuda") -> PatchBag:
    """Encode a loaded RawSlide's patches into a one-slide PatchBag on
    `device`. The patches cross as uint8 and become [0, 1] floats there, in
    batches padded to power-of-two buckets (`pipeline._bucket`: the full
    `batch_size` for the body, the smallest bucket for the tail), so the
    encoder sees few shapes; the features stay on the device."""
    assert slide.patches is not None, "call load_patches() first"
    n = slide.patches.shape[0]
    p = slide.patch_size
    device = torch.device(device)

    fts = []
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        arr = np.zeros((_bucket(e - s, batch_size), p, p, 3), np.uint8)
        arr[: e - s] = slide.patches[s:e]
        x = torch.from_numpy(arr).to(device)
        fts.append(encode_fn(x.float() / 255.0)[: e - s].float())
    fts = torch.cat(fts) if fts else torch.zeros((0, 0), device=device)

    def on(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    return PatchBag(
        fts=fts[None],
        locs=on(slide.locs[None], torch.int64),
        mask=torch.ones((1, n), dtype=torch.bool, device=device),
        parent_inds=on(slide.parent_inds[None], torch.int64),
        ctx_slide=on(slide.ctx_slide[None], torch.float32),
        ctx_patch=on(slide.ctx_patch[None], torch.float32))
