"""Host-side whole-slide-image access (counterpart of
`paths_tpu.preprocess.wsi`; the port keeps its own copy).

Readers give `objective_power`, `slide_dimensions(power)` as (h, w) pixels at
a magnification, and `read_rect(loc_hw, size_hw, power)` with coordinates in
the *target power's* pixel space. Returned arrays are (H, W, 3) uint8.
OpenSlide stays a host C dependency behind `OpenSlideWSI`; tests and the chip
script use array-backed `.npy` slides and JPEG-tiled `.tiles` pyramids
(`TiledJpegWSI`, written by `write_tiled_jpeg`).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Protocol, Tuple

import numpy as np

from paths_tpu_torch.native import jpeg as njpeg


class WSIReader(Protocol):
    path: str

    def objective_power(self) -> float: ...

    def slide_dimensions(self, power: float) -> Tuple[int, int]: ...

    def read_rect(self, loc: Tuple[int, int], size: Tuple[int, int],
                  power: float) -> np.ndarray: ...

    def close(self) -> None: ...


class OpenSlideWSI:
    """tiatoolbox/OpenSlide-backed reader (requires those host packages)."""

    def __init__(self, path: str, default_power: float = 40.0):
        from tiatoolbox.wsicore.wsireader import WSIReader as TTReader

        self.path = path
        self._wsi = TTReader.open(path)
        if self._wsi.info.objective_power is None:
            print("No objective power; assuming 40")
            self._wsi._m_info.objective_power = default_power

    def objective_power(self) -> float:
        return float(self._wsi.info.objective_power)

    def slide_dimensions(self, power: float) -> Tuple[int, int]:
        # tiatoolbox returns (width, height); the convention here is (rows, cols)
        w, h = self._wsi.slide_dimensions(resolution=power, units="power")
        return int(h), int(w)

    def read_rect(self, loc, size, power) -> np.ndarray:
        # here: loc=(row, col), size=(rows, cols);
        # tiatoolbox: location=(x, y), size=(width, height), output (h, w, ch)
        y, x = loc
        h, w = size
        return np.asarray(self._wsi.read_rect(
            (x, y), (w, h), resolution=power, units="power",
            coord_space="resolution"))

    def close(self) -> None:
        try:
            self._wsi.openslide_wsi.close()
        except AttributeError:
            pass


class ArrayWSI:
    """Array-backed pyramid reader: a base image at `base_power` is
    resampled (nearest neighbour) for other magnifications."""

    def __init__(self, base_image: np.ndarray, base_power: float = 40.0,
                 path: str = "<array>"):
        if base_image.ndim != 3 or base_image.shape[2] != 3:
            raise ValueError(f"base image {base_image.shape}: want (H, W, 3)")
        self.base = np.asarray(base_image, np.uint8)
        self.base_power = float(base_power)
        self.path = path
        self._levels: dict = {}  # power -> resampled image cache

    def objective_power(self) -> float:
        return self.base_power

    def slide_dimensions(self, power: float) -> Tuple[int, int]:
        scale = power / self.base_power
        h, w = self.base.shape[:2]
        return int(round(h * scale)), int(round(w * scale))

    def _at_power(self, power: float) -> np.ndarray:
        h, w = self.slide_dimensions(power)
        if (h, w) == self.base.shape[:2]:
            return self.base
        cached = self._levels.get(power)
        if cached is not None:
            return cached
        # cached per power: read_rect is called once per patch, and pyramids
        # hold few distinct powers but many patches
        ys = np.clip((np.arange(h) * self.base.shape[0] / h).astype(int), 0,
                     self.base.shape[0] - 1)
        xs = np.clip((np.arange(w) * self.base.shape[1] / w).astype(int), 0,
                     self.base.shape[1] - 1)
        img = self.base[np.ix_(ys, xs)]
        self._levels[power] = img
        return img

    def read_rect(self, loc, size, power) -> np.ndarray:
        img = self._at_power(power)
        y, x = int(loc[0]), int(loc[1])
        h, w = int(size[0]), int(size[1])
        out = np.full((h, w, 3), 255, np.uint8)   # pad beyond bounds = white
        ys, xs = max(y, 0), max(x, 0)
        ye, xe = min(y + h, img.shape[0]), min(x + w, img.shape[1])
        if ye > ys and xe > xs:
            out[ys - y: ye - y, xs - x: xe - x] = img[ys:ye, xs:xe]
        return out

    def close(self) -> None:
        pass


class TiledJpegWSI:
    """JPEG-tiled pyramid reader: a directory of compressed tiles, so
    every `read_rect` pays real per-tile decode work on the host — the
    same access shape as OpenSlide's tiled `.svs` decode (the true
    production bottleneck). ArrayWSI's memcpy "decode" makes host-side
    numbers look better than OpenSlide reality; this reader keeps them
    honest.

    Layout (written by `write_tiled_jpeg`):
        <dir>/meta.json      {"base_power", "tile", "levels": [{power,h,w}]}
        <dir>/L{i}_t{row}_{col}.jpg

    Like an .svs, a few downsampled pyramid levels are stored; a read
    decodes tiles from the smallest stored level at or above the
    requested power, then resamples (nearest). A small decoded-tile LRU
    keeps neighboring reads from re-decoding.

    Decode goes through the native batched decoder when built
    (`paths_tpu_torch/native/jpegdec.cpp`): all tiles a read needs decode
    in ONE GIL-free OpenMP call instead of a PIL call per tile — the decode
    fan-out the reference pipeline buys with 32 processes, inside one
    process. PIL is the fallback (`decoder="pil"` forces it; "native"
    requires the library)."""

    def __init__(self, path: str, cache_tiles: int = 64,
                 decoder: str = "auto"):
        import json

        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        self.base_power = float(meta["base_power"])
        self.tile = int(meta["tile"])
        self.levels = meta["levels"]   # descending power
        self._cache: "OrderedDict" = OrderedDict()
        self._cache_tiles = cache_tiles
        if decoder not in ("auto", "native", "pil"):
            raise ValueError(f"decoder={decoder!r}: want auto, native or pil")
        if decoder == "native" and not njpeg.available():
            raise RuntimeError("native JPEG decoder not built: python -m "
                               "paths_tpu_torch.native.build")
        self._native = (njpeg if decoder != "pil" and njpeg.available()
                        else None)

    def objective_power(self) -> float:
        return self.base_power

    def slide_dimensions(self, power: float) -> Tuple[int, int]:
        scale = power / self.base_power
        h, w = self.levels[0]["h"], self.levels[0]["w"]
        return int(round(h * scale)), int(round(w * scale))

    def _pick_level(self, power: float) -> int:
        for li in range(len(self.levels) - 1, -1, -1):
            if self.levels[li]["power"] >= power - 1e-9:
                return li
        return 0

    def _tile(self, li: int, tr: int, tc: int) -> np.ndarray:
        key = (li, tr, tc)
        img = self._cache.pop(key, None)
        if img is None:
            from PIL import Image

            p = os.path.join(self.path, f"L{li}_t{tr}_{tc}.jpg")
            img = np.asarray(Image.open(p).convert("RGB"))
        self._cache[key] = img
        while len(self._cache) > self._cache_tiles:
            self._cache.popitem(last=False)
        return img

    def _prefetch_tiles(self, keys) -> None:
        """Batch-decode every uncached tile in `keys` with one native
        call (parallel across tiles); no-op without the native library
        (read_rect then falls back to per-tile PIL in `_tile`)."""
        if self._native is None:
            return
        missing = [k for k in keys if k not in self._cache]
        if not missing:
            return
        bufs = []
        for li, tr, tc in missing:
            with open(os.path.join(self.path, f"L{li}_t{tr}_{tc}.jpg"),
                      "rb") as f:
                bufs.append(f.read())
        decoded = self._native.decode_batch(bufs, (self.tile, self.tile))
        if decoded is None:
            return
        out, dims = decoded
        for k, slot, (h, w) in zip(missing, out, dims):
            if h < 0:          # corrupt tile: let PIL raise the real error
                continue
            self._cache[k] = slot[:h, :w]
        # one oversize read may need more tiles than the steady-state cap;
        # never evict tiles this very read is about to consume
        while len(self._cache) > max(self._cache_tiles, len(keys)):
            self._cache.popitem(last=False)

    def read_rect(self, loc, size, power) -> np.ndarray:
        li = self._pick_level(power)
        lv = self.levels[li]
        scale = lv["power"] / power
        y0 = int(round(loc[0] * scale))
        x0 = int(round(loc[1] * scale))
        hb = max(int(round(size[0] * scale)), 1)
        wb = max(int(round(size[1] * scale)), 1)
        H, W = lv["h"], lv["w"]
        out = np.full((hb, wb, 3), 255, np.uint8)
        ys, xs = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + hb, H), min(x0 + wb, W)
        t = self.tile
        if ye > ys and xe > xs:
            keys = [(li, tr, tc)
                    for tr in range(ys // t, (ye - 1) // t + 1)
                    for tc in range(xs // t, (xe - 1) // t + 1)]
            self._prefetch_tiles(keys)
            # an oversize read (whole-level mask read) may span more tiles
            # than the steady-state cache cap: hold them all until done
            cap, self._cache_tiles = (self._cache_tiles,
                                      max(self._cache_tiles, len(keys)))
            try:
                for li_, tr, tc in keys:
                    tile = self._tile(li_, tr, tc)
                    ty0, tx0 = tr * t, tc * t
                    cy0, cx0 = max(ys, ty0), max(xs, tx0)
                    cy1 = min(ye, ty0 + tile.shape[0])
                    cx1 = min(xe, tx0 + tile.shape[1])
                    if cy1 > cy0 and cx1 > cx0:
                        out[cy0 - y0: cy1 - y0, cx0 - x0: cx1 - x0] = \
                            tile[cy0 - ty0: cy1 - ty0,
                                 cx0 - tx0: cx1 - tx0]
            finally:
                self._cache_tiles = cap
                while len(self._cache) > cap:
                    self._cache.popitem(last=False)
        if (hb, wb) == tuple(size):
            return out
        ys_i = np.clip((np.arange(size[0]) * hb / size[0]).astype(int), 0,
                       hb - 1)
        xs_i = np.clip((np.arange(size[1]) * wb / size[1]).astype(int), 0,
                       wb - 1)
        return out[np.ix_(ys_i, xs_i)]

    def close(self) -> None:
        self._cache.clear()


def write_tiled_jpeg(base_image: np.ndarray, out_dir: str,
                     base_power: float = 40.0, tile: int = 512,
                     quality: int = 80, downsamples=(1, 4, 16)) -> str:
    """Write a uint8 (H, W, 3) base image as a TiledJpegWSI pyramid with
    `downsamples` levels (1 = the base)."""
    import json

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    levels = []
    for li, ds in enumerate(downsamples):
        img = base_image[::ds, ::ds] if ds > 1 else base_image
        h, w = img.shape[:2]
        levels.append({"power": base_power / ds, "h": h, "w": w})
        for tr in range(-(-h // tile)):
            for tc in range(-(-w // tile)):
                Image.fromarray(img[tr * tile: (tr + 1) * tile,
                                    tc * tile: (tc + 1) * tile]).save(
                    os.path.join(out_dir, f"L{li}_t{tr}_{tc}.jpg"),
                    quality=quality)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"base_power": base_power, "tile": tile,
                   "levels": levels}, f)
    return out_dir


def open_wsi(path: str, default_power: float = 40.0) -> WSIReader:
    """Open a slide file. `.npy` files open as ArrayWSI pyramids (a uint8
    H x W x 3 base image; memcpy "decode"); `.tiles` directories open as
    TiledJpegWSI (real per-tile JPEG decode); anything else goes through
    OpenSlide/tiatoolbox."""
    if path.endswith(".npy"):
        return ArrayWSI(np.load(path), base_power=default_power, path=path)
    if path.endswith(".tiles") or os.path.isfile(
            os.path.join(path, "meta.json")):
        return TiledJpegWSI(path)
    return OpenSlideWSI(path, default_power)


def camelyon_map(patch: np.ndarray) -> np.ndarray:
    """CAMELYON scans use black backgrounds; remap to white."""
    img = patch.copy()
    black = img.mean(axis=2) <= 0.01 * 255
    img[black] = 255
    return img
