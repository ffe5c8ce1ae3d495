"""Host-side whole-slide-image access (counterpart of
`paths_tpu.preprocess.wsi`; the port keeps its own copy).

Readers give `objective_power`, `slide_dimensions(power)` as (h, w) pixels at
a magnification, and `read_rect(loc_hw, size_hw, power)` with coordinates in
the *target power's* pixel space. Returned arrays are (H, W, 3) uint8.
OpenSlide stays a host C dependency behind `OpenSlideWSI`; tests and the chip
script use array-backed `.npy` slides.
"""
from __future__ import annotations

import os
from typing import Protocol, Tuple

import numpy as np


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


def open_wsi(path: str, default_power: float = 40.0) -> WSIReader:
    """Open a slide file. `.npy` files open as ArrayWSI pyramids (a uint8
    H x W x 3 base image); anything else goes through OpenSlide/tiatoolbox.
    `.tiles` JPEG pyramids are not ported yet."""
    if path.endswith(".npy"):
        return ArrayWSI(np.load(path), base_power=default_power, path=path)
    if path.endswith(".tiles") or os.path.isfile(
            os.path.join(path, "meta.json")):
        raise NotImplementedError(
            "JPEG-tiled pyramids (`.tiles`) wait for the native JPEG decoder: "
            "ROADMAP.md Queue 1, 'left out of the preprocess slice'")
    return OpenSlideWSI(path, default_power)


def camelyon_map(patch: np.ndarray) -> np.ndarray:
    """CAMELYON scans use black backgrounds; remap to white."""
    img = patch.copy()
    black = img.mean(axis=2) <= 0.01 * 255
    img[black] = 255
    return img
