"""Otsu tissue masking (counterpart of `paths_tpu.preprocess.masking`; the
port keeps its own copy): grayscale conversion, Otsu threshold on the
histogram, tissue = darker than the threshold (H&E tissue absorbs light; the
glass background is bright).
"""
from __future__ import annotations

import numpy as np


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, matching skimage's rgb2gray weights."""
    img = np.asarray(img, np.float64)
    return img[..., 0] * 0.2125 + img[..., 1] * 0.7154 + img[..., 2] * 0.0721


def otsu_threshold(gray: np.ndarray, nbins: int = 256) -> float:
    """Classic Otsu: maximise the inter-class variance over histogram splits."""
    flat = np.asarray(gray, np.float64).ravel()
    lo, hi = float(flat.min()), float(flat.max())
    if lo == hi:
        return lo
    hist, edges = np.histogram(flat, bins=nbins, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2.0
    hist = hist.astype(np.float64)

    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m = np.cumsum(hist * centers)
    mu0 = m / np.maximum(w0, 1e-12)
    mu1 = (m[-1] - m) / np.maximum(w1, 1e-12)
    var_between = w0 * w1 * (mu0 - mu1) ** 2
    # exclude degenerate splits where one class is empty
    var_between[(w0 == 0) | (w1 == 0)] = -1
    return float(centers[int(np.argmax(var_between))])


def tissue_mask(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) bool, True = tissue."""
    gray = rgb_to_gray(img)
    return gray < otsu_threshold(gray)


def tissue_masks(imgs) -> list:
    """Batch variant fitting ONE threshold over all images."""
    grays = [rgb_to_gray(i) for i in imgs]
    t = otsu_threshold(np.concatenate([g.ravel() for g in grays]))
    return [g < t for g in grays]
