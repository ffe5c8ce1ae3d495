"""Synthetic H&E-like slides drawn on the device from the run's seed.

Tissue is a union of smooth blobs thresholded so that `tissue` of the area
is tissue, drawn at 1/16 of the slide's resolution and widened to it; the
tissue pixels mix an eosin pink and a hematoxylin purple by a smooth field
with per-pixel noise, the glass around them is near white. Otsu's threshold
parts the two, so about `tissue` of the grid cells pass a 0.1 tissue
threshold at every magnification.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.inputs.weights import generator

EOSIN = (228.0, 148.0, 190.0)
HEMATOXYLIN = (118.0, 66.0, 150.0)
GLASS = (241.0, 240.0, 238.0)


def make_slide(seed: int, index: int, height: int, width: int,
               tissue: float, device, rows_per_chunk: int = 1024) -> np.ndarray:
    """(height, width, 3) uint8 slide number `index` of the run `seed`."""
    g = generator(seed, 100 + index, device)
    lh, lw = height // 16, width // 16
    # blobs on a coarse grid, widened smoothly to 1/16 resolution
    ch, cw = max(lh // 8, 4), max(lw // 8, 4)
    params = torch.rand((12, 4), generator=g, device=device, dtype=torch.float64)
    yy = torch.linspace(0, 1, ch, device=device, dtype=torch.float64)[:, None]
    xx = torch.linspace(0, 1, cw, device=device, dtype=torch.float64)[None, :]
    field = torch.zeros((ch, cw), device=device, dtype=torch.float64)
    for cy, cx, r, a in params:
        rad = 0.08 + 0.17 * r
        field += (0.5 + a) * torch.exp(-((yy - (0.15 + 0.7 * cy)) ** 2
                                         + (xx - (0.15 + 0.7 * cx)) ** 2)
                                       / (2 * rad ** 2))
    field = F.interpolate(field[None, None].float(), size=(lh, lw),
                          mode="bilinear", align_corners=True)[0, 0]
    cut = torch.quantile(field.flatten().double(), 1.0 - tissue).float()
    mask_lo = field > cut
    mix_lo = torch.rand((ch, cw), generator=g, device=device)
    mix_lo = F.interpolate(mix_lo[None, None], size=(lh, lw), mode="bilinear",
                           align_corners=True)[0, 0]
    eosin = torch.tensor(EOSIN, device=device)
    hema = torch.tensor(HEMATOXYLIN, device=device)
    glass = torch.tensor(GLASS, device=device)
    out = np.empty((height, width, 3), np.uint8)
    for r0 in range(0, height, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, height)
        lr0, lr1 = r0 // 16, -(-r1 // 16)
        m = mask_lo[lr0:lr1].repeat_interleave(16, 0).repeat_interleave(16, 1)
        mix = mix_lo[lr0:lr1].repeat_interleave(16, 0).repeat_interleave(16, 1)
        m, mix = m[: r1 - r0, :width], mix[: r1 - r0, :width]
        noise = torch.randn((r1 - r0, width, 3), generator=g, device=device)
        tissue_px = (eosin + (hema - eosin) * mix[..., None]) + 22.0 * noise
        glass_px = glass + 3.0 * noise
        px = torch.where(m[..., None], tissue_px, glass_px)
        out[r0:r1] = px.clamp(0, 255).round().to(torch.uint8).cpu().numpy()
    return out
