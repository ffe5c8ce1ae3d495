"""Plain reference of UNI preprocessing: which grid cells of a slide hold
tissue at each magnification (the tissue plan), the pixels of each cell's
patch, the encoder's input transform and the ViT-L/16 forward.

The slide is an array at its base magnification; a lower magnification is
its nearest-neighbour resample (row i of an h-row level reads base row
floor(i * H / h)), as a slide file's pyramid holds it. A cell passes when
more than `threshold` of it is tissue on the Otsu mask of its level read at
1/`downscale` of the magnification.

The ViT follows timm's `VisionTransformer` with LayerScale: patch embedding,
class token, learned position embedding over [class, patches], pre-norm
blocks (attention, MLP with exact GELU), final LayerNorm, class token out.
It runs in float32 with TF32 off, or in any type it is given.

It imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ------------------------------------------------------------ the slide

def level_image(base: np.ndarray, base_power: float, power: float) -> np.ndarray:
    """The slide at `power`: its nearest-neighbour resample of the base."""
    scale = power / base_power
    bh, bw = base.shape[:2]
    h, w = int(round(bh * scale)), int(round(bw * scale))
    if (h, w) == (bh, bw):
        return base
    ys = np.clip((np.arange(h) * bh / h).astype(int), 0, bh - 1)
    xs = np.clip((np.arange(w) * bw / w).astype(int), 0, bw - 1)
    return base[np.ix_(ys, xs)]


def read_rect(img: np.ndarray, y: int, x: int, h: int, w: int) -> np.ndarray:
    """An (h, w) window of a level image; outside the image is white."""
    out = np.full((h, w, 3), 255, np.uint8)
    ys, xs = max(y, 0), max(x, 0)
    ye, xe = min(y + h, img.shape[0]), min(x + w, img.shape[1])
    if ye > ys and xe > xs:
        out[ys - y: ye - y, xs - x: xe - x] = img[ys:ye, xs:xe]
    return out


def otsu_mask(img: np.ndarray) -> np.ndarray:
    """Tissue = darker than the Otsu threshold of the luma (ITU-R 601
    weights 0.2125, 0.7154, 0.0721), over a 256-bin histogram between the
    image's extremes, splits with an empty class excluded."""
    g = (img[..., 0].astype(np.float64) * 0.2125 + img[..., 1] * 0.7154
         + img[..., 2] * 0.0721)
    lo, hi = float(g.min()), float(g.max())
    if lo == hi:
        return g < lo
    hist, edges = np.histogram(g.ravel(), bins=256, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2.0
    hist = hist.astype(np.float64)
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m = np.cumsum(hist * centers)
    mu0 = m / np.maximum(w0, 1e-12)
    mu1 = (m[-1] - m) / np.maximum(w1, 1e-12)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between[(w0 == 0) | (w1 == 0)] = -1
    return g < centers[int(np.argmax(between))]


def tissue_plan(base: np.ndarray, base_power: float, power: float,
                patch: int = 256, threshold: float = 0.1,
                downscale: int = 4) -> Tuple[int, int, np.ndarray]:
    """(grid rows, grid cols, (n, 2) tissue cells in row-major order) of
    one magnification."""
    scale = power / base_power
    h = int(round(base.shape[0] * scale))
    w = int(round(base.shape[1] * scale))
    rows, cols = -(-h // patch) * patch, -(-w // patch) * patch
    n_rows, n_cols = rows // patch, cols // patch
    low = level_image(base, base_power, power / downscale)
    mask = otsu_mask(read_rect(low, 0, 0, rows // downscale, cols // downscale))
    cell = patch // downscale
    cells = np.zeros((n_rows, n_cols))
    for r in range(n_rows):
        for c in range(n_cols):
            part = mask[r * cell: (r + 1) * cell, c * cell: (c + 1) * cell]
            cells[r, c] = part.mean() if part.size else 0.0
    return n_rows, n_cols, np.argwhere(cells > threshold)


def patches(img: np.ndarray, cells: np.ndarray, patch: int = 256) -> np.ndarray:
    """(n, patch, patch, 3) uint8: the pixels of each cell of a level."""
    return np.stack([read_rect(img, int(r) * patch, int(c) * patch, patch, patch)
                     for r, c in cells])


# ------------------------------------------------------------ the transform

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased bicubic resize (Keys, a = -0.5): output i
    samples the input at (i + 0.5) n_in / n_out - 0.5, the kernel widened
    by n_in / n_out when shrinking, rows normalised to sum 1."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in)[None, :])
    wgt = _keys_cubic(x / width)
    return wgt / wgt.sum(axis=1, keepdims=True)


def transform(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, P, P, 3) uint8 -> (B, size, size, 3) normalised, in the type of
    the computation (float32 unless the caller asks for more)."""
    x = images.to(torch.float64) / 255.0
    p = images.shape[1]
    if p != size:
        m = torch.from_numpy(resize_matrix(p, size)).to(x.device)
        x = torch.einsum("oh,bhwc->bowc", m, x)
        x = torch.einsum("pw,bhwc->bhpc", m, x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


# ------------------------------------------------------------ the ViT

def vit_specs(dims: dict) -> Dict[str, tuple]:
    """name -> (shape, init): every weight of the encoder, Linear weights
    stored (out, in) as timm's state dict holds them; "trunc" weights are
    truncated normals of std 0.02, "bias" normals of std 0.02, "scale"
    LayerNorm scales near 1, "layerscale" LayerScale factors in [0.25, 1]."""
    d, p, depth = dims["embed_dim"], dims["patch_size"], dims["depth"]
    hidden = int(d * dims["mlp_ratio"])
    n = (dims["img_size"] // p) ** 2 + 1
    specs = {"patch_embed/w": ((d, p * p * 3), "trunc"),
             "patch_embed/b": ((d,), "bias"),
             "cls_token": ((d,), "trunc"), "pos_embed": ((n, d), "trunc"),
             "norm/scale": ((d,), "scale"), "norm/bias": ((d,), "bias")}
    for i in range(depth):
        b = f"blocks/{i}"
        specs.update({
            f"{b}/norm1/scale": ((d,), "scale"), f"{b}/norm1/bias": ((d,), "bias"),
            f"{b}/qkv/w": ((3 * d, d), "trunc"), f"{b}/qkv/b": ((3 * d,), "bias"),
            f"{b}/proj/w": ((d, d), "trunc"), f"{b}/proj/b": ((d,), "bias"),
            f"{b}/ls1": ((d,), "layerscale"),
            f"{b}/norm2/scale": ((d,), "scale"), f"{b}/norm2/bias": ((d,), "bias"),
            f"{b}/fc1/w": ((hidden, d), "trunc"), f"{b}/fc1/b": ((hidden,), "bias"),
            f"{b}/fc2/w": ((d, hidden), "trunc"), f"{b}/fc2/b": ((d,), "bias"),
            f"{b}/ls2": ((d,), "layerscale")})
    return specs


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude at e4m3's largest, 448), back in t's type."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def vit_forward(w: Dict[str, torch.Tensor], dims: dict, x: torch.Tensor,
                products: str = "exact") -> torch.Tensor:
    """(B, S, S, 3) transformed images -> (B, d) class-token features, in
    x's type (weights cast to it). `products` "fp8" rounds both operands of
    every projection (patch embedding, qkv, proj, fc1, fc2) to float8 e4m3
    first: the reference one precision below bf16."""
    dt = x.dtype
    rnd = fp8 if products == "fp8" else (lambda t: t)
    d, p, heads = dims["embed_dim"], dims["patch_size"], dims["num_heads"]
    hd = d // heads
    b, s = x.shape[0], x.shape[1]
    g = s // p

    def W(name):
        return w[name].to(dt)

    def proj(y, name):
        return rnd(y) @ rnd(W(f"{name}/w")).T + W(f"{name}/b")

    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, -1)
    x = proj(x, "patch_embed")
    x = torch.cat([W("cls_token").expand(b, 1, d), x], dim=1) + W("pos_embed")
    n = x.shape[1]

    def ln(name, y):
        return F.layer_norm(y, (d,), W(f"{name}/scale"), W(f"{name}/bias"), 1e-6)

    for i in range(dims["depth"]):
        pre = f"blocks/{i}"
        y = ln(f"{pre}/norm1", x)
        qkv = proj(y, f"{pre}/qkv").reshape(b, n, 3, heads, hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(b, n, d)
        x = x + proj(o, f"{pre}/proj") * W(f"{pre}/ls1")
        y = ln(f"{pre}/norm2", x)
        hmid = F.gelu(proj(y, f"{pre}/fc1"))
        x = x + proj(hmid, f"{pre}/fc2") * W(f"{pre}/ls2")
    return ln("norm", x)[:, 0]
