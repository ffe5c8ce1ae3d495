"""Importance heatmaps (counterpart of `paths_tpu.viz.heatmap`).

`run_recursion` runs the hierarchical model over a raw slide, encoding each
depth's bag on the fly, and `heatmap_slide` renders the slide beside a
heatmap in which every visited patch is outlined and its importance painted
into a per-depth canvas; deeper levels fold into their parents with weight
0.5 per depth; a viridis overlay at alpha 0.5 over the visited area; a
viewport that leaves out the top and bottom 10% of the level-0 patches; an
inset colorbar; a PDF out. CAMELYON17 annotation polygons are drawn on the
left panel when given. `recursion_from_store` / `heatmap_from_store` do the
same for a slide of a feature store (no raw slide or encoder).

The model runs eagerly under `torch.inference_mode()`; each depth's bag is
padded to a power-of-two width (at least 32), so the kernels see few shapes
and the results match the JAX package's, which pads the same way so that it
compiles few programs. matplotlib is imported by the rendering functions
only; on a host without it they run the recursion, draw nothing and return
None.
"""
from __future__ import annotations

import os
import types
import xml.etree.ElementTree as ET
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from paths_tpu_torch.config import Config
from paths_tpu_torch.data.dataset import SlideDataset, collate_batch
from paths_tpu_torch.data.feature_store import FeatureStore
from paths_tpu_torch.data.raw_slide import encode_bag, load_raw_slide
from paths_tpu_torch.engine.hierarchy import end2end_forward
from paths_tpu_torch.models.batch import pad_bag
from paths_tpu_torch.models.recursive import RecursiveModel, recursive_apply


def parse_camelyon17_anno_file(path: str) -> List[Tuple[list, str]]:
    """CAMELYON17 annotation XML -> [(polygon coords, color)]."""
    assert os.path.isfile(path), f"Couldn't find annotation file at '{path}'."
    root = ET.parse(path).getroot()

    group = root.find(".//Group")
    if group is not None and group.get("Name") != "Tumor":
        raise ValueError(f"Unexpected group name: {group.get('Name')}")

    polygons = []
    for annotation in root.findall(".//Annotation"):
        if annotation.get("Type") != "Polygon":
            raise ValueError(
                f"Unexpected annotation type: {annotation.get('Type')}")
        coords = [(float(c.get("X")), float(c.get("Y")))
                  for c in annotation.find("Coordinates")]
        polygons.append((coords, annotation.get("Color")))
    return polygons


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def run_recursion(config: Config, model: RecursiveModel, encode_fn: Callable,
                  slide_path: str, tissue_threshold: float = 0.025,
                  camelyon: bool = True, default_power: float = 40.0,
                  verbose: bool = True, device="cuda"):
    """Hierarchical inference on a raw slide; returns (slides per depth,
    importances per depth, final logits). `model` lives on `device`, where
    `encode_fn` encodes (B, H, W, 3) [0, 1] float images."""
    mc = config.model_config
    slide = load_raw_slide(slide_path, config.base_power, mc.patch_size,
                           mc.ctx_dim(), prepatch=False,
                           tissue_threshold=tissue_threshold,
                           camelyon=camelyon, default_power=default_power)
    slide.load_patches()

    slide_depths = [slide]
    imps = []
    out = None
    with torch.inference_mode():
        for depth in range(config.num_levels):
            if verbose:
                print(f" Depth {depth + 1} / {config.num_levels}...")
            bag = encode_bag(slide, encode_fn, device=device)
            n = bag.fts.shape[1]
            out = recursive_apply(model, config, depth,
                                  pad_bag(bag, _pow2_width(n)))
            importance = _numpy(out["importance"][0])[:n]
            imps.append(importance)
            if depth != config.num_levels - 1:
                slide = slide.recurse(
                    config.magnification_factor, _numpy(out["ctx_slide"][0]),
                    _numpy(out["ctx_patch"][0])[:n], importance,
                    config.top_k_patches[depth])
                slide.load_patches()
                slide_depths.append(slide)
    return slide_depths, imps, _numpy(out["logits"])


def _pow2_width(n: int, floor: int = 32) -> int:
    w = floor
    while w < n:
        w *= 2
    return w


# The reference figure's look: geometry, outline weight, overlay opacity and
# fold factor.
FIGSIZE = (6, 3.4)
OUTLINE_LW = 0.5
OVERLAY_ALPHA = 0.5
FOLD_WEIGHT = 0.5          # child level importance contribution to parent
VISITED_EPS = 1e-4         # marks visited patches even at zero importance
VIEWPORT_TRIM = 0.1        # drop patches in the outer 10% bands vertically
VIEWPORT_PAD = 128


def _depth0_cells(slide, depth: int, patch_size: int):
    """Visited-patch geometry in the depth-0 (coarsest) pixel frame: a patch
    at depth d is one cell of a (patch_size >> d) grid. Returns (rows, cols,
    size)."""
    size = max(patch_size >> depth, 1)
    locs = np.asarray(slide.locs, np.int64)
    return locs[:, 0] // patch_size, locs[:, 1] // patch_size, size


def folded_importance(slide_depths, imps, patch_size: int,
                      shape) -> np.ndarray:
    """(H, W) map in the depth-0 frame: each level's importance is painted
    over its visited patches (scattered into a coarse cell grid and
    upsampled), then child levels fold into their parents with FOLD_WEIGHT
    per depth."""
    H, W = shape
    levels = []
    for depth, (slide, imp) in enumerate(zip(slide_depths, imps)):
        rows, cols, size = _depth0_cells(slide, depth, patch_size)
        gh, gw = -(-H // size), -(-W // size)
        cells = np.zeros((gh, gw))
        # negative locs (slide edges after recursion) are dropped, not
        # wrapped to the far edge
        keep = (rows >= 0) & (cols >= 0) & (rows < gh) & (cols < gw)
        cells[rows[keep], cols[keep]] = imp[: len(rows)][keep] + VISITED_EPS
        levels.append(np.repeat(np.repeat(cells, size, 0), size, 1)[:H, :W])

    acc = levels[-1]
    for parent in levels[-2::-1]:
        visited_child = acc != 0
        acc = np.where(visited_child, parent + acc * FOLD_WEIGHT, parent)
    return acc


def _outline_collection(slide_depths, patch_size: int):
    """One matplotlib collection outlining every visited patch at every
    depth."""
    from matplotlib.collections import PatchCollection
    from matplotlib.patches import Rectangle

    rects = []
    for depth, slide in enumerate(slide_depths):
        rows, cols, size = _depth0_cells(slide, depth, patch_size)
        keep = (rows >= 0) & (cols >= 0)
        rects.extend(Rectangle((x * size, y * size), size, size)
                     for y, x in zip(rows[keep], cols[keep]))
    return PatchCollection(rects, facecolor="none", edgecolor="black",
                           lw=OUTLINE_LW)


def _viewport_ylim(slide, patch_size: int, height: int):
    """(bottom, top) y-limits framing the level-0 patches, leaving out those
    whose centres fall in the outer VIEWPORT_TRIM bands."""
    ys = np.asarray(slide.locs, np.int64)[:, 0]
    frac = (ys + patch_size / 2) / height
    inner = ys[(frac > VIEWPORT_TRIM) & (frac < 1 - VIEWPORT_TRIM)]
    if inner.size == 0:
        inner = ys
    return (int(inner.max()) + VIEWPORT_PAD + patch_size,
            int(inner.min()) - VIEWPORT_PAD)


def _pyplot(show: bool):
    """pyplot; None on a host without matplotlib unless a window is asked
    for (the figure is then not drawn)."""
    try:
        import matplotlib
    except ImportError:
        if show:
            raise
        return None
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _not_drawn(imps) -> None:
    print(f"figure not drawn: matplotlib is not installed on this host; the "
          f"recursion ran ({[len(i) for i in imps]} patches per depth)",
          flush=True)


def _make_out_dir(out_path: Optional[str]) -> None:
    if out_path is not None:
        directory = os.path.dirname(out_path)
        if directory and not os.path.isdir(directory):
            os.makedirs(directory, exist_ok=True)


def _paint(ax, slide_depths, imps, patch_size: int, shape):
    """Outlines and the folded-importance overlay on `ax`; returns the
    overlay's image."""
    ax.add_collection(_outline_collection(slide_depths, patch_size))
    heat = folded_importance(slide_depths, imps, patch_size, shape)
    alpha = np.where(heat > 0, OVERLAY_ALPHA, 0.0)
    visited = heat > 0
    if visited.any():
        heat = np.where(visited, heat, heat[visited].min())
    return ax.imshow(heat, cmap="viridis", alpha=alpha, aspect="equal")


def _finish(plt, fig, ax, hm, right: float, out_path: Optional[str],
            show: bool) -> Optional[str]:
    """Inset colorbar, layout, save (a .pdf unless .png is asked) and
    close."""
    from mpl_toolkits.axes_grid1.inset_locator import inset_axes

    cax = inset_axes(ax, width="5%", height="100%", loc="right",
                     borderpad=-1.5)
    fig.colorbar(hm, cax=cax, orientation="vertical")
    fig.tight_layout()
    fig.subplots_adjust(right=right)
    if out_path is not None:
        if not (out_path.endswith(".pdf") or out_path.endswith(".png")):
            out_path += ".pdf"
        plt.savefig(out_path, dpi=200)
    if show:
        plt.show()
    plt.close(fig)
    return out_path


def heatmap_slide(config: Config, model: RecursiveModel, encode_fn: Callable,
                  slide_path: str, annotation_path: Optional[str],
                  out_path: Optional[str], tissue_threshold: float = 0.025,
                  camelyon: bool = True, default_power: float = 40.0,
                  show: bool = False, device="cuda"):
    """Render the two-panel heatmap: the slide with its annotation on the
    left; the slide with outlined visited patches, the folded-importance
    overlay and an inset colorbar on the right; one viewport for both.
    Returns the figure's path (None without matplotlib)."""
    plt = _pyplot(show)
    assert os.path.exists(slide_path), f"Couldn't find WSI at '{slide_path}'."
    _make_out_dir(out_path)

    P = config.model_config.patch_size
    slide_depths, imps, _ = run_recursion(
        config, model, encode_fn, slide_path, tissue_threshold, camelyon,
        default_power, device=device)
    if plt is None:
        return _not_drawn(imps)

    bigimg = slide_depths[0].view_at_power(config.base_power)
    H, W = bigimg.shape[:2]

    fig, (sax, ax) = plt.subplots(1, 2, figsize=FIGSIZE)
    for a in (sax, ax):
        a.imshow(bigimg, aspect="equal")
        a.set_xticks([])
        a.set_yticks([])

    if annotation_path is not None:
        scale = config.base_power / default_power
        for coords, _ in parse_camelyon17_anno_file(annotation_path):
            ring = np.asarray(coords + coords[:1]) * scale
            sax.plot(ring[:, 0], ring[:, 1], color="blue", linewidth=2)

    hm = _paint(ax, slide_depths, imps, P, (H, W))
    ylim = _viewport_ylim(slide_depths[0], P, H)
    sax.set_ylim(*ylim)
    ax.set_ylim(*ylim)
    return _finish(plt, fig, ax, hm, 0.9, out_path, show)


def recursion_from_store(config: Config, model: RecursiveModel,
                         slide_id: str, store: FeatureStore, device="cuda"):
    """The fused hierarchical forward over one slide of a feature store;
    returns (per-depth stand-ins for the painter, each with the `locs` of
    the bag's valid rows, per-depth importances of those rows)."""
    ds = SlideDataset([slide_id], config, store)
    bag0, tables = collate_batch(ds, [0], level0_bucket=config.level0_bucket,
                                 device=device)
    with torch.inference_mode():
        outs = end2end_forward(model, config, bag0, tables)
    slide_depths, imps = [], []
    for out in outs:
        valid = out["bag"].mask[0].cpu().numpy()
        slide_depths.append(types.SimpleNamespace(
            locs=out["bag"].locs[0].cpu().numpy()[valid]))
        imps.append(_numpy(out["importance"][0])[valid])
    return slide_depths, imps


def heatmap_from_store(config: Config, model: RecursiveModel, slide_id: str,
                       store: FeatureStore, out_path: Optional[str],
                       show: bool = False, device="cuda"):
    """Importance heatmap for a preprocessed slide: no raw WSI or encoder.
    One panel: a glass / tissue backdrop from the level-0 grid's occupancy,
    the outlines, the folded-importance overlay and the inset colorbar, with
    the raw-slide renderer's painter and fold."""
    plt = _pyplot(show)
    P = config.model_config.patch_size
    slide_depths, imps = recursion_from_store(config, model, slide_id, store,
                                              device)
    if plt is None:
        return _not_drawn(imps)

    grid0 = np.asarray(store.load(slide_id, config.base_power))
    tissue = np.abs(grid0).sum(-1) > 0
    backdrop = np.where(np.repeat(np.repeat(tissue, P, 0), P, 1),
                        222, 246).astype(np.uint8)
    H, W = backdrop.shape
    _make_out_dir(out_path)

    fig, ax = plt.subplots(figsize=(FIGSIZE[0] / 2, FIGSIZE[1]))
    ax.imshow(backdrop, cmap="gray", vmin=0, vmax=255, aspect="equal")
    ax.set_xticks([])
    ax.set_yticks([])
    hm = _paint(ax, slide_depths, imps, P, (H, W))
    ax.set_ylim(*_viewport_ylim(slide_depths[0], P, H))
    return _finish(plt, fig, ax, hm, 0.88, out_path, show)
