"""Top-k patch extraction and coordinate-grid rendering (PyTorch port of
``moc_tpu/viz/topk.py``; numpy on the host).

Per class the top-k patch coordinates of patch logits, class-coloured
rectangles and score heatmaps rasterised on the patch grid from the
coordinates alone, and raw-pixel crops through ``data.patches.open_slide``.
``slide_extent`` gives a slide's size from its coordinates where no slide
file is at hand. Rasters are byte-equal to the JAX package's for identical
maps.
"""

from __future__ import annotations

import numpy as np


def topk_patch_coords(patch_logits: np.ndarray, coords: np.ndarray,
                      k: int = 10) -> dict[int, np.ndarray]:
    """Per class: the coords of the k highest-scoring patches.

    ``patch_logits [N, C]``, ``coords [N, 2]`` → {class: [k, 2]}."""
    out = {}
    n, c = patch_logits.shape
    kk = min(k, n)
    for cls in range(c):
        idx = np.argsort(-patch_logits[:, cls], kind="stable")[:kk]
        out[cls] = coords[idx]
    return out


def slide_extent(coords: np.ndarray, patch_size: int = 256,
                 wsi_path: str | None = None) -> tuple[int, int]:
    """(width, height) of the slide: OpenSlide dims when available, else the
    coord extent + one patch (ref ``utils/wsi_size.py``)."""
    if wsi_path is not None:
        from moc_tpu_torch.data.patches import open_slide

        try:
            return open_slide(wsi_path).dimensions
        except Exception:  # unreadable format here (e.g. .svs sans
            pass  # OpenSlide): degrade to the coord extent, like the scan
    return (int(coords[:, 0].max()) + patch_size,
            int(coords[:, 1].max()) + patch_size)


def render_heatmap(patch_scores: np.ndarray, coords: np.ndarray,
                   patch_size: int = 256, downsample: int = 32) -> np.ndarray:
    """Rasterize per-patch scores onto the slide grid → float image
    ``[H, W]`` (NaN where no patch). The OpenSlide-free analogue of the
    reference's heatmap path (``model_chief.patch_probs`` consumers)."""
    w, h = slide_extent(coords, patch_size)
    gw, gh = w // downsample, h // downsample
    ps = max(patch_size // downsample, 1)
    img = np.full((gh, gw), np.nan, np.float32)
    for score, (x, y) in zip(patch_scores, coords):
        gx, gy = int(x) // downsample, int(y) // downsample
        img[gy : gy + ps, gx : gx + ps] = score
    return img


def render_topk_overlay(patch_logits: np.ndarray, coords: np.ndarray,
                        k: int = 10, patch_size: int = 256,
                        downsample: int = 32) -> np.ndarray:
    """Class-colored top-k rectangles on the slide grid → uint8 ``[H, W, 3]``
    (the thumbnail-rectangle rendering, ref lines 242-295, sans pixels)."""
    w, h = slide_extent(coords, patch_size)
    gw, gh = w // downsample, h // downsample
    ps = max(patch_size // downsample, 2)
    img = np.full((gh, gw, 3), 255, np.uint8)
    palette = np.array(
        [[214, 39, 40], [31, 119, 180], [44, 160, 44], [255, 127, 14],
         [148, 103, 189], [140, 86, 75]], np.uint8)
    # light gray footprint of every patch
    for x, y in coords:
        gx, gy = int(x) // downsample, int(y) // downsample
        img[gy : gy + ps, gx : gx + ps] = 230
    for cls, cls_coords in topk_patch_coords(patch_logits, coords, k).items():
        color = palette[cls % len(palette)]
        for x, y in cls_coords:
            gx, gy = int(x) // downsample, int(y) // downsample
            img[gy : gy + ps, gx : gx + 2] = color
            img[gy : gy + ps, gx + ps - 2 : gx + ps] = color
            img[gy : gy + 2, gx : gx + ps] = color
            img[gy + ps - 2 : gy + ps, gx : gx + ps] = color
    return img


def crop_patches(wsi_path: str, coords: np.ndarray, patch_size: int = 256,
                 level: int = 0) -> list[np.ndarray]:
    """Raw-pixel crops at ``coords`` through ``data.patches.slide_reader``
    (OpenSlide where it imports, PIL for plain images). A level above 0 is a
    pyramid level and needs OpenSlide: without it this raises ImportError
    by name, as ``data.patches.CoordPatchReader`` does."""
    from moc_tpu_torch.data.patches import slide_reader

    read = slide_reader(wsi_path, level)
    return [np.asarray(read((int(x), int(y)), patch_size)) for x, y in coords]
