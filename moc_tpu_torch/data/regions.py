"""Patch grids over slide regions with tissue-contour filtering (PyTorch
port of ``moc_tpu/data/regions.py``, numpy on the host).

* the contour checks (``basic``, ``center``, ``four_pt_easy``,
  ``four_pt_hard``: CLAM's ``isInContourV1/V2/V3_Easy/V3_Hard``) are
  vectorised even-odd point-in-polygon tests over the whole grid at once;
* slide access is a caller's ``reader(coord, size)`` at the grid's own level,
  so the module works on arrays and test fixtures without slide libraries;
* ``RegionGrid.read_batches`` yields the normalised patches as torch tensors
  on the caller's device.

Grids and checks are bit-equal to the JAX package's on identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

# ImageNet normalisation of CLAM's default transforms.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_patches(patches: np.ndarray) -> np.ndarray:
    """uint8/float [*, H, W, 3] → float32, scaled to [0,1] and
    ImageNet-normalized (ref ``default_transforms``)."""
    x = np.asarray(patches, np.float32)
    if patches.dtype == np.uint8:
        x = x / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized even-odd (ray-casting) point-in-polygon test.

    ``points [N, 2]``, ``polygon [K, 2]`` → bool ``[N]``. Points exactly on
    an edge may land either way (the reference's cv2 test counts boundary as
    inside; grids that care should inset by epsilon).
    """
    pts = np.asarray(points, np.float64)
    poly = np.asarray(polygon, np.float64)
    x, y = pts[:, 0, None], pts[:, 1, None]  # [N, 1]
    x0, y0 = poly[:, 0], poly[:, 1]  # [K]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    # edge straddles the horizontal ray through y
    straddle = (y0 <= y) != (y1 <= y)  # [N, K]
    with np.errstate(divide="ignore", invalid="ignore"):
        x_cross = x0 + (y - y0) * (x1 - x0) / np.where(y1 == y0, np.inf, y1 - y0)
    return (np.sum(straddle & (x < x_cross), axis=1) % 2).astype(bool)


def _check_points(points, polygon, holes):
    ok = points_in_polygon(points, polygon)
    for hole in holes or ():
        ok &= ~points_in_polygon(points, hole)
    return ok


def contour_check(
    coords: np.ndarray,
    polygon: np.ndarray,
    patch_size: int,
    mode: str = "four_pt_hard",
    center_shift: float = 0.0,
    holes: Sequence[np.ndarray] | None = None,
) -> np.ndarray:
    """Which top-left patch ``coords [N, 2]`` pass the tissue check.

    Modes mirror CLAM's checkers (ref ``wsi_dataset.py:18-29``):
      * ``basic``        — the top-left corner itself inside the contour;
      * ``center``       — the patch center inside;
      * ``four_pt_easy`` — center OR any of 4 points shifted by
        ``center_shift·patch_size/2`` inside;
      * ``four_pt_hard`` — center AND all 4 shifted points inside
        (``center_shift == 0`` degrades both four_pt modes to ``center``).
    Holes subtract from every test.
    """
    coords = np.asarray(coords, np.float64)
    if mode == "basic":
        return _check_points(coords, polygon, holes)
    center = coords + patch_size / 2.0
    if mode == "center" or center_shift == 0.0:
        return _check_points(center, polygon, holes)
    if mode not in ("four_pt_easy", "four_pt_hard"):
        raise ValueError(f"unknown contour mode: {mode!r}")
    shift = center_shift * patch_size / 2.0
    offsets = np.array(
        [[-shift, -shift], [-shift, shift], [shift, -shift], [shift, shift]])
    inside = np.stack([_check_points(center + off, polygon, holes)
                       for off in offsets])
    if mode == "four_pt_easy":
        return inside.any(axis=0) | _check_points(center, polygon, holes)
    return inside.all(axis=0) & _check_points(center, polygon, holes)


def _auto_center_shift(step: int, patch: int) -> float:
    """Overlap-adaptive shift (ref ``wsi_dataset.py:77-91``)."""
    overlap = 1.0 - float(step) / float(patch)
    if overlap < 0.25:
        return 0.375
    if overlap < 0.95:
        return 0.5
    return 0.625


def grid_coords(top_left, bot_right, patch_size: int, step_size: int,
                use_padding: bool = True) -> np.ndarray:
    """Top-left patch coordinates of a regular grid over a bounding box.

    ``use_padding`` keeps patches whose far edge overhangs ``bot_right``
    (the reference always passes ``use_padding=True`` —
    ``wsi_dataset.py:98``).
    """
    x0, y0 = int(top_left[0]), int(top_left[1])
    x1, y1 = int(bot_right[0]), int(bot_right[1])
    stop_x = x1 if use_padding else x1 - patch_size + 1
    stop_y = y1 if use_padding else y1 - patch_size + 1
    xs = np.arange(x0, max(stop_x, x0 + 1), step_size, dtype=np.int64)
    ys = np.arange(y0, max(stop_y, y0 + 1), step_size, dtype=np.int64)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


@dataclasses.dataclass
class RegionGrid:
    """Contour-filtered patch grid over a WSI region (``Wsi_Region`` rebuilt).

    Parameters mirror the reference (level-0 coordinate space; downsample
    scaling is the caller's reader concern): ``contours`` are level-0 tissue
    polygons with per-contour ``holes``; ``custom_downsample > 1`` reads at
    ``patch_size × custom_downsample`` and lets ``read_batches`` downscale to
    ``patch_size`` (ref ``wsi_dataset.py:62-68,117-120``).
    """

    contours: Sequence[np.ndarray]
    patch_size: int = 256
    step_size: int = 256
    holes: Sequence[Sequence[np.ndarray]] | None = None
    top_left: tuple[int, int] | None = None
    bot_right: tuple[int, int] | None = None
    contour_fn: str = "four_pt_hard"
    custom_downsample: int = 1
    use_center_shift: bool = False

    def __post_init__(self):
        read_size = self.patch_size * self.custom_downsample
        step = self.step_size * self.custom_downsample
        shift = (_auto_center_shift(step, read_size)
                 if self.use_center_shift else 0.0)
        kept = []
        for i, cont in enumerate(self.contours):
            cont = np.asarray(cont)
            tl = self.top_left if self.top_left is not None else cont.min(axis=0)
            br = self.bot_right if self.bot_right is not None else cont.max(axis=0)
            grid = grid_coords(tl, br, read_size, step)
            ok = contour_check(
                grid, cont, read_size, self.contour_fn, shift,
                holes=self.holes[i] if self.holes else None)
            if ok.any():
                kept.append(grid[ok])
        self.coords = (np.concatenate(kept, axis=0) if kept
                       else np.zeros((0, 2), np.int64))
        self.read_size = read_size

    def __len__(self) -> int:
        return len(self.coords)

    def read_batches(
        self,
        reader: Callable[[tuple[int, int], int], np.ndarray],
        batch_size: int = 64,
        normalize: bool = True,
        device: str | torch.device = "cpu",
    ) -> Iterator[tuple[torch.Tensor, np.ndarray]]:
        """Yield ``(patches [B, H, W, 3] float32 on device, coords [B, 2])``.

        ``reader(coord, size)`` returns one ``[size, size, 3]`` patch.
        ``custom_downsample`` patches are mean-pooled down to ``patch_size``
        on the host (linear, so before the scaling), as the JAX package
        does; the normalised stack is then copied to ``device``."""
        d = self.custom_downsample
        p = self.patch_size
        for start in range(0, len(self.coords), batch_size):
            coords = self.coords[start:start + batch_size]
            patches = np.stack([
                np.asarray(reader((int(c[0]), int(c[1])), self.read_size))
                for c in coords])
            was_uint8 = patches.dtype == np.uint8
            patches = patches.astype(np.float32)
            if d > 1:
                patches = patches.reshape(len(coords), p, d, p, d, -1).mean((2, 4))
            if normalize:
                if was_uint8:
                    patches = patches / 255.0
                patches = (patches - IMAGENET_MEAN) / IMAGENET_STD
            yield torch.from_numpy(np.ascontiguousarray(patches)).to(device), coords
