"""Tissue segmentation and patch grids: the slide preprocessing step
(PyTorch port of ``moc_tpu/data/segment.py``; numpy and ``scipy.ndimage``
on the host).

CLAM's ``segmentTissue`` recipe (HSV saturation, median blur, an Otsu or
fixed threshold, a morphological close, area-filtered tissue regions with
per-region holes) on masks: connected components stand in for cv2's
contours, and the patch filter samples CLAM's check points (top-left,
centre, four shifted points; ``data.regions.contour_check``'s modes) on the
rasterised tissue mask.

Area thresholds (``a_t`` tissue, ``a_h`` hole) are in units of 512 x 512
level-0 patches, CLAM's ``ref_patch_size`` scaling, so its defaults
(``a_t=100``, ``a_h=16``) carry over. Masks and coordinates are bit-equal
to the JAX package's.

``save_patch_coords`` writes CLAM's patch schema as ``.h5`` (h5py) or, on
hosts without h5py, as ``.npz`` with the same array names, the attributes
stored as 0-d arrays beside them; ``data.patches`` reads either.
"""

from __future__ import annotations

import dataclasses

import numpy as np

REF_PATCH_SIZE = 512  # CLAM's area-unit reference patch (level 0)


def rgb_to_saturation(rgb: np.ndarray) -> np.ndarray:
    """HSV saturation channel of an ``[H, W, 3]`` uint8/float RGB image,
    scaled to 0..255 (the channel CLAM thresholds on)."""
    x = np.asarray(rgb, np.float32)
    mx = x.max(axis=-1)
    mn = x.min(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        # (mx-mn)/mx is scale-invariant: uint8 and [0,1]-float inputs agree
        s = np.where(mx > 0, (mx - mn) / mx, 0.0)
    return (s * 255.0).astype(np.float32)


def otsu_threshold(img: np.ndarray) -> float:
    """Otsu's between-class-variance threshold over a 256-bin histogram
    (values are clipped to 0..255 first). Returns the threshold value;
    foreground is ``img > threshold``."""
    h, _ = np.histogram(np.clip(np.asarray(img, np.float32), 0, 255),
                        bins=256, range=(0, 256))
    h = h.astype(np.float64)
    total = h.sum()
    if total == 0:
        return 0.0
    p = h / total
    omega = np.cumsum(p)
    mu = np.cumsum(p * np.arange(256))
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = (mu_t * omega - mu) ** 2 / (omega * (1.0 - omega))
    sigma_b[~np.isfinite(sigma_b)] = -1.0
    return float(np.argmax(sigma_b))


@dataclasses.dataclass
class TissueSegmentation:
    """A tissue mask at segmentation scale.

    ``mask [h, w]`` bool (True = tissue, big holes excluded); ``scale`` =
    level-0 pixels per mask pixel; ``n_regions`` tissue components kept.
    """

    mask: np.ndarray
    scale: float
    n_regions: int

    def tissue_fraction(self) -> float:
        return float(self.mask.mean()) if self.mask.size else 0.0


def segment_tissue(thumb_rgb: np.ndarray, scale: float, *,
                   sthresh: float = 8, mthresh: int = 7, close: int = 4,
                   use_otsu: bool = False, a_t: float = 100.0,
                   a_h: float = 16.0, max_n_holes: int = 8,
                   exclude_borders: bool = False) -> TissueSegmentation:
    """Segment tissue on a downsampled thumbnail (CLAM ``segmentTissue``).

    ``thumb_rgb [h, w, 3]`` uint8; ``scale`` = level-0 pixels per thumbnail
    pixel. ``a_t``/``a_h`` are minimum region/hole areas in units of
    512×512 level-0 patches. Holes smaller than ``a_h`` (and beyond the
    ``max_n_holes`` largest per region) are filled — they count as tissue,
    matching CLAM's dropped-hole semantics.
    """
    from scipy import ndimage

    sat = rgb_to_saturation(thumb_rgb)
    if mthresh and mthresh > 1:
        sat = ndimage.median_filter(sat, size=mthresh)
    thr = otsu_threshold(sat) if use_otsu else float(sthresh)
    mask = sat > thr
    if close and close > 0:
        structure = np.ones((close, close), bool)
        mask = ndimage.binary_closing(mask, structure=structure)
    if exclude_borders:  # drop components touching the thumbnail edge
        labels, _ = ndimage.label(mask)
        border_ids = np.unique(np.concatenate([
            labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
        mask &= ~np.isin(labels, border_ids[border_ids > 0])

    # area unit: one 512x512 level-0 patch, in mask pixels
    unit = (REF_PATCH_SIZE / float(scale)) ** 2
    min_tissue_px = a_t * unit
    min_hole_px = a_h * unit

    labels, n = ndimage.label(mask)
    if n == 0:
        return TissueSegmentation(np.zeros_like(mask), scale, 0)
    areas = ndimage.sum_labels(mask, labels, index=np.arange(1, n + 1))
    keep_ids = np.flatnonzero(areas >= min_tissue_px) + 1
    out = np.zeros_like(mask)
    kept = 0
    for rid in keep_ids:
        comp = labels == rid
        filled = ndimage.binary_fill_holes(comp)
        holes = filled & ~comp
        hlabels, hn = ndimage.label(holes)
        keep_holes = np.zeros_like(comp)
        if hn:
            hareas = ndimage.sum_labels(
                holes, hlabels, index=np.arange(1, hn + 1))
            big = np.flatnonzero(hareas >= min_hole_px) + 1
            if len(big) > max_n_holes:  # keep the largest max_n_holes
                order = np.argsort(-hareas[big - 1])
                big = big[order[:max_n_holes]]
            if len(big):
                keep_holes = np.isin(hlabels, big)
        out |= filled & ~keep_holes
        kept += 1
    return TissueSegmentation(out, scale, kept)


def _sample_mask(seg: TissueSegmentation, points: np.ndarray) -> np.ndarray:
    """Tissue test of level-0 ``points [N, 2]`` (x, y) against the mask;
    points outside the mask raster are non-tissue."""
    px = np.floor(points[:, 0] / seg.scale).astype(np.int64)
    py = np.floor(points[:, 1] / seg.scale).astype(np.int64)
    h, w = seg.mask.shape
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    out = np.zeros(len(points), bool)
    out[ok] = seg.mask[py[ok], px[ok]]
    return out


def segmented_grid(seg: TissueSegmentation, patch_size: int,
                   step_size: int | None = None,
                   contour_fn: str = "four_pt_hard",
                   center_shift: float = 0.5) -> np.ndarray:
    """Level-0 top-left patch coords on tissue (CLAM ``process_contours``).

    Grids each tissue region's bounding box and keeps patches whose check
    points (``data/regions.contour_check`` modes, rasterized) hit the mask:
    ``basic`` = top-left corner, ``center`` = patch center, ``four_pt_easy``
    = center or any shifted point, ``four_pt_hard`` = center and all four
    points shifted by ``center_shift·patch_size/2``.
    """
    from scipy import ndimage

    from moc_tpu_torch.data.regions import grid_coords

    step = step_size or patch_size
    labels, n = ndimage.label(seg.mask)
    if n == 0:
        return np.zeros((0, 2), np.int64)
    slices = ndimage.find_objects(labels)
    out = []
    for sl in slices:
        if sl is None:
            continue
        ys, xs = sl
        tl = (int(xs.start * seg.scale), int(ys.start * seg.scale))
        br = (int(np.ceil(xs.stop * seg.scale)),
              int(np.ceil(ys.stop * seg.scale)))
        grid = grid_coords(tl, br, patch_size, step)
        if not len(grid):
            continue
        center = grid + patch_size / 2.0
        if contour_fn == "basic":
            ok = _sample_mask(seg, grid)
        elif contour_fn == "center" or center_shift == 0.0:
            ok = _sample_mask(seg, center)
        elif contour_fn in ("four_pt_easy", "four_pt_hard"):
            shift = center_shift * patch_size / 2.0
            offs = np.array([[-shift, -shift], [-shift, shift],
                             [shift, -shift], [shift, shift]])
            inside = np.stack([_sample_mask(seg, center + o) for o in offs])
            c = _sample_mask(seg, center)
            ok = ((inside.any(axis=0) | c) if contour_fn == "four_pt_easy"
                  else (inside.all(axis=0) & c))
        else:
            raise ValueError(f"unknown contour_fn {contour_fn!r}")
        if ok.any():
            out.append(grid[ok])
    if not out:
        return np.zeros((0, 2), np.int64)
    coords = np.concatenate(out, axis=0)
    # regions' bounding boxes can overlap → dedup (stable order)
    _, idx = np.unique(coords, axis=0, return_index=True)
    return coords[np.sort(idx)]


def h5_available() -> bool:
    """Whether h5py imports here (the card's host has none)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def coords_ext() -> str:
    """The patch-file extension this host writes: ``.h5`` with h5py, else
    ``.npz``."""
    return ".h5" if h5_available() else ".npz"


def _npy_header(f, shape, dtype) -> None:
    np.lib.format.write_array_header_1_0(f, {"descr": np.lib.format.dtype_to_descr(
        np.dtype(dtype)), "fortran_order": False, "shape": tuple(shape)})


def save_patch_coords(path: str, coords: np.ndarray, *, patch_size: int,
                      patch_level: int = 0, downsample: float = 1.0,
                      name: str = "", imgs=None, n_imgs: int | None = None,
                      img_size: int | None = None) -> None:
    """Write a CLAM-schema patch file: ``coords [N, 2]`` (int64) with the
    attributes CLAM stamps (``patch_size``, ``patch_level``, ``downsample``,
    ``name``), readable by ``data.patches.CoordPatchReader``. ``imgs`` adds
    the pixel patches (``PatchBagReader``'s schema): an ``[N, S, S, 3]``
    array, or an iterable of ``n_imgs`` uint8 ``[img_size, img_size, 3]``
    patches written one at a time (a 10k-patch slide at 256 px is ~2 GB,
    never held whole). ``path`` ends in ``.h5`` (needs h5py) or ``.npz``,
    or in ``.tmp`` after either (written under that name, for an atomic
    rename)."""
    coords = np.asarray(coords, np.int64)
    attrs = dict(patch_size=patch_size, patch_level=patch_level,
                 downsample=downsample, name=name)
    stem = path[:-4] if path.endswith(".tmp") else path
    stream = imgs is not None and not isinstance(imgs, np.ndarray)
    if stem.endswith(".h5"):
        import h5py

        with h5py.File(path, "w") as f:
            d = f.create_dataset("coords", data=coords)
            for k, v in attrs.items():
                d.attrs[k] = v
            if stream:
                s = img_size
                d = f.create_dataset("imgs", shape=(n_imgs, s, s, 3), dtype=np.uint8,
                                     chunks=(min(64, n_imgs), s, s, 3))
                for i, img in enumerate(imgs):
                    d[i] = img
            elif imgs is not None:
                f.create_dataset("imgs", data=np.asarray(imgs))
        return
    if not stem.endswith(".npz"):
        raise ValueError(f"patch files end in .h5 or .npz, got {path!r}")
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        arrays = {"coords": coords, **{k: np.asarray(v) for k, v in attrs.items()}}
        if imgs is not None and not stream:
            arrays["imgs"] = np.asarray(imgs)
        for key, arr in arrays.items():
            with z.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
        if stream:
            with z.open("imgs.npy", "w", force_zip64=True) as f:
                _npy_header(f, (n_imgs, img_size, img_size, 3), np.uint8)
                for img in imgs:
                    f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def read_patch_coords(path: str) -> tuple[np.ndarray, dict]:
    """``(coords [N, 2] int64, attrs)`` of a file ``save_patch_coords``
    wrote, ``.h5`` or ``.npz``."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            attrs = {k: z[k][()] for k in ("patch_size", "patch_level", "downsample", "name")
                     if k in z}
            return np.asarray(z["coords"]), {k: (str(v) if isinstance(v, str) else v)
                                             for k, v in attrs.items()}
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["coords"][:]), dict(f["coords"].attrs)
