"""Raw-pixel patch bags (PyTorch port of ``moc_tpu/data/patches.py``).

Two readers, as CLAM's datasets have them:

  * ``PatchBagReader`` (``Whole_Slide_Bag``): a patch bag holding one
    slide's patch images ``imgs [N, H, W, 3]`` (uint8) and optionally
    ``coords [N, 2]``;
  * ``CoordPatchReader`` (``Whole_Slide_Bag_FP``): a bag holding only
    ``coords``, whose pixels are read from the slide image at each
    coordinate (``open_slide``: OpenSlide where it imports and reads the
    file, else PIL for plain images; reads at level 0, crops past the edge
    zero-filled).

The container is an ``.h5`` file where h5py imports, or an ``.npz`` file
with the same array names on hosts without h5py; the schema is the same.
Reads are host-side numpy; each patch is preprocessed by the backbone's
transform (``transform``: ``clip`` for CONCH, ``plip``, ``musk``,
``imagenet`` for the ResNet-50; ``zeroshot.transform``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator

import numpy as np

from moc_tpu_torch.zeroshot.transform import (preprocess_image, preprocess_image_imagenet,
                                              preprocess_image_musk, preprocess_image_plip)

PATCH_BAG_EXTS = (".h5", ".npz")  # in order of preference for one slide
TRANSFORMS = {"clip": preprocess_image, "plip": preprocess_image_plip,
              "musk": preprocess_image_musk, "imagenet": preprocess_image_imagenet}


def _make_transform(kind: str, image_size: int):
    if kind not in TRANSFORMS:
        raise ValueError(f"unknown transform {kind!r} ({' | '.join(TRANSFORMS)})")
    fn = TRANSFORMS[kind]
    return lambda im: fn(im, image_size)


def _open_bag(path: str):
    """An ``.npz`` bag (read whole on first access) or an ``.h5`` one (read
    batch by batch)."""
    if path.endswith(".npz"):
        return np.load(path)
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"h5py is required for .h5 patch bags ({path}); "
                          "store the bag as .npz on such hosts") from e
    return h5py.File(path, "r")


@dataclasses.dataclass
class PatchBagReader:
    """Iterate the image patches of one slide from an ``imgs``-bearing
    ``.h5`` or ``.npz`` file."""

    path: str
    image_size: int = 224
    normalize: bool = True
    transform: str = "clip"  # clip | plip | musk | imagenet

    def _open(self):
        """``(file, imgs, coords)``."""
        f = _open_bag(self.path)
        coords = f["coords"][:] if "coords" in f else None
        return f, f["imgs"], coords

    def __len__(self) -> int:
        f, imgs, _ = self._open()
        with f:
            return len(imgs)

    def batches(self, batch_size: int = 64) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        f, imgs, coords = self._open()
        tf = _make_transform(self.transform, self.image_size)
        with f:
            for i in range(0, len(imgs), batch_size):
                chunk = np.asarray(imgs[i: i + batch_size])
                if self.normalize:
                    chunk = np.stack([tf(im) for im in chunk])
                yield chunk, (None if coords is None else np.asarray(coords[i: i + batch_size]))


class _PILSlide:
    """A plain image (PNG, JPEG, simple TIFF) read as a slide through PIL:
    level 0 only; a crop past the edge is zero-filled."""

    def __init__(self, path: str):
        from PIL import Image

        with Image.open(path) as im:
            self._im = im.convert("RGB")

    def read(self, coord: tuple[int, int], size: int) -> np.ndarray:
        x, y = int(coord[0]), int(coord[1])
        return np.asarray(self._im.crop((x, y, x + size, y + size)))


class _OpenSlide:
    """An OpenSlide slide with :class:`_PILSlide`'s surface."""

    def __init__(self, path: str):
        import openslide

        self._s = openslide.OpenSlide(path)

    def read(self, coord: tuple[int, int], size: int, level: int = 0) -> np.ndarray:
        region = self._s.read_region((int(coord[0]), int(coord[1])), level, (size, size))
        return np.asarray(region.convert("RGB"))


def open_slide(path: str):
    """A slide for pixel reads: OpenSlide where it imports and reads the
    file, else PIL. Both give ``read((x, y), size) -> [size, size, 3]``
    uint8 at level 0."""
    try:
        import openslide
    except ImportError:
        return _PILSlide(path)
    try:
        return _OpenSlide(path)
    except openslide.OpenSlideError:  # a plain image OpenSlide does not read
        return _PILSlide(path)


@dataclasses.dataclass
class CoordPatchReader:
    """Iterate one slide's patches read from ``wsi_path`` at the ``coords``
    of a coords-bearing ``.h5`` or ``.npz`` bag. ``level != 0`` is a pyramid
    level of a whole-slide format and needs OpenSlide."""

    path: str
    wsi_path: str
    patch_size: int = 256
    level: int = 0
    image_size: int = 224
    normalize: bool = True
    transform: str = "clip"  # clip | plip | musk | imagenet

    def coords(self) -> np.ndarray:
        with _open_bag(self.path) as f:
            return np.asarray(f["coords"][:])

    def _reader(self):
        if self.level == 0:
            return open_slide(self.wsi_path).read
        try:
            import openslide  # noqa: F401
        except ImportError as e:
            raise ImportError(f"--level {self.level} reads a pyramid level, which needs "
                              "OpenSlide (openslide-python); it does not import on this "
                              "host, which reads level 0 only") from e
        slide = _OpenSlide(self.wsi_path)
        return lambda c, s: slide.read(c, s, self.level)

    def batches(self, batch_size: int = 64) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        read = self._reader()
        coords = self.coords()
        tf = _make_transform(self.transform, self.image_size)
        for i in range(0, len(coords), batch_size):
            chunk = coords[i: i + batch_size]
            imgs = []
            for x, y in chunk:
                img = read((int(x), int(y)), self.patch_size)
                imgs.append(tf(img) if self.normalize else img)
            yield np.stack(imgs), chunk


def bag_dir(data_dir: str) -> str:
    """``<data_dir>/h5_files`` where it exists, else ``data_dir`` itself."""
    sub = os.path.join(data_dir, "h5_files")
    return sub if os.path.isdir(sub) else data_dir


def bag_path(data_dir: str, slide_id: str) -> str:
    """The slide's patch bag under :func:`bag_dir`, ``.h5`` before ``.npz``."""
    d = bag_dir(data_dir)
    for ext in PATCH_BAG_EXTS:
        path = os.path.join(d, slide_id + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no patch bag for slide {slide_id!r} in {d}")


def list_bags(data_dir: str, csv_path: str | None = None) -> list[str]:
    """Slide ids: the ``slide_id`` column of ``csv_path``, else every patch
    bag (``.h5`` / ``.npz``) under :func:`bag_dir`."""
    if csv_path is not None:
        with open(csv_path, newline="") as f:
            return [row["slide_id"] for row in csv.DictReader(f)]
    d = bag_dir(data_dir)
    return sorted({os.path.splitext(f)[0] for f in os.listdir(d) if f.endswith(PATCH_BAG_EXTS)})
