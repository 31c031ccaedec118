"""Raw-pixel patch bags (PyTorch port of ``moc_tpu/data/patches.py``, the
image-bearing reader).

A patch bag holds one slide's patch images ``imgs [N, H, W, 3]`` (uint8)
and optionally ``coords [N, 2]``, as CLAM's ``Whole_Slide_Bag`` reads them.
The container is an ``.h5`` file where h5py imports, or an ``.npz`` file
with the same array names on hosts without h5py; the schema is the same.
Reads are host-side numpy; images are preprocessed per patch by the CLIP
transform (``zeroshot.transform.preprocess_image``), the one CONCH uses. The
PLIP, MUSK and ImageNet readers come with the backbones that use them, and
the coords-only reader that reads pixels from the slide (OpenSlide) waits
for a later slice.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator

import numpy as np

from moc_tpu_torch.zeroshot.transform import preprocess_image

PATCH_BAG_EXTS = (".h5", ".npz")  # in order of preference for one slide


@dataclasses.dataclass
class PatchBagReader:
    """Iterate the image patches of one slide from an ``imgs``-bearing
    ``.h5`` or ``.npz`` file."""

    path: str
    image_size: int = 224
    normalize: bool = True

    def _open(self):
        """``(file, imgs, coords)``: h5 images are read batch by batch, an
        npz array whole on first access."""
        if self.path.endswith(".npz"):
            f = np.load(self.path)
            return f, f["imgs"], (f["coords"] if "coords" in f.files else None)
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"h5py is required for .h5 patch bags ({self.path}); "
                              "store the bag as .npz on such hosts") from e
        f = h5py.File(self.path, "r")
        return f, f["imgs"], (f["coords"][:] if "coords" in f else None)

    def __len__(self) -> int:
        f, imgs, _ = self._open()
        with f:
            return len(imgs)

    def batches(self, batch_size: int = 64) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        f, imgs, coords = self._open()
        with f:
            for i in range(0, len(imgs), batch_size):
                chunk = np.asarray(imgs[i: i + batch_size])
                if self.normalize:
                    chunk = np.stack([preprocess_image(im, self.image_size) for im in chunk])
                yield chunk, (None if coords is None else np.asarray(coords[i: i + batch_size]))


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
