"""Bag file IO in the CLAM schema (PyTorch port of ``moc_tpu/data/bags.py``).

A *bag* is one whole-slide image pre-processed into a set of patch
embeddings: ``<root>/pt_files/<slide_id>.pt`` holds a torch-saved
``features [N, D]`` tensor, and ``<root>/h5_files/<slide_id>.h5`` an HDF5
file with ``features [N, D]`` and ``coords [N, 2]``. Readers return host
numpy; device placement happens in ``batching``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Bag:
    """One slide's worth of patch embeddings (host-side, unpadded)."""

    slide_id: str
    features: np.ndarray  # [N, D] float32
    coords: np.ndarray | None = None  # [N, 2] int32, optional
    label: int | None = None
    path: str | None = None

    @property
    def n_patches(self) -> int:
        return int(self.features.shape[0])

    @property
    def dim(self) -> int:
        return int(self.features.shape[1])


def _slide_id(path: str, slide_id: str | None) -> str:
    return slide_id if slide_id is not None else os.path.splitext(os.path.basename(path))[0]


def read_bag_pt(path: str, slide_id: str | None = None, label: int | None = None) -> Bag:
    """Read a ``pt_files`` bag (a torch-saved features tensor). Loaded with
    ``weights_only=True``: a bag is data, so nothing in it may run code."""
    features = torch.load(path, map_location="cpu", weights_only=True)
    features = np.asarray(features.numpy() if torch.is_tensor(features) else features,
                          dtype=np.float32)
    return Bag(slide_id=_slide_id(path, slide_id), features=features, label=label,
               path=path)


def read_bag_h5(path: str, slide_id: str | None = None, label: int | None = None) -> Bag:
    """Read an ``h5_files`` bag (``features`` + ``coords`` datasets). Needs
    ``h5py``, which hosts without it lack: there it raises ImportError."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"h5py is required for .h5 bag files ({path}); "
                          "convert the bag to .pt on such hosts") from e
    with h5py.File(path, "r") as f:
        features = np.asarray(f["features"][:], dtype=np.float32)
        coords = np.asarray(f["coords"][:], dtype=np.int32) if "coords" in f else None
    return Bag(slide_id=_slide_id(path, slide_id), features=features, coords=coords,
               label=label, path=path)
