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


def _h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"h5py is required for .h5 bag files ({path}); "
                          "use .pt bags on such hosts") from e
    return h5py


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
    with _h5py(path).File(path, "r") as f:
        features = np.asarray(f["features"][:], dtype=np.float32)
        coords = np.asarray(f["coords"][:], dtype=np.int32) if "coords" in f else None
    return Bag(slide_id=_slide_id(path, slide_id), features=features, coords=coords,
               label=label, path=path)


def read_bag(data_dir: str, slide_id: str, *, use_h5: bool = False,
             label: int | None = None) -> Bag:
    """Read ``<data_dir>/pt_files/<slide_id>.pt``, or with ``use_h5`` the
    coordinate-bearing ``<data_dir>/h5_files/<slide_id>.h5`` (needs h5py)."""
    if use_h5:
        return read_bag_h5(os.path.join(data_dir, "h5_files", f"{slide_id}.h5"), slide_id, label)
    return read_bag_pt(os.path.join(data_dir, "pt_files", f"{slide_id}.pt"), slide_id, label)


def bag_patch_count(data_dir: str, slide_id: str, *, use_h5: bool = False) -> int | None:
    """A bag's patch count from its h5 header alone (no feature bytes read);
    None for a ``pt_files`` bag, which has no cheap header, or when the h5
    file is absent."""
    path = os.path.join(data_dir, "h5_files", f"{slide_id}.h5")
    if not (use_h5 and os.path.exists(path)):
        return None
    with _h5py(path).File(path, "r") as f:
        return int(f["features"].shape[0])


def write_bag_pt(path: str, features: np.ndarray) -> None:
    """Write a ``pt_files`` bag: the torch-saved f32 ``features [N, D]``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32)), path)


def write_bag_h5(path: str, features: np.ndarray, coords: np.ndarray | None = None) -> None:
    """Write an ``h5_files`` bag (``features`` and optional ``coords``)."""
    h5py = _h5py(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("features", data=np.asarray(features, dtype=np.float32))
        if coords is not None:
            f.create_dataset("coords", data=np.asarray(coords, dtype=np.int32))


def append_hdf5(path: str, asset_dict: dict, attr_dict: dict | None = None,
                mode: str = "a") -> str:
    """Streaming HDF5 writer (CLAM's ``save_hdf5``): the first write of a key
    creates a chunked dataset with an unlimited first axis (and the key's
    attrs); later writes resize it and append along axis 0."""
    h5py = _h5py(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, mode) as f:
        for key, val in asset_dict.items():
            val = np.asarray(val)
            if key not in f:
                dset = f.create_dataset(key, shape=val.shape, maxshape=(None,) + val.shape[1:],
                                        chunks=(1,) + val.shape[1:], dtype=val.dtype)
                dset[:] = val
                for attr_key, attr_val in (attr_dict or {}).get(key, {}).items():
                    dset.attrs[attr_key] = attr_val
            elif val.shape[0]:  # dset[-0:] would select everything
                dset = f[key]
                dset.resize(len(dset) + val.shape[0], axis=0)
                dset[-val.shape[0]:] = val
    return path


def save_pkl(path: str, obj) -> None:
    """Pickle writer (the reference's ``utils/file_utils.save_pkl``)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pkl(path: str):
    """Pickle reader (the reference's ``load_pkl``). Unpickling runs code:
    read only files this program wrote."""
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)
