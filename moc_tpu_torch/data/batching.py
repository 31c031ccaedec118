"""Padded, masked bag batches with bucketed lengths (PyTorch port of
``moc_tpu/data/batching.py``).

Bags are padded to a small set of *bucket* sizes, and every op downstream
consumes a ``[B, N, D]`` batch plus a ``[B, N]`` validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.device import resolve_device

# Bucket boundaries for patch counts: at most ~2x padding waste.
DEFAULT_BUCKETS: tuple[int, ...] = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)


@dataclasses.dataclass(frozen=True)
class BagBatch:
    """A batch of padded bags on one device.

    Attributes:
      features:  ``[B, N, D]`` float32 patch embeddings (pad rows are zero).
      mask:      ``[B, N]`` bool, True on real patches.
      labels:    ``[B]`` int32 slide labels (-1 when unknown or filler).
      n_patches: ``[B]`` int32 true patch counts.
    """

    features: torch.Tensor
    mask: torch.Tensor
    labels: torch.Tensor
    n_patches: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def padded_len(self) -> int:
        return self.features.shape[1]

    def __len__(self) -> int:
        return self.batch_size

    def real_rows(self) -> np.ndarray:
        """Host bool ``[B]``: True on real slides, False on filler rows
        (label ``-1``)."""
        return self.labels.cpu().numpy() >= 0


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n; beyond the largest bucket, round up to 512."""
    for b in buckets:
        if n <= b:
            return b
    return int(-(-n // 512) * 512)


def pad_bag(features: np.ndarray, n_pad: int, coords: np.ndarray | None = None):
    """Pad one bag's features (and coords) to ``n_pad`` rows with a mask:
    ``(features [n_pad, D], mask [n_pad], coords [n_pad, 2] | None)``."""
    n = features.shape[0]
    if n > n_pad:
        raise ValueError(f"bag with {n} patches does not fit pad size {n_pad}")
    mask = np.zeros((n_pad,), dtype=bool)
    mask[:n] = True
    out = np.zeros((n_pad,) + features.shape[1:], dtype=features.dtype)
    out[:n] = features
    out_coords = None
    if coords is not None:
        out_coords = np.zeros((n_pad,) + coords.shape[1:], dtype=coords.dtype)
        out_coords[:n] = coords
    return out, mask, out_coords


def bucketize(bags: Sequence[Bag], buckets: Sequence[int] = DEFAULT_BUCKETS) -> dict[int, list[Bag]]:
    """Group bags by their padded bucket size."""
    out: dict[int, list[Bag]] = {}
    for b in bags:
        out.setdefault(bucket_size(b.n_patches, buckets), []).append(b)
    return out


def pack_bags(bags: Sequence[Bag], *, n_pad: int | None = None,
              buckets: Sequence[int] = DEFAULT_BUCKETS,
              device: str | torch.device | None = None) -> BagBatch:
    """Pad a list of bags to a common bucketed length and stack them into a
    batch on ``device`` (default ``cuda``). The features are padded with
    numpy straight into one pinned host buffer and leave it in one
    asynchronous copy; the mask is built on the device from the counts."""
    if not bags:
        raise ValueError("pack_bags needs at least one bag")
    dev = resolve_device(device)
    max_n = max(b.n_patches for b in bags)
    if n_pad is None:
        n_pad = bucket_size(max_n, buckets)
    elif max_n > n_pad:
        long = [b.slide_id for b in bags if b.n_patches > n_pad]
        raise ValueError(f"bags longer than n_pad={n_pad}: {long[:5]} (max {max_n})")
    dims = {b.dim for b in bags}
    if len(dims) > 1:
        raise ValueError(f"bags mix feature dims {sorted(dims)}; one batch must "
                         "come from one extractor")
    host = torch.empty((len(bags), n_pad, dims.pop()), dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    view = host.numpy()
    for i, b in enumerate(bags):
        view[i, :b.n_patches] = b.features
        view[i, b.n_patches:] = 0.0
    meta = torch.tensor([[b.label if b.label is not None else -1 for b in bags],
                         [b.n_patches for b in bags]], dtype=torch.int32).to(dev)
    labels, n_patches = meta[0], meta[1]
    mask = torch.arange(n_pad, device=dev) < n_patches[:, None]
    return BagBatch(features=host.to(dev, non_blocking=True), mask=mask,
                    labels=labels, n_patches=n_patches)
