"""Padded, masked bag batches with bucketed lengths (PyTorch port of
``moc_tpu/data/batching.py``).

Bags are padded to a small set of *bucket* sizes, and every op downstream
consumes a ``[B, N, D]`` batch plus a ``[B, N]`` validity mask. The host
pads through the native packer (``data.native``) and copies to the device
only the bytes of the batch's storage tier: f32, bf16 (cast on the host,
round to nearest even), or int8 rows with their f32 scales (quantized on
the host).
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
      features:  ``[B, N, D]`` patch embeddings (pad rows are zero): float32,
                 bfloat16, or int8 in the int8 storage tier.
      mask:      ``[B, N]`` bool, True on real patches.
      labels:    ``[B]`` int32 slide labels (-1 when unknown or filler).
      n_patches: ``[B]`` int32 true patch counts.
      coords:    ``[B, N, 2]`` int32 patch coordinates, or None.
      scales:    ``[B, N]`` f32 per-row scales of int8 ``features``
                 (``features ~= q * scales[..., None]``), else None.
    """

    features: torch.Tensor
    mask: torch.Tensor
    labels: torch.Tensor
    n_patches: torch.Tensor
    coords: torch.Tensor | None = None
    scales: torch.Tensor | None = None

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def padded_len(self) -> int:
        return self.features.shape[1]

    def __len__(self) -> int:
        return self.batch_size

    def to(self, device: torch.device) -> "BagBatch":
        """The batch on ``device`` (itself when it is already there); from
        pinned host memory the copies are asynchronous."""
        if self.features.device == device:
            return self
        return BagBatch(*(None if t is None else t.to(device, non_blocking=True) for t in
                          (self.features, self.mask, self.labels, self.n_patches,
                           self.coords, self.scales)))

    def slice_batch(self, start: int, size: int) -> "BagBatch":
        """Slides ``start:start + size`` of the batch (views, no copies)."""
        return BagBatch(*(None if t is None else t[start:start + size] for t in
                          (self.features, self.mask, self.labels, self.n_patches,
                           self.coords, self.scales)))

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


STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def storage_dtype(dtype: str | torch.dtype | None) -> torch.dtype:
    """The torch dtype of a storage tier given by name (``float32``,
    ``bfloat16``, ``int8``) or as a torch dtype."""
    if dtype is None:
        return torch.float32
    out = STORAGE_DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if out not in STORAGE_DTYPES.values():
        raise ValueError(f"unknown storage dtype {dtype!r}; one of {sorted(STORAGE_DTYPES)}")
    return out


def pack_bags(bags: Sequence[Bag], *, n_pad: int | None = None,
              buckets: Sequence[int] = DEFAULT_BUCKETS,
              device: str | torch.device | None = None,
              with_coords: bool = False,
              dtype: str | torch.dtype | None = None,
              pin_memory: bool | None = None) -> BagBatch:
    """Pad a list of bags to a common bucketed length and stack them into a
    batch on ``device`` (default ``cuda``) in the storage tier ``dtype``
    (default float32). The native packer pads into host memory, pinned
    where the batch goes to a GPU, and the batch leaves in asynchronous
    copies of the tier's bytes only: f32 features; bf16 features cast on
    the host (round to nearest even); or int8 rows and their f32 scales,
    quantized on the host (``ops.quant.quantize_rows_host``; pad rows get
    scale 0). For a GPU the native library is required: a failed build
    raises. The mask is built on the device from the counts. ``with_coords``
    also stacks the bags' coordinates (zero-padded), which every bag must
    then carry. ``pin_memory`` (default: whether the batch goes to a GPU)
    keeps a host batch's features in pinned memory, for a later
    asynchronous copy (``data.loader.prefetch_to_device``)."""
    from moc_tpu_torch.data.native import pack_bags_native
    from moc_tpu_torch.ops.quant import quantize_rows_host

    if not bags:
        raise ValueError("pack_bags needs at least one bag")
    dev = resolve_device(device)
    dtype = storage_dtype(dtype)
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
    shape = (len(bags), n_pad, dims.pop())
    pin = dev.type == "cuda" if pin_memory is None else pin_memory

    def host(dt, shp=shape):
        return torch.empty(shp, dtype=dt, pin_memory=pin)

    # the f32 staging buffer is pinned too where the batch goes to a GPU:
    # PyTorch's pinned allocator hands back cached blocks whose pages are
    # resident, where a fresh pageable buffer faults in every page again
    f32 = host(torch.float32)
    pack_bags_native([b.features for b in bags], n_pad, out=f32.numpy(), required=pin)
    scales = None
    if dtype == torch.float32:
        features = f32
    elif dtype == torch.bfloat16:
        features = host(torch.bfloat16).copy_(f32)
    else:
        features, scales = host(torch.int8), host(torch.float32, shape[:2])
        quantize_rows_host(f32.numpy(), out=(features.numpy(), scales.numpy()), required=pin)
    meta = torch.tensor([[b.label if b.label is not None else -1 for b in bags],
                         [b.n_patches for b in bags]], dtype=torch.int32).to(dev)
    labels, n_patches = meta[0], meta[1]
    mask = torch.arange(n_pad, device=dev) < n_patches[:, None]
    coords = None
    if with_coords:
        missing = [b.slide_id for b in bags if b.coords is None]
        if missing:
            raise ValueError(f"with_coords=True but bags lack coords: {missing[:5]}")
        padded = np.zeros((len(bags), n_pad, 2), np.int32)
        for i, b in enumerate(bags):
            padded[i, :b.n_patches] = b.coords
        coords = torch.from_numpy(padded).to(dev)
    return BagBatch(features=features.to(dev, non_blocking=True), mask=mask,
                    labels=labels, n_patches=n_patches, coords=coords,
                    scales=None if scales is None else scales.to(dev, non_blocking=True))
