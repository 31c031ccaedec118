"""A one-entry cache of host arrays committed to a device (port of
``moc_tpu/utils/device_cache.py``).

Repeated sweeps in one process ship the same slide pool to the device every
call. Keying the device tensors by a content fingerprint of the host bytes
makes reuse safe by construction: changed or different data never aliases a
stale device buffer, and an unchanged corpus (every shot, fold and repeated
draw of a sweep) reuses the committed tensors. The fingerprint is blake2b
over the raw buffer; read-only arrays memoize theirs, since they cannot
change. The cache holds one entry, so the newest pool evicts the previous
one and bounds the device memory it holds. ``MOC_TPU_DEVICE_CACHE=0``
disables it.
"""

from __future__ import annotations

import hashlib
import os
import weakref

import numpy as np
import torch

_cache: dict[bytes, tuple[torch.Tensor, ...]] = {}
# id(array) -> (weakref, digest), for read-only arrays only (writing to one
# raises, so the bytes behind a memoized digest cannot change); the weakref's
# callback drops the entry when its array is collected, before the id can be
# reused, and the lookup checks the weakref as well
_digest_memo: dict[int, tuple] = {}


def _array_digest(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    memo_ok = not a.flags.writeable
    if memo_ok:
        ent = _digest_memo.get(id(a))
        if ent is not None and ent[0]() is a:
            return ent[1]
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((a.shape, a.dtype.str)).encode())
    h.update(memoryview(a).cast("B"))
    d = h.digest()
    if memo_ok:
        key = id(a)
        _digest_memo[key] = (weakref.ref(a, lambda _, k=key: _digest_memo.pop(k, None)), d)
    return d


def _fingerprint(arrays, extra: bytes) -> bytes:
    h = hashlib.blake2b(extra, digest_size=16)
    for a in arrays:
        h.update(_array_digest(a))
    return h.digest()


def cache_enabled() -> bool:
    return os.environ.get("MOC_TPU_DEVICE_CACHE", "1") != "0"


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: to a GPU through a pinned host buffer in one
    asynchronous copy; on the CPU as a copy of its own."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    host = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = a
    return host.to(device, non_blocking=True)


def device_put_cached(*arrays: np.ndarray, device: str | torch.device, extra: bytes = b""):
    """Each host array on ``device``, reusing the tensors of the previous
    call when the content fingerprint (and ``device`` and ``extra``, which
    salts the key) match. Returns ``(tensors, hit)``."""
    device = torch.device(device)
    if not cache_enabled():
        return tuple(_put(a, device) for a in arrays), False
    key = _fingerprint(arrays, extra + str(device).encode())
    hit = _cache.get(key)
    if hit is not None:
        return hit, True
    put = tuple(_put(a, device) for a in arrays)
    _cache.clear()  # the newest pool evicts the previous one
    _cache[key] = put
    return put, False


def clear_device_cache() -> None:
    _cache.clear()
