"""K1 on Hopper: exact top-k SET selection by threshold search, in CUDA C++.

Replaces the Pallas TPU kernel ``moc_tpu/ops/topk_kernel.py::_threshold_kernel``
(launched by ``topk_threshold_mask_tpu``). For each row of ``keys [R, N]`` it
returns the boolean membership mask of the k largest keys with
``jax.lax.top_k`` tie semantics (ties at the k-th value go to the lowest
indices; exactly k True per row), without sorting. Its plain PyTorch version
is ``moc_tpu_torch.ops.masking.threshold_topk_mask``.

Bound: memory. The least traffic is one read of ``R·N·4`` bytes and one write
of ``R·N`` bytes. At the serving point (batch 8, N=16384, C=2: R=40 selection
rows and R=16 pooling columns) that is about 4.6 MB, near 1.4 µs at the
H100's 3.35 TB/s, so the kernel is really bound by launch and latency.

Design (``csrc/topk_threshold.cu``): each row is split over a thread-block
cluster of ``plan(R, N).cluster`` CTAs, each of which reads its slice from
device memory once into shared memory in a monotone u32 rank space. Up to
four 8-bit radix passes over warp-private histograms, merged across the
cluster through distributed shared memory, narrow down the k-th largest key
``v_k``; they stop as soon as the chosen bin holds exactly the members still
needed, and the mask is then a comparison. Only when more keys equal ``v_k``
than are needed are ties ranked in index order, by one block-wide scan plus
the tie counts of the CTAs before it. Rows longer than a cluster of 8 can stage stream their
slices from device memory on each pass instead. Any N works; N need not be
a multiple of 128, unlike the Pallas kernel. The column entry reads the
``[..., N, C]`` scores in place by stride and writes the ``[..., N, C]`` mask
directly: one launch, no copies.

The wrappers take CUDA tensors only and raise on anything else; callers send
CPU tensors to the plain version instead. Each wrapper counts its launches
in a plain integer attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from moc_tpu_torch.ops import cuda_build

_KERNEL = "topk_threshold"
_fn = None  # the bound C entry point, set on first launch

MAX_CLUSTER = 8  # the portable cluster size
MAX_STAGED_KEYS = 49152  # keys a CTA stages (192 KB), as in csrc/topk_threshold.cu
MIN_SLICE = 512  # keys a CTA should get before a row is split further
LONG_SLICE = 16384  # keys a CTA should get at most, where 8 CTAs allow
H100_SMS = 132


class Plan(NamedTuple):
    """How one launch splits its rows: ``cluster`` CTAs a row, ``slice``
    keys each, held in shared memory when ``staged``."""
    cluster: int
    slice: int
    staged: bool


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def plan(rows: int, n: int, sms: int = H100_SMS) -> Plan:
    """The cluster size of a launch over ``rows`` rows of ``n`` keys: enough
    CTAs a row that ``rows × cluster`` fills ``sms`` SMs, but no more than
    leaves each CTA ``MIN_SLICE`` keys; then enough to keep each slice within
    ``LONG_SLICE`` keys (a pass over a slice takes time in proportion to its
    length) and within ``MAX_STAGED_KEYS``; at most ``MAX_CLUSTER``. A row
    longer than 8 staged slices streams."""
    fill = _pow2_at_least(-(-sms // max(rows, 1)))
    split = 1 << (max(1, n // MIN_SLICE).bit_length() - 1)  # largest power of 2 ≤
    cluster = max(min(fill, split), _pow2_at_least(-(-n // LONG_SLICE)))
    cluster = min(cluster, MAX_CLUSTER)
    size = (-(-n // cluster) + 3) // 4 * 4
    return Plan(cluster, size, size <= MAX_STAGED_KEYS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load(_KERNEL).moc_topk_threshold_mask_f32
        # pointers and the stream as c_void_p: a bare int would pass as 32 bits
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 4,
                       *[ctypes.c_longlong] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(keys: torch.Tensor, out: torch.Tensor, rows: int, cols: int, n: int, k: int,
            key_strides: tuple[int, int, int], out_strides: tuple[int, int, int]) -> None:
    """Row r is column ``r % cols`` of slide ``r // cols``; strides are
    (slide, column, key) in elements of ``keys`` and of ``out``."""
    p = plan(rows, n, _sm_count(keys.device.index))
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(keys.data_ptr(), out.data_ptr(), rows, cols, n, k, *key_strides,
                        *out_strides, p.cluster, int(p.staged), stream)
    if err != 0:
        raise RuntimeError(f"topk_threshold kernel launch failed: CUDA error {err}")


def _check(keys: torch.Tensor, k: int, n: int) -> None:
    if keys.dtype != torch.float32:
        raise ValueError(f"K1 takes float32 keys, got {keys.dtype}")
    if not 1 <= k <= n:
        raise ValueError(f"K1 needs 1 <= k <= N, got k={k}, N={n}")
    if n >= 2 ** 31 or keys.numel() // n >= 2 ** 31:
        raise ValueError(f"K1 shape {tuple(keys.shape)} exceeds int32 indexing")
    if keys.device.type != "cuda":
        raise ValueError(f"K1 takes CUDA tensors, got one on {keys.device}")


def topk_threshold_mask_cuda(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise entry: contiguous f32 ``keys [R, N]`` on the GPU → bool
    ``[R, N]`` with exactly ``k`` True per row. One launch."""
    if keys.dim() != 2:
        raise ValueError(f"K1 row entry takes [R, N] keys, got {tuple(keys.shape)}")
    _check(keys, k, keys.shape[1])
    if not keys.is_contiguous():
        raise ValueError("K1 row entry takes contiguous keys")
    r, n = keys.shape
    out = torch.empty((r, n), dtype=torch.bool, device=keys.device)
    _launch(keys, out, r, 1, n, k, (n, 0, 1), (n, 0, 1))
    topk_threshold_mask_cuda.launches += 1
    return out


topk_threshold_mask_cuda.launches = 0


def col_topk_threshold_mask_cuda(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Column-wise entry for pooling: f32 ``scores [..., N, C]`` on the GPU,
    any strides → contiguous bool ``[..., N, C]`` with exactly ``k`` True per
    column. The kernel reads each column in place; one launch."""
    if scores.dim() < 2:
        raise ValueError(f"K1 column entry takes [..., N, C], got {tuple(scores.shape)}")
    n, c = scores.shape[-2:]
    _check(scores, k, n)
    s3 = scores.reshape(-1, n, c)  # a view of any [B, N, C] tensor
    out = torch.empty(scores.shape, dtype=torch.bool, device=scores.device)
    _launch(s3, out, s3.shape[0] * c, c, n, k, (s3.stride(0), s3.stride(2), s3.stride(1)),
            (n * c, 1, c))
    col_topk_threshold_mask_cuda.launches += 1
    return out


col_topk_threshold_mask_cuda.launches = 0
