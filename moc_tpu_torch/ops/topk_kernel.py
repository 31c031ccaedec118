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

Design (``csrc/topk_threshold.cu``): one CTA per row; an 8-bit radix select
in four histogram passes finds the k-th largest key exactly in a monotone
u32 rank space, then one pass writes the mask, ranking ties in index order
by a block-wide ballot scan. The row is read from global memory (L2) on each
pass, so any N up to the largest bucket works; N need not be a multiple of
128, unlike the Pallas kernel. Speed is left to later work.

The wrappers take CUDA tensors only and raise on anything else; callers send
CPU tensors to the plain version instead. Each wrapper counts its launches
in a plain integer attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from moc_tpu_torch.ops import cuda_build

_KERNEL = "topk_threshold"
_fn = None  # the bound C entry point, set on first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load(_KERNEL).moc_topk_threshold_mask_f32
        # pointers and the stream as c_void_p: a bare int would pass as 32 bits
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(keys: torch.Tensor, k: int) -> torch.Tensor:
    r, n = keys.shape
    out = torch.empty((r, n), dtype=torch.bool, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(keys.data_ptr(), out.data_ptr(), r, n, k, stream)
    if err != 0:
        raise RuntimeError(f"topk_threshold kernel launch failed: CUDA error {err}")
    return out


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
    mask = _launch(keys, k)
    topk_threshold_mask_cuda.launches += 1
    return mask


topk_threshold_mask_cuda.launches = 0


def col_topk_threshold_mask_cuda(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Column-wise entry for pooling: f32 ``scores [..., N, C]`` on the GPU →
    bool ``[..., N, C]`` with exactly ``k`` True per column. The columns are
    first copied contiguous as ``[B·C, N]`` rows; one launch."""
    if scores.dim() < 2:
        raise ValueError(f"K1 column entry takes [..., N, C], got {tuple(scores.shape)}")
    n, c = scores.shape[-2:]
    _check(scores, k, n)
    rows = scores.reshape(-1, n, c).transpose(1, 2).contiguous()  # [B, C, N]
    mask = _launch(rows.view(-1, n), k)
    col_topk_threshold_mask_cuda.launches += 1
    return mask.view(rows.shape).transpose(1, 2).reshape(scores.shape)


col_topk_threshold_mask_cuda.launches = 0
