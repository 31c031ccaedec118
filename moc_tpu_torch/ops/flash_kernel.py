"""K2 on Hopper: the flash-attention forward with log-sum-exp, in CUDA C++.

Replaces the Pallas TPU kernel ``moc_tpu/ops/flash_attention.py::_fwd_kernel``
(launched by ``_fwd``). For ``q [B, H, Lq, D]`` and ``k, v [B, H, Lkv, D]``
it returns ``(o [B, H, Lq, D]`` in the input type, ``lse [B, H, Lq]`` in
f32), with top-left causal masking and segment masking at
``DEFAULT_MASK_VALUE`` as the TPU kernel applies them. Its plain PyTorch
version is ``moc_tpu_torch.ops.flash_attention.mha_reference``.

Bound: operations. At the extraction shape ``[64, 12, 785, 64]`` the work is
4·64·12·785²·64 = 121 GFLOP: 1.81 ms in f32 at the H100's 67 TFLOP/s outside
the tensor cores and 0.12 ms in bf16 at 989 TFLOP/s, while its bytes (q, k,
v and o, 154 MB each in f32) take about 0.18 ms at 3.35 TB/s.

Design (``csrc/flash_fwd.cu``): one CTA per (b·h, 64-row query tile),
looping over 64-key K/V tiles staged in shared memory, with the running
max, sum and unnormalised output in f32 registers; products on the CUDA
cores in f32. Any Lq and Lkv: the ragged edge is masked by bounds, so the
vision trunk's 785 tokens need no padding to a lane multiple. Speed is left
to later work (``mma.sync``/``wgmma``, TMA).

The wrapper takes CUDA tensors only and raises on anything else; callers
send CPU tensors to the plain version instead. It is forward only: K3 and K4
(the backward) are not ported, so it raises when autograd would need a
gradient. It counts its launches in ``flash_fwd_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from moc_tpu_torch.ops import cuda_build

_KERNEL = "flash_fwd"
_fn = None  # the bound C entry point, set on first launch


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load(_KERNEL).moc_flash_fwd
        # pointers and the stream as c_void_p: a bare int would pass as 32 bits
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segs) -> None:
    tensors = (q, k, v, *(s for s in segs if s is not None))
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"K2 takes CUDA tensors, got one on {t.device}")
        if t.device != q.device:
            raise ValueError("K2 takes all its tensors on one device")
        if not t.is_contiguous():
            raise ValueError("K2 takes contiguous tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K2 takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("K2 takes q, k and v of one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("K2 takes [B, H, L, D] tensors")
    b, h, _, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"K2 takes head dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"K2 shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("K2 takes 16-byte aligned tensors")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("K2 shape exceeds int32 indexing")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("K2 is forward only (its backward, K3 and K4, is not ported): "
                           "call it under torch.no_grad() or torch.inference_mode()")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_segment_ids: torch.Tensor | None = None,
                   kv_segment_ids: torch.Tensor | None = None, *, causal: bool = False,
                   sm_scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` for contiguous ``q [B, H, Lq, D]``, ``k, v [B, H, Lkv, D]``
    on the GPU (f32 or bf16, D 64 or 128), with optional int32 segment ids
    ``[B, Lq]`` and ``[B, Lkv]`` (both or neither). One launch."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both or neither of q/kv segment ids")
    _check(q, k, v, (q_segment_ids, kv_segment_ids))
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    if q_segment_ids is not None:
        if q_segment_ids.shape != (b, lq) or kv_segment_ids.shape != (b, lkv):
            raise ValueError(f"segment ids {tuple(q_segment_ids.shape)}, "
                             f"{tuple(kv_segment_ids.shape)} do not match [B, L]")
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(),
                        None if q_segment_ids is None else q_segment_ids.data_ptr(),
                        None if kv_segment_ids is None else kv_segment_ids.data_ptr(),
                        b * h, h, lq, lkv, d, int(q.dtype == torch.bfloat16), int(causal),
                        float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0
