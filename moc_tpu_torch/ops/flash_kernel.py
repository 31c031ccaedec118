"""K2, K3 and K4 on Hopper: the flash-attention forward and backward, in CUDA C++.

K2 (``flash_fwd_cuda``, ``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel
``moc_tpu/ops/flash_attention.py::_fwd_kernel`` (launched by ``_fwd``). For
``q [B, H, Lq, D]`` and ``k, v [B, H, Lkv, D]`` it returns ``(o [B, H, Lq, D]``
in the input type, ``lse [B, H, Lq]`` in f32), with top-left causal masking
and segment masking at ``DEFAULT_MASK_VALUE`` as the TPU kernel applies them.
Its plain PyTorch version is ``moc_tpu_torch.ops.flash_attention.mha_reference``.

K3 (``flash_bwd_dq_cuda``) and K4 (``flash_bwd_dkv_cuda``), both in
``csrc/flash_bwd.cu``, replace ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
(launched by ``_bwd``). From the forward's ``lse`` and ``delta =
rowsum(do * o)`` they recompute the probabilities and return ``dq``, and
``(dk, dv)``, in the input type. Their plain PyTorch version is
``moc_tpu_torch.ops.flash_attention.flash_bwd_reference``.

Bound: operations. In f32 the least time for f32-accurate work on an H100 is
three TF32 passes of every product at 495 TFLOP/s; in bf16 one pass at 989
TFLOP/s. At the extraction shape ``[64, 12, 785, 64]`` K2's work is
4·64·12·785²·64 = 121 GFLOP: 0.73 ms in f32 and 0.12 ms in bf16, while its
bytes (q, k, v and o, 154 MB each in f32) take about 0.18 ms at 3.35 TB/s.
At the pretraining shape ``[32, 12, 512, 64]`` K3 does 6·B·H·L²·D = 38.7
GFLOP and K4 8·B·H·L²·D = 51.5 GFLOP: 0.2345 and 0.312 ms in f32, against
0.08-0.09 ms for their bytes.

Design: all three, in both types, are persistent CTAs built for Hopper on
``wgmma`` over tiles that a producer warp loads by TMA into an mbarrier
ring (``csrc/flash_sm90.cuh``), over (b·h, row tile) items, 64 rows for
each consumer warpgroup. K2 and K3 own query rows and loop over K/V tiles;
K4 owns keys and loops over the query tiles, so no tile is reduced across
CTAs and nothing needs atomics. Running sums are in f32 registers. In f32
all three run on the tensor cores in three TF32 passes (hi·hi + hi·lo +
lo·hi of operands split inside the kernel, hi = tf32(x) or, in K3's and
K4's tiles, x itself, whose low 13 bits the tensor core drops, and lo =
tf32(x - hi), with no process-global TF32 flag read or set): one pass would
miss the JAX package's f32 tolerances,
three hold them and stay within 1e-5 of the largest |O| (K2) or |grad| (K3,
K4) of the plain version. In bf16 the products are exact and summed in
f32. All three read q, k, v (and dO) and write o (dq, dk, dv) by their
strides in both types (``tma_geometry``). On the tensor cores the kernels
sum in another order than the plain version, so they match it within a
tolerance rather than bit for bit. Any Lq and Lkv: the
ragged edge is masked by bounds, so the vision trunk's 785 tokens need no
padding to a lane multiple. Head dims 32, 64 and 128. A bf16 CUDA tensor reaches the bf16 tensor-core kernels
and nothing else, an f32 one the f32 kernels.

The wrappers take CUDA tensors only and raise on anything else; callers
send CPU tensors to the plain versions instead. ``flash_fwd_cuda`` alone is
forward only: it raises when autograd would need a gradient through it, and
``ops.flash_attention``'s autograd Functions call it with grad mode off and
run K3 and K4 in their backward. Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from moc_tpu_torch.ops import cuda_build

HEAD_DIMS = (32, 64, 128)
_bound: dict = {}  # C entry point by symbol, bound on first launch


def _kernel(source: str, symbol: str, n_pointers: int):
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(cuda_build.load(source), symbol)
        # pointers and the stream as c_void_p: a bare int would pass as 32 bits;
        # then bh, heads, lq, lkv, d, is_bf16, causal and sm_scale
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bound[symbol] = fn
    return fn


# TMA reads a tensor by byte strides that are multiples of this
TMA_STRIDE_BYTES = 16
TMA_MAX_STRIDE = 2 ** 40
# query rows a TMA box of K2's bf16 kernel holds for q and o (one consumer
# warpgroup's tile), and keys for k and v (one K/V tile)
Q_BOX_ROWS, KV_BOX_ROWS = 64, 128
# the names refusals give the dtypes the kernels read by strides
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def kv_box_rows(dtype: torch.dtype, d: int) -> int:
    """Keys a TMA box of K2's k and v holds (one K/V tile): 128 in bf16; in
    f32 64, or 32 at D = 128 (``Sm90Tf32Fwd``), whose tiles are held split
    in hi and lo."""
    if dtype == torch.bfloat16:
        return KV_BOX_ROWS
    return 32 if d == 128 else 64


def tma_geometry(t: torch.Tensor, box_rows: int) -> dict:
    """The tensor map K2 encodes over ``t [B, H, L, D]`` (``moc_flash_fwd``,
    ``csrc/flash_sm90.cuh`` ``make_map``), bf16 or f32: ``dims`` (D, L, H,
    B), innermost first; ``strides``, the byte strides of L, H and B;
    ``box`` (columns, rows, 1, 1), at most 128 bytes wide (64 bf16 or 32 f32
    columns), so D = 128 takes two bf16 boxes or four f32 ones; and
    ``swizzle``, the bytes of a box row (128, or 64 for bf16 at D = 32). A
    dimension of size 0 or 1 is never stepped: its stride
    is taken as the extent of the dimensions inside it. Raises ``ValueError``
    where TMA cannot read ``t`` by its strides: a last dimension that is not
    contiguous, or a stride that is not a positive multiple of 16 bytes below
    2^40 (an empty tensor is never stepped at all). The kernel derives the
    box and swizzle from D alone; the two must agree."""
    b, h, length, d = t.shape
    cols = min(d, 128 // t.element_size())
    return {"dims": (d, length, h, b), "strides": _tma_strides(t), "box": (cols, box_rows, 1, 1),
            "swizzle": cols * t.element_size()}


def _tma_strides(t: torch.Tensor, name: str = "K2") -> tuple:
    """``tma_geometry``'s byte strides of L, H and B (the wrappers' fast
    path); ``name`` is the kernel a refusal names, beside ``t``'s dtype."""
    b, h, length, d = t.shape
    sb, sh, sl, sd = t.stride()
    el = t.element_size()
    dtype = _DTYPE_NAMES.get(t.dtype, str(t.dtype))
    if d > 1 and sd != 1:
        raise ValueError(f"{name} reads {dtype} tensors whose last dim is contiguous, got "
                         f"strides {t.stride()}")
    empty = t.numel() == 0
    step_l = d * el if length <= 1 or empty else sl * el
    step_h = step_l * max(length, 1) if h <= 1 or empty else sh * el
    step_b = step_h * max(h, 1) if b <= 1 or empty else sb * el
    for step in (step_l, step_h, step_b):
        if step <= 0 or step % TMA_STRIDE_BYTES or step >= TMA_MAX_STRIDE:
            raise ValueError(f"{name} reads {dtype} tensors by strides that are multiples of "
                             f"{TMA_STRIDE_BYTES} bytes, got strides {t.stride()} "
                             f"(elements of {el} bytes)")
    return step_l, step_h, step_b


def tma_readable(t: torch.Tensor) -> bool:
    """Whether the kernels, which read by strides (K2, K3 and K4), can read
    ``t`` as it lies (``tma_geometry``)."""
    try:
        tma_geometry(t, Q_BOX_ROWS)
    except ValueError:
        return False
    return True


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           others: tuple = ()) -> None:
    """Device, type, shape and alignment of q, k, v and of the extra ``[B,
    H, Lq, D]`` tensors in ``others`` (the backward's ``do``); their strides
    are held to ``tma_geometry``'s contract at the launch."""
    device = q.get_device()  # -1 on the CPU
    for t in (q, k, v, *others):
        if not t.is_cuda:
            raise ValueError(f"{name} takes CUDA tensors, got one on {t.device}")
        if t.get_device() != device:
            raise ValueError(f"{name} takes all its tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, *others)):
        raise ValueError(f"{name} takes q, k, v (and do) of one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes [B, H, L, D] tensors")
    b, h, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dim 32, 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name} shapes disagree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: do must have q's shape {tuple(q.shape)}")
    for t in (q, k, v, *others):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} takes 16-byte aligned tensors")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError(f"{name} shape exceeds int32 indexing")


def _segments(q_segment_ids, kv_segment_ids, b: int, lq: int, lkv: int, device):
    """Both segment id tensors as contiguous int32 ``[B, L]`` on ``device``,
    or ``(None, None)``."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both or neither of q/kv segment ids")
    if q_segment_ids is None:
        return None, None
    if q_segment_ids.shape != (b, lq) or kv_segment_ids.shape != (b, lkv):
        raise ValueError(f"segment ids {tuple(q_segment_ids.shape)}, "
                         f"{tuple(kv_segment_ids.shape)} do not match [B, L]")
    for s in (q_segment_ids, kv_segment_ids):
        if s.device != device:
            raise ValueError(f"segment ids on {s.device}, tensors on {device}")
    return (q_segment_ids.to(torch.int32).contiguous(),
            kv_segment_ids.to(torch.int32).contiguous())


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(fn, name: str, q: torch.Tensor, pointers: list, lkv: int, causal: bool,
            sm_scale: float) -> None:
    b, h, lq, d = q.shape
    args = (b * h, h, lq, lkv, d, int(q.dtype == torch.bfloat16), int(causal), float(sm_scale))
    device = q.get_device()
    # the current stream's raw handle (torch.cuda.current_stream() builds a
    # Stream object a call, several microseconds on the launch path)
    if device == torch.cuda.current_device():
        err = fn(*pointers, *args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*pointers, *args, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_segment_ids: torch.Tensor | None = None,
                   kv_segment_ids: torch.Tensor | None = None, *, causal: bool = False,
                   sm_scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(o, lse)`` for ``q [B, H, Lq, D]``, ``k, v [B, H, Lkv, D]`` on
    the GPU (f32 or bf16, D 32, 64 or 128), with optional segment ids ``[B,
    Lq]`` and ``[B, Lkv]`` (both or neither). q, k and v are read by their
    strides in either type (``tma_geometry``: the last dim contiguous, the
    others multiples of 16 bytes), so the ``[B, H, L, D]`` view of a ``[B,
    L, H, D]`` projection needs no copy, and o takes q's layout where q is
    dense. One launch."""
    _check("K2", q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("K2 is forward only: differentiate through "
                           "ops.flash_attention, whose backward runs K3 and K4, or call "
                           "it under torch.no_grad() or torch.inference_mode()")
    b, h, lq, d = q.shape
    lkv = k.shape[2]
    q_seg, kv_seg = _segments(q_segment_ids, kv_segment_ids, b, lq, lkv, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    strides = _strides("K2", (q, k, v, out))
    _launch(_kernel("flash_fwd", "moc_flash_fwd", 8), "flash_fwd", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             _ptr(q_seg), _ptr(kv_seg), ctypes.addressof(strides)],
            lkv, causal, d ** -0.5 if sm_scale is None else sm_scale)
    flash_fwd_cuda.launches += 1
    return out, lse


def k2_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """The dynamic shared memory a CTA of K2 takes at head dim ``d`` in
    ``dtype`` (``Sm90Fwd`` / ``Sm90Tf32Fwd`` ``kSmem``); builds K2 on first
    use."""
    fn = cuda_build.load("flash_fwd").moc_flash_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(d, int(dtype == torch.bfloat16))


def k3_k4_smem_bytes(d: int, dtype: torch.dtype, kernel: str) -> int:
    """The dynamic shared memory a CTA of K3 (``kernel="K3"``) or K4 takes
    at head dim ``d`` in ``dtype`` (``Sm90Dq`` / ``Sm90Dkv`` /
    ``Sm90Tf32Dq`` / ``Sm90Tf32Dkv`` ``kSmem``); builds them on first use."""
    fn = cuda_build.load("flash_bwd").moc_flash_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn(d, int(dtype == torch.bfloat16), int(kernel == "K4"))


def _check_stats(name: str, q: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor) -> None:
    for t, what in ((lse, "lse"), (delta, "delta")):
        if (t.dtype != torch.float32 or t.shape != q.shape[:3] or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} takes {what} as contiguous float32 {tuple(q.shape[:3])} "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _backward_args(name, q, k, v, do, lse, delta, q_segment_ids, kv_segment_ids):
    """The checks of K3 and K4: q, k, v and do are read by their strides
    (held to ``tma_geometry``'s contract at the launch); lse and delta as
    ``_check_stats`` takes them. Returns the segment ids as the kernels take
    them."""
    _check(name, q, k, v, (do,))
    _check_stats(name, q, lse, delta)
    b, _, lq, _ = q.shape
    return _segments(q_segment_ids, kv_segment_ids, b, lq, k.shape[2], q.device)


def _strides(name: str, tensors) -> ctypes.Array:
    """The byte strides of L, H and B of each tensor in turn, as the
    kernels' tensor maps take them; raises ``ValueError`` where TMA cannot
    read or write one by its strides."""
    values = [x for t in tensors for x in _tma_strides(t, name)]
    return (ctypes.c_longlong * len(values))(*values)


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                      lse: torch.Tensor, delta: torch.Tensor,
                      q_segment_ids: torch.Tensor | None = None,
                      kv_segment_ids: torch.Tensor | None = None, *, causal: bool = False,
                      sm_scale: float | None = None) -> torch.Tensor:
    """K3: ``dq [B, H, Lq, D]`` in the input type, from q, k, v and ``do``
    (as ``flash_fwd_cuda`` takes them: read by their strides in either type,
    so the views of ``[B, L, H, D]`` projections need no copy, and dq takes
    q's layout where q is dense), the forward's ``lse`` and ``delta =
    rowsum(do * o)``, both contiguous f32 ``[B, H, Lq]``. One launch."""
    q_seg, kv_seg = _backward_args("K3", q, k, v, do, lse, delta, q_segment_ids,
                                   kv_segment_ids)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    strides = _strides("K3", (q, k, v, do, dq))
    _launch(_kernel("flash_bwd", "moc_flash_bwd_dq", 10), "flash_bwd_dq", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
             ctypes.addressof(strides)], k.shape[2], causal,
            q.shape[3] ** -0.5 if sm_scale is None else sm_scale)
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       lse: torch.Tensor, delta: torch.Tensor,
                       q_segment_ids: torch.Tensor | None = None,
                       kv_segment_ids: torch.Tensor | None = None, *, causal: bool = False,
                       sm_scale: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(dk, dv) [B, H, Lkv, D]`` in the input type (in k's and v's
    layouts where they are dense), from the inputs ``flash_bwd_dq_cuda``
    takes. One launch."""
    q_seg, kv_seg = _backward_args("K4", q, k, v, do, lse, delta, q_segment_ids,
                                   kv_segment_ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    strides = _strides("K4", (q, k, v, do, dk, dv))
    _launch(_kernel("flash_bwd", "moc_flash_bwd_dkv", 11), "flash_bwd_dkv", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
             ctypes.addressof(strides)],
            k.shape[2], causal, q.shape[3] ** -0.5 if sm_scale is None else sm_scale)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0
