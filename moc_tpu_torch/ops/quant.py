"""int8 quantization of the serving tier ``--storage_dtype int8`` (PyTorch
port of ``moc_tpu/ops/quant.py``).

W8A8 with dynamic scales: each patch row is quantized on the host when its
batch is packed, each weight column on the fly, and the scoring product
runs int8 × int8 → int32, with the scales applied to the small ``[N, C]``
result:

    feats ~= q * s_row[:, None]          (symmetric absmax/127 per patch)
    w     ~= wq * s_col[None, :]         (symmetric absmax/127 per column)
    feats @ w ~= (q @ wq) * s_row[:, None] * s_col[None, :]

The JAX package's ``int8_row_matmul`` is an XLA ``dot_general`` with an
int32 result, not a Pallas kernel; here it is ``torch._int_mm`` on the GPU
(cuBLASLt's int8 product; its operands want m > 16 and k, n multiples of
8, so the weight columns and, where needed, the feature dimension are
padded with zeros) and the same int32 product on the CPU. The int32 sums
are exact, so both give the same bits. Every step keeps the JAX package's
arithmetic order: all-zero rows get scale 0, a column whose absmax is 0
gets scale 1, and the product is ``acc.float() * s_row * s_col``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def quantize_rows_host(features: np.ndarray, *,
                       out: tuple[np.ndarray, np.ndarray] | None = None,
                       required: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization of host ``[..., N, D]`` features:
    ``(q int8, scales f32 [..., N])`` with ``q * scales[..., None]`` close to
    ``features``. The native single pass (``data.native.quantize_rows_i8``)
    when it builds, else numpy in f32 arithmetic, bit for bit the same. With
    ``out``, the results land in those buffers."""
    from moc_tpu_torch.data.native import quantize_rows_i8

    f = np.ascontiguousarray(np.asarray(features, np.float32))
    native = quantize_rows_i8(f, out=out, required=required) if f.ndim >= 2 else None
    if native is not None:
        return native
    absmax = np.max(np.abs(f), axis=-1)
    scales = absmax.astype(np.float32) / np.float32(127.0)
    # all-f32 arithmetic, as the native pass: an f64 inverse would move
    # half-to-even ties
    inv = np.float32(1.0) / np.where(scales > 0, scales, np.float32(1.0))
    inv = np.where(scales > 0, inv.astype(np.float32), np.float32(0.0))
    q = np.clip(np.rint(f * inv[..., None]), -127, 127).astype(np.int8)
    if out is not None:
        out[0][...], out[1][...] = q, scales
        return out
    return q, scales


def _div(a: torch.Tensor, b: float | torch.Tensor) -> torch.Tensor:
    """``a / b`` rounded once, on every device: on the GPU, PyTorch divides a
    tensor by a Python scalar as a product with the scalar's reciprocal,
    which can differ from the quotient by an ulp; a tensor divisor is
    divided elementwise."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def quantize_rows_device(features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows_host`` on a tensor, on its device: the same absmax/127
    scheme in f32, all-zero rows at scale 0."""
    f = features.float()
    scales = _div(f.abs().amax(-1), 127.0)
    inv = torch.where(scales > 0, _div(torch.ones_like(scales),
                                       torch.where(scales > 0, scales, 1.0)), 0.0)
    q = torch.clamp(torch.round(f * inv[..., None]), -127, 127).to(torch.int8)
    return q, scales


def quantize_columns(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantization of a ``[D, C]`` weight matrix:
    ``(wq int8, scales f32 [C])``; a column whose absmax is 0 gets scale 1."""
    w = w.float()
    absmax = w.abs().amax(0)
    scales = torch.where(absmax > 0, _div(absmax, 127.0), 1.0)
    wq = torch.clamp(torch.round(w / scales[None, :]), -127, 127).to(torch.int8)
    return wq, scales


def _int_product(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``q [M, K] int8 @ wq [K, C] int8`` → int32 ``[M, C]``, exactly, through
    ``torch._int_mm`` with ``wq`` zero-padded to a multiple of 8 columns (and
    ``K`` to a multiple of 8 where it is not one), row-major ``q`` and a
    column-major second operand. On a CPU whose torch lacks ``_int_mm``, an
    int32 product."""
    if q.device.type != "cuda" and not hasattr(torch, "_int_mm"):
        return q.to(torch.int32) @ wq.to(torch.int32)
    m, k = q.shape
    c = wq.shape[1]
    pad_k, pad_c = -k % 8, -c % 8
    if pad_k:
        q = F.pad(q, (0, pad_k))
    if m <= 16:
        q = F.pad(q, (0, 0, 0, 17 - m))
    wq = F.pad(wq, (0, pad_c, 0, pad_k))
    acc = torch._int_mm(q.contiguous(), wq.t().contiguous().t())
    return acc[:m, :c]


def int8_row_matmul(q: torch.Tensor, row_scales: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dequant(q) @ w`` without the dequantized rows: ``q [..., N, D]``
    int8 with ``row_scales [..., N]``, ``w [D, C]`` float (quantized per
    column here) → f32 ``[..., N, C]``."""
    wq, col_scales = quantize_columns(w)
    lead = q.shape[:-1]
    acc = _int_product(q.reshape(-1, q.shape[-1]), wq).view(*lead, wq.shape[1])
    return acc.float() * row_scales[..., None] * col_scales


def dequantize_rows(q: torch.Tensor, row_scales: torch.Tensor) -> torch.Tensor:
    """f32 rows of the int8 tier, for a consumer with no scaled product."""
    return q.float() * row_scales[..., None]
