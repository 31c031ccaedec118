"""Flash attention with log-sum-exp output, forward and backward (PyTorch
port of ``moc_tpu/ops/flash_attention.py``).

All shapes ``[B, H, L, D]``. CUDA tensors go to kernel K2 for the forward
and K3/K4 for the backward (``ops.flash_kernel``); CPU tensors go to their
plain versions, ``mha_reference`` and ``flash_bwd_reference``. Nothing else
chooses between them. Masked keys (causal, top-left aligned, or of another
segment) take ``DEFAULT_MASK_VALUE`` rather than ``-inf`` and still count in
the softmax, so a query row that matches no key gives the mean of V and
``lse == DEFAULT_MASK_VALUE``, as in the JAX package. Its backward then
recomputes ``P = exp(0) = 1`` for every key, L times the dense vjp: the
TPU kernels do the same, and the port matches them.

The gradients follow the JAX package's ``jax.custom_vjp``s: ``_Flash``
(``flash_attention``) and ``_FlashWithLseSG`` (``flash_attention_with_lse(...,
lse_grad=False)``, lse under stop-gradient) run K3 and K4;
``_FlashWithLse`` (``lse_grad=True``) differentiates ``mha_reference``, as
JAX takes the ``jax.vjp`` of it, so the lse carries a gradient and no kernel
runs in its backward. When no input needs a gradient the forward runs
without an autograd Function.

Unlike the JAX package, which sends lengths that are not a multiple of 128
to its dense reference, the kernels take any length: the vision trunk's 785
tokens run on them without padding.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from moc_tpu_torch.ops.flash_kernel import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                            flash_fwd_cuda, tma_readable)

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _mask(q, k, q_segment_ids, kv_segment_ids, causal):
    """Boolean ``[B or 1, 1, Lq, Lkv]`` of the keys a query sees, or None."""
    lq, lkv = q.shape[2], k.shape[2]
    mask = None
    if causal:
        # top-left aligned: query i sees keys 0..i in absolute position
        mask = (torch.arange(lkv, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])[None, None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def mha_reference(q, k, v, *, q_segment_ids=None, kv_segment_ids=None, causal=False,
                  sm_scale=None):
    """Plain attention returning ``(out, lse)``: K2's plain version. The
    scores are formed in the input type and summed in f32 from there, as
    the JAX reference does."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    mask = _mask(q, k, q_segment_ids, kv_segment_ids, causal)
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", (p / l).to(q.dtype), v)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def flash_bwd_reference(q, k, v, o, lse, do, q_segment_ids=None, kv_segment_ids=None,
                        causal=False, sm_scale=None):
    """``(dq, dk, dv)``: the plain version of K3 and K4, as the TPU kernels
    compute them. ``P = exp(s - lse)`` is recomputed from the saved lse,
    ``delta = rowsum(do * o)`` is taken in f32, ``dS = P * (dO·Vᵀ - delta) *
    scale``; P is rounded to the input type before ``Pᵀ·dO`` and dS before
    ``dS·K`` and ``dSᵀ·Q``, every product is summed in f32, and the
    gradients come back in the input type."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    dtype = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    mask = _mask(q, k, q_segment_ids, kv_segment_ids, causal)
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    delta = (o.float() * dof).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * sm_scale).to(dtype).float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _forward(q, k, v, q_seg, kv_seg, causal, sm_scale):
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, q_seg, kv_seg, causal=causal, sm_scale=sm_scale)
    return mha_reference(q, k, v, q_segment_ids=q_seg, kv_segment_ids=kv_seg, causal=causal,
                         sm_scale=sm_scale)


def _kernel_bwd_inputs(q, k, v, do):
    """q, k, v and dO as K3 and K4 take them, in either type: as they lie
    where TMA can read them (``_keeps_view``; q, k and v were held to that
    in ``_prepare``), else dO is copied: a layout copy, K3 and K4 run either
    way."""
    return q, k, v, (do if _keeps_view(do) else do.contiguous())


def _backward(q, k, v, o, lse, do, q_seg, kv_seg, causal, sm_scale):
    if q.device.type == "cuda":
        q, k, v, do = _kernel_bwd_inputs(q, k, v, do)
        # rowsum(dO * O) in f32, outside the kernels as the TPU's _bwd takes it
        delta = (o.float() * do.float()).sum(-1)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, q_seg, kv_seg, causal=causal,
                               sm_scale=sm_scale)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, q_seg, kv_seg, causal=causal,
                                    sm_scale=sm_scale)
        return dq, dk, dv
    return flash_bwd_reference(q, k, v, o, lse, do, q_seg, kv_seg, causal, sm_scale)


def _save(ctx, causal, sm_scale, *tensors):
    ctx.save_for_backward(*tensors)
    ctx.causal, ctx.sm_scale = causal, sm_scale


def _kernel_grads(ctx, do):
    """The backward of ``_Flash`` and ``_FlashWithLseSG``: K3 + K4 on the GPU."""
    q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
    dq, dk, dv = _backward(q, k, v, o, lse, do, q_seg, kv_seg, ctx.causal, ctx.sm_scale)
    return dq, dk, dv, None, None, None, None


class _Flash(torch.autograd.Function):
    """``_flash`` (JAX :376): the output alone; backward K3 + K4."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale):
        o, lse = _forward(q, k, v, q_seg, kv_seg, causal, sm_scale)
        _save(ctx, causal, sm_scale, q, k, v, o, lse, q_seg, kv_seg)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        return _kernel_grads(ctx, do)


class _FlashWithLseSG(torch.autograd.Function):
    """``_flash_with_lse_sg`` (JAX :535): ``(out, lse)`` with lse under
    stop-gradient; backward K3 + K4."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale):
        o, lse = _forward(q, k, v, q_seg, kv_seg, causal, sm_scale)
        _save(ctx, causal, sm_scale, q, k, v, o, lse, q_seg, kv_seg)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        return _kernel_grads(ctx, do)


class _FlashWithLse(torch.autograd.Function):
    """``_flash_with_lse`` (JAX :510): ``(out, lse)``, both differentiable;
    the backward is autograd of ``mha_reference`` at the saved inputs, as
    JAX's is ``jax.vjp`` of it (dense, O(Lq·Lkv) memory per head)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale):
        o, lse = _forward(q, k, v, q_seg, kv_seg, causal, sm_scale)
        _save(ctx, causal, sm_scale, q, k, v, q_seg, kv_seg)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, q_seg, kv_seg = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out, lse = mha_reference(*inputs, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                     causal=ctx.causal, sm_scale=ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad((out, lse), inputs, (do, dlse))
        return dq, dk, dv, None, None, None, None


def _prepare(q, k, v, q_segment_ids, kv_segment_ids, sm_scale):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both or neither of q/kv segment ids")
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    qkv = tuple(t if _keeps_view(t) else t.contiguous() for t in (q, k, v))
    return qkv, q_segment_ids, kv_segment_ids, float(sm_scale), needs_grad


def _keeps_view(t):
    """Whether ``t`` goes to the kernels as it lies: bf16 or f32 whose
    strides TMA can read (``tma_readable``), with or without a gradient. K2
    reads q, k and v by their strides in both types (the ``[B, H, L, D]``
    views of the encoders' ``[B, L, H, D]`` projections), as the plain
    versions do on the CPU, and K3 and K4 read q, k, v and dO so too.
    Anything else is copied to a contiguous tensor here."""
    return t.dtype in (torch.bfloat16, torch.float32) and tma_readable(t)


def flash_attention_with_lse(q, k, v, *, q_segment_ids=None, kv_segment_ids=None,
                             causal=False, sm_scale=None, lse_grad=True):
    """``(out [B, H, Lq, D], lse [B, H, Lq])``, differentiable. With
    ``lse_grad=True`` (the JAX default) the lse carries a gradient and the
    backward is the dense vjp of ``mha_reference``; with ``lse_grad=False``
    the lse is stop-gradient and the backward runs K3 and K4 on the GPU."""
    qkv, q_seg, kv_seg, sm_scale, needs_grad = _prepare(q, k, v, q_segment_ids,
                                                        kv_segment_ids, sm_scale)
    if not needs_grad:
        return _forward(*qkv, q_seg, kv_seg, causal, sm_scale)
    fn = _FlashWithLse if lse_grad else _FlashWithLseSG
    return fn.apply(*qkv, q_seg, kv_seg, causal, sm_scale)


def flash_attention(q, k, v, *, q_segment_ids=None, kv_segment_ids=None, causal=False,
                    sm_scale=None):
    """Flash attention ``[B, H, L, D] -> [B, H, Lq, D]``, differentiable; the
    backward runs K3 and K4 on the GPU."""
    qkv, q_seg, kv_seg, sm_scale, needs_grad = _prepare(q, k, v, q_segment_ids,
                                                        kv_segment_ids, sm_scale)
    if not needs_grad:
        return _forward(*qkv, q_seg, kv_seg, causal, sm_scale)[0]
    return _Flash.apply(*qkv, q_seg, kv_seg, causal, sm_scale)


def flash_attention_padded(q, k, v, *, padding_mask=None, sm_scale=None):
    """Self-attention for any sequence length ``[B, H, L, D]``, non-causal,
    differentiable.

    ``padding_mask [B, L]`` True = masked key (torchscale semantics): masked
    keys form their own segment, so a real query never attends one. The JAX
    wrapper pads L to a multiple of 128 first; the kernels mask the ragged
    edge by bounds instead, so no pad rows exist. The outputs, and the
    gradients of real queries and keys, agree on every query that
    ``padding_mask`` does not mask (and on all rows when L is a multiple of
    128); a masked query's row, which callers discard, differs because the
    JAX pad keys join its segment."""
    if k.shape[2] != q.shape[2]:
        raise ValueError("flash_attention_padded is self-attention-shaped "
                         f"(Lq == Lkv); got {q.shape[2]} vs {k.shape[2]}")
    if padding_mask is None:
        return flash_attention(q, k, v, sm_scale=sm_scale)
    seg = (~padding_mask).to(torch.int32)  # real = 1, masked = 0
    return flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, sm_scale=sm_scale)
