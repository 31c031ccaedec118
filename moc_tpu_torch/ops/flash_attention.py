"""Flash attention with log-sum-exp output (PyTorch port of
``moc_tpu/ops/flash_attention.py``, forward only).

All shapes ``[B, H, L, D]``. CUDA tensors go to kernel K2
(``ops.flash_kernel.flash_fwd_cuda``), CPU tensors to its plain version
``mha_reference``; nothing else chooses between them. Masked keys (causal,
top-left aligned, or of another segment) take ``DEFAULT_MASK_VALUE`` rather
than ``-inf`` and still count in the softmax, so a query row that matches no
key gives the mean of V and ``lse == DEFAULT_MASK_VALUE``, as in the JAX
package.

Unlike the JAX package, which sends lengths that are not a multiple of 128
to its dense reference, K2 takes any length: the vision trunk's 785 tokens
run on the kernel without padding. The backward (K3, K4) waits for the
training slice, so on the GPU these functions are inference only.
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(q, k, v, *, q_segment_ids=None, kv_segment_ids=None, causal=False,
                  sm_scale=None):
    """Plain attention returning ``(out, lse)``: K2's plain version. The
    scores are formed in the input type and summed in f32 from there, as
    the JAX reference does."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    lq, lkv = q.shape[2], k.shape[2]
    mask = None
    if causal:
        # top-left aligned: query i sees keys 0..i in absolute position
        mask = (torch.arange(lkv, device=q.device)[None, :]
                <= torch.arange(lq, device=q.device)[:, None])[None, None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", (p / l).to(q.dtype), v)
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_with_lse(q, k, v, *, q_segment_ids=None, kv_segment_ids=None,
                             causal=False, sm_scale=None):
    """``(out [B, H, Lq, D], lse [B, H, Lq])``: K2 on the GPU, the plain
    version on the CPU."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both or neither of q/kv segment ids")
    if q.device.type == "cuda":
        return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              q_segment_ids, kv_segment_ids, causal=causal,
                              sm_scale=float(sm_scale))
    return mha_reference(q, k, v, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, causal=causal, sm_scale=sm_scale)


def flash_attention(q, k, v, *, q_segment_ids=None, kv_segment_ids=None, causal=False,
                    sm_scale=None):
    """Flash attention ``[B, H, L, D] -> [B, H, Lq, D]``."""
    return flash_attention_with_lse(q, k, v, q_segment_ids=q_segment_ids,
                                    kv_segment_ids=kv_segment_ids, causal=causal,
                                    sm_scale=sm_scale)[0]


def flash_attention_padded(q, k, v, *, padding_mask=None, sm_scale=None):
    """Self-attention for any sequence length ``[B, H, L, D]``, non-causal.

    ``padding_mask [B, L]`` True = masked key (torchscale semantics): masked
    keys form their own segment, so a real query never attends one. The JAX
    wrapper pads L to a multiple of 128 first; K2 masks the ragged edge by
    bounds instead, so no pad rows exist. The outputs agree on every query
    that ``padding_mask`` does not mask (and on all rows when L is a
    multiple of 128); a masked query's row, which callers discard, differs
    because the JAX pad keys join its segment."""
    if k.shape[2] != q.shape[2]:
        raise ValueError("flash_attention_padded is self-attention-shaped "
                         f"(Lq == Lkv); got {q.shape[2]} vs {k.shape[2]}")
    if padding_mask is None:
        return flash_attention(q, k, v, sm_scale=sm_scale)
    seg = (~padding_mask).to(torch.int32)  # real = 1, masked = 0
    return flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, sm_scale=sm_scale)
