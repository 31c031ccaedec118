"""Ring attention: attention over a sequence sharded along a mesh axis, K/V
blocks rotating from rank to rank (PyTorch port of
``moc_tpu/parallel/ring.py``).

``q, k, v [B, H, L_local, D]`` are this rank's shards; shard ``i`` holds
positions ``[i·L_local, (i+1)·L_local)``. Each rank attends its queries to
its own block, then to each block that reaches it over ``ppermute``, and
merges the partials by their log-sum-exp (``_merge_partials``). Under
``causal`` the own (diagonal) block takes the kernel's local causal case,
past blocks no mask, and future blocks are skipped, as their merge weight is
exactly zero (JAX gives them the ``-0.7·f32max`` lse and zero output): rank
``r`` runs the forward ``r+1`` times, and ``world`` times without
``causal``. On the GPU each block is one launch of K2
(``ops.flash_attention._forward``).

The backward runs K3 and K4 per block, never the dense vjp: each block's
``dq, dk, dv`` are the kernels' backward taken against the *final* merged
``(o, lse)`` and ``dO``, which is exactly the gradient of the merged
attention (the probabilities ``exp(s - lse)`` are those of the whole
softmax). ``dq`` accumulates on its rank; ``dk`` and ``dv`` travel the ring
with their K and V blocks and are home after ``world`` hops. Sums of
partials are kept in f32.

The same machinery serves dilated attention's cross-shard segments
(``parallel.dilated``): :func:`ring_segment` rotates within groups of
``group`` ranks, and :func:`blockwise_attention` merges gathered blocks on
one rank. Zero pad keys (``n_pad`` per block) are taken out of each
partial as ``_pad_correction`` does; since a pad key is a zero vector, the
kernels' backward against the corrected ``(o, lse)`` is the exact gradient
of the corrected attention. The lse these return is for recombination
weights held without gradient, and is not differentiable. With ``use_flash``
False both take the plain route of JAX's ``use_flash=False``:
``mha_reference`` per block, differentiated by autograd through the
differentiable collectives, every block attended and a future block's merge
weight zeroed (so every rank's graph, and with it the order of the
collectives' backwards, is the same).
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops.flash_attention import _backward, _forward, mha_reference
from moc_tpu_torch.parallel import collectives
from moc_tpu_torch.parallel.collectives import _ppermute
from moc_tpu_torch.parallel.mesh import Axis, resolve_axis


NEG_LSE = -0.7 * torch.finfo(torch.float32).max  # a skipped block's lse, as in JAX


def _merge_partials(out_a, lse_a, out_b, lse_b):
    """Two attention partials combined by their log-sum-exps, in f32."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    denom = wa + wb
    out = (wa[..., None] * out_a.float() + wb[..., None] * out_b.float()) / denom[..., None]
    return out, m + torch.log(denom)


def _pad_correction(out, lse, n_pad):
    """Take ``n_pad`` zero-key terms out of ``(out, lse)``: with ``S =
    exp(lse)``, ``S_real = S·frac`` for ``frac = 1 - n_pad·exp(-lse)``."""
    frac = torch.clamp(1.0 - n_pad * torch.exp(-lse), min=1e-20)
    return out / frac[..., None], lse + torch.log(frac)


def _partial(q, k, v, causal, sm_scale, n_pad, plain=False):
    """One block's ``(out, lse)``, its pad keys taken out (K2 on the GPU;
    ``mha_reference`` on the plain route)."""
    if plain:
        o, lse = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    else:
        o, lse = _forward(q, k, v, None, None, causal, sm_scale)
    if n_pad is not None:
        return _pad_correction(o.float(), lse, n_pad)
    return o.float(), lse


def _group_perm(size: int, group: int):
    """Each rank sends to the next rank of its ``group``-rank ring."""
    return [(g * group + i, g * group + (i + 1) % group)
            for g in range(size // group) for i in range(group)]


def _rotate(ax: Axis, perm, *tensors, grad=False):
    """``tensors`` one hop along the ring, in one exchange when they share a
    type; ``grad``: through the differentiable ``collectives.ppermute``."""
    if grad:
        return tuple(collectives.ppermute(torch.stack(tensors), ax, perm).unbind(0))
    if len({t.dtype for t in tensors}) == 1:
        moved = _ppermute(torch.stack(tensors), ax, perm)
        return tuple(moved.unbind(0))
    return tuple(_ppermute(t, ax, perm) for t in tensors)


def _ring_forward(q, k, v, ax, group, causal, sm_scale, n_pad, plain=False):
    p = ax.index % group
    perm = _group_perm(ax.size, group)
    # the diagonal's pad keys sit after every real query: causal needs no correction
    out, lse = _partial(q, k, v, causal, sm_scale, None if causal else n_pad, plain)
    k_blk, v_blk = k, v
    for step in range(1, group):
        k_blk, v_blk = _rotate(ax, perm, k_blk, v_blk, grad=plain)
        future = causal and (p - step) % group > p
        if future and not plain:
            continue  # a future block: zero merge weight
        o_i, l_i = _partial(q, k_blk, v_blk, False, sm_scale, n_pad, plain)
        if future:
            l_i = torch.full_like(l_i, NEG_LSE)
        out, lse = _merge_partials(out, lse, o_i, l_i)
    return out.to(q.dtype), lse


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ax, group, causal, sm_scale, n_pad):
        out, lse = _ring_forward(q, k, v, ax, group, causal, sm_scale, n_pad)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ax, ctx.group, ctx.causal, ctx.sm_scale = ax, group, causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        ax, group, causal = ctx.ax, ctx.group, ctx.causal
        p = ax.index % group
        perm = _group_perm(ax.size, group)
        dq = torch.zeros_like(q, dtype=torch.float32)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        k_blk, v_blk = k, v
        for step in range(group):
            if step:
                k_blk, v_blk = _rotate(ax, perm, k_blk, v_blk)
                dk, dv = _rotate(ax, perm, dk, dv)
            if causal and (p - step) % group > p:
                continue
            dq_i, dk_i, dv_i = _backward(q, k_blk, v_blk, out, lse, do, None, None,
                                         causal and step == 0, ctx.sm_scale)
            dq += dq_i.float()
            dk += dk_i.float()
            dv += dv_i.float()
        dk, dv = _rotate(ax, perm, dk, dv)  # the last hop home
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ring_segment(q, k, v, axis, group: int, *, causal: bool = False, sm_scale=None,
                 n_pad=None, use_flash: bool = True):
    """``(out, lse)`` of ``q [B, H, L, D]`` against the K/V blocks of its
    ``group``-rank ring along ``axis`` (rank ``i`` in group ``i // group``,
    position ``i % group``), ``causal`` by position in the group; ``n_pad``
    (broadcasting against lse) zero pad keys are taken out of every block.
    ``use_flash`` False: the plain route (``mha_reference``, autograd)."""
    ax = resolve_axis(axis)
    if ax.size % group:
        raise ValueError(f"ring groups of {group} do not tile an axis of {ax.size}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q, k, v = (t.contiguous() for t in (q, k, v))
    if not use_flash:
        return _ring_forward(q, k, v, ax, group, causal, float(sm_scale), n_pad, plain=True)
    if not _needs_grad(q, k, v):
        return _ring_forward(q, k, v, ax, group, causal, float(sm_scale), n_pad)
    return _Ring.apply(q, k, v, ax, group, causal, float(sm_scale), n_pad)


def ring_attention(q, k, v, axis_name, *, causal: bool = False, use_flash: bool = True,
                   sm_scale=None):
    """Full-sequence attention over a sequence-sharded mesh axis: ``q, k, v
    [B, H, L_local, D]`` → the local output ``[B, H, L_local, D]``; ``causal``
    masks by global position; ``use_flash`` False takes the plain route."""
    ax = resolve_axis(axis_name)
    return ring_segment(q, k, v, ax, ax.size, causal=causal, sm_scale=sm_scale,
                        use_flash=use_flash)[0]


def _blocks_forward(q, kb, vb, schedule, sm_scale, n_pad, plain=False):
    out = lse = None
    for r, causal in schedule:
        o_i, l_i = _partial(q, kb[r].contiguous(), vb[r].contiguous(), causal, sm_scale,
                            None if causal else n_pad, plain)
        out, lse = (o_i, l_i) if out is None else _merge_partials(out, lse, o_i, l_i)
    return out.to(q.dtype), lse


class _Blocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kb, vb, schedule, sm_scale, n_pad):
        out, lse = _blocks_forward(q, kb, vb, schedule, sm_scale, n_pad)
        ctx.save_for_backward(q, kb, vb, out, lse)
        ctx.schedule, ctx.sm_scale = schedule, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, kb, vb, out, lse = ctx.saved_tensors
        dq = torch.zeros_like(q, dtype=torch.float32)
        dkb = torch.zeros_like(kb, dtype=torch.float32)
        dvb = torch.zeros_like(vb, dtype=torch.float32)
        for r, causal in ctx.schedule:
            dq_i, dk_i, dv_i = _backward(q, kb[r].contiguous(), vb[r].contiguous(), out, lse,
                                         do, None, None, causal, ctx.sm_scale)
            dq += dq_i.float()
            dkb[r] += dk_i.float()
            dvb[r] += dv_i.float()
        return dq.to(q.dtype), dkb.to(kb.dtype), dvb.to(vb.dtype), None, None, None


def blockwise_attention(q, kb, vb, schedule, *, sm_scale=None, n_pad=None,
                        use_flash: bool = True):
    """``(out, lse)`` of ``q [B, H, L, D]`` against the blocks ``kb, vb [nb,
    B, H, Lb, D]`` named by ``schedule``, pairs ``(block, causal)`` merged in
    order (the first is the starting partial). Blocks with ``causal`` False
    have their ``n_pad`` zero keys taken out. Forward K2 and backward K3/K4
    per block on the GPU; ``use_flash`` False: the plain route
    (``mha_reference``, autograd)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    schedule = tuple((int(r), bool(c)) for r, c in schedule)
    q = q.contiguous()
    if not use_flash:
        return _blocks_forward(q, kb, vb, schedule, float(sm_scale), n_pad, plain=True)
    if not _needs_grad(q, kb, vb):
        return _blocks_forward(q, kb, vb, schedule, float(sm_scale), n_pad)
    return _Blocks.apply(q, kb, vb, schedule, float(sm_scale), n_pad)
