"""The collectives the JAX package takes from ``lax``, on ``torch.distributed``,
each differentiable: ``ppermute``, ``all_gather``, ``all_to_all``, ``psum``,
``axis_index`` and ``axis_size``, over an :class:`~moc_tpu_torch.parallel.mesh.Axis`
(or an axis name of the active mesh).

Gradients follow the SPMD convention of JAX's autodiff: each rank's
objective is a share, the shares sum to the global objective, and each
collective's backward is its transpose under that sum. So ``ppermute``'s
backward is the reverse permutation, ``all_gather``'s a reduce-scatter,
``all_to_all``'s the inverse ``all_to_all`` and ``psum``'s a ``psum``. A
caller whose loss is replicated on several ranks counts it once among
them (``train.pretrain`` divides each rank's share by the replicas).

Transport is the backend's, never a fallback: NCCL moves device tensors as
they are; gloo moves host tensors only, so under gloo a CUDA tensor is
copied to host memory, exchanged and copied back, here and nowhere else
(``runtime.transport()`` names it). An axis of one rank moves nothing.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from moc_tpu_torch.parallel import runtime
from moc_tpu_torch.parallel.mesh import Axis, resolve_axis


def _staged(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the backend moves it: on the host under gloo, as it is under NCCL."""
    x = x.contiguous()
    if runtime.backend() == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x


def _empty(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def axis_index(axis) -> int:
    return resolve_axis(axis).index


def axis_size(axis) -> int:
    return resolve_axis(axis).size


# -------------------------------------------------------------- the exchanges

def _ppermute(x: torch.Tensor, ax: Axis, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` to ``dst`` for ``(me, dst)`` in ``perm``; return what the
    ``(src, me)`` pair sends here, or zeros when no pair names this rank."""
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if ax.size == 1 or (dst == [me] and src == [me]):
        return x.clone() if src else torch.zeros_like(x)
    send = _staged(x)
    recv = _empty(send, send.shape) if src else None
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send, ax.ranks[dst[0]], ax.group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, ax.ranks[src[0]], ax.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if recv is None:
        return torch.zeros_like(x)
    return recv.to(x.device)


def _all_gather0(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[n, ...]`` → ``[size·n, ...]`` in rank order."""
    send = _staged(x)
    out = _empty(send, (ax.size * send.shape[0],) + tuple(send.shape[1:]))
    dist.all_gather_into_tensor(out, send, group=ax.group)
    return out.to(x.device)


def _reduce_scatter0(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[size·n, ...]`` summed over the ranks, block ``index`` kept."""
    send = _staged(x)
    out = _empty(send, (send.shape[0] // ax.size,) + tuple(send.shape[1:]))
    dist.reduce_scatter_tensor(out, send, group=ax.group)
    return out.to(x.device)


def _all_reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    buf = _staged(x)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, group=ax.group)
    return buf.to(x.device)


def _all_to_all0(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``[size·n, ...]``: block w goes to rank w; block w of the result came from rank w."""
    send = _staged(x)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=ax.group)
    return out.to(x.device)


# ------------------------------------------------------ differentiable forms

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _ppermute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.ax, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: torch.Tensor, axis, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` pairs ``(source, destination)`` of axis
    indices; a rank no pair sends to gets zeros."""
    return _PPermute.apply(x, resolve_axis(axis), [tuple(p) for p in perm])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_gather0(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g, ctx.ax), None


def all_gather(x: torch.Tensor, axis, dim: int = 0, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: the ranks' ``x`` stacked on a new ``dim`` (or,
    ``tiled``, concatenated along ``dim``), in axis order."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x if tiled else x.unsqueeze(dim)
    moved = x.movedim(dim, 0)
    out = _AllGather.apply(moved, ax)  # [size·n, ...]
    if tiled:
        return out.movedim(0, dim)
    out = out.reshape((ax.size, moved.shape[0]) + tuple(moved.shape[1:]))
    return out.movedim(1, dim + 1).movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_to_all0(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all0(g, ctx.ax), None


def all_to_all(x: torch.Tensor, axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` cut into ``size`` blocks along
    ``split_dim``, block w sent to rank w, the blocks received concatenated
    along ``concat_dim`` in axis order. Its backward is the inverse
    exchange."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    w = ax.size
    if x.shape[split_dim] % w:
        raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(x.shape)} does not "
                         f"split over {w} ranks")
    blocks = x.movedim(split_dim, 0)
    blocks = blocks.reshape((w, blocks.shape[0] // w) + tuple(blocks.shape[1:]))
    recv = _AllToAll.apply(blocks.contiguous(), ax)  # [w, n/w, ...]: block from rank w
    recv = recv.movedim(1, split_dim + 1)  # [w, *x.shape with split_dim cut]
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """``lax.psum``: the sum over the axis' ranks, on every rank."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    return _PSum.apply(x, ax)


def psum_nograd(x: torch.Tensor, axis) -> torch.Tensor:
    """``psum`` of a value no gradient flows through (counts, reported losses)."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x.detach()
    return _all_reduce(x.detach(), ax)


def all_gather_nograd(x: torch.Tensor, axis, dim: int = 0, tiled: bool = False) -> torch.Tensor:
    """``all_gather`` of a value no gradient flows through (routing masks)."""
    with torch.no_grad():
        return all_gather(x.detach(), axis, dim=dim, tiled=tiled)
