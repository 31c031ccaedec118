"""LongNet dilated attention on one device, with lse recombination (PyTorch
port of ``moc_tpu/parallel/dilated.py``).

For each (segment length sl, dilation ratio dr) branch the sequence is cut
into sl-token segments; within a segment the heads fall into dr groups and
group r keeps every dr-th token from offset r (``dense_to_sparse``); each
segment's sparse tokens attend among themselves through
``ops.flash_attention`` (K2 forward, and K3/K4 backward where the lse
carries no gradient, on the GPU); the outputs scatter back to full length
with the uncovered positions' lse at ``NEG_LSE`` (``sparse_to_dense``); the
branches are averaged with softmax-of-lse weights taken without gradient.

Padding the sequence to a segment multiple, or a segment to a ratio
multiple, adds zero keys; each scores 0 and adds exactly 1 to its softmax
denominator, which ``_pad_correction`` removes from the output and the lse.
Only then does the lse feed the output, so only then does the branch take
the dense backward of ``flash_attention_with_lse(lse_grad=True)``.

Across shards (``axis_name`` names a sequence-sharded mesh axis and a
segment is longer than the local sequence) a segment spans ``rps = min(sl
// L_local, world)`` ranks. ``gather_mode="allgather"`` gathers the group's
sparse K/V blocks (``collectives.all_gather``, whose backward is a
reduce-scatter) and attends them on each rank: without ``causal`` as one
block, under ``causal`` block by block (``_causal_gathered``: earlier
blocks whole, the own block locally causal, later blocks left out), merged
by lse. ``gather_mode="ring"`` rotates the blocks around the group instead
(``ring.ring_segment``), one block resident at a time. Both run K2 per
block forward and K3/K4 per block backward (``ring.blockwise_attention``
and ``ring.ring_segment``), with every block's zero pad keys taken out;
with ``use_flash`` False both take the plain route (``mha_reference`` per
block under autograd), as JAX's ``_causal_gathered`` and ``_ring_segment`` do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from moc_tpu_torch.ops.flash_attention import flash_attention_with_lse, mha_reference
from moc_tpu_torch.parallel import collectives
from moc_tpu_torch.parallel.mesh import resolve_axis
from moc_tpu_torch.parallel.ring import _pad_correction, blockwise_attention, ring_segment

NEG_LSE = -1e8


@dataclasses.dataclass(frozen=True)
class DilatedConfig:
    segment_lengths: tuple[int, ...] = (2048, 4096, 8192, 16384, 32768)
    dilated_ratios: tuple[int, ...] = (1, 2, 4, 6, 12)
    # False = mha_reference (the plain route) for segments within a shard;
    # cross-shard segments run the blockwise path (K2-K4 on the GPU)
    use_flash: bool = True
    # cross-shard K/V movement: "allgather" (the group's blocks at once) or
    # "ring" (one block resident, rotated by ppermute); the same numbers
    gather_mode: str = "allgather"


def _pad_to(x: torch.Tensor, axis: int, multiple: int):
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, 0
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
    return F.pad(x, widths), pad


def dense_to_sparse(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """``[B, L, H, D] -> [B, ⌈L/r⌉, H, D]``: head group r keeps the tokens at
    offset r of every stride r (a diagonal gather over token offset and head
    group)."""
    if ratio == 1:
        return x
    b, l, h, d = x.shape
    x, _ = _pad_to(x, 1, ratio)
    x, _ = _pad_to(x, 2, ratio)
    lr, h2 = x.shape[1] // ratio, x.shape[2] // ratio
    x6 = x.reshape(b, lr, ratio, ratio, h2, d)  # l = (lr r1), heads = (r2 h2)
    diag = torch.diagonal(x6, dim1=2, dim2=3)  # [b, lr, h2, d, r]
    return diag.permute(0, 1, 4, 2, 3).reshape(b, lr, ratio * h2, d)[:, :, :h]


def sparse_to_dense(out: torch.Tensor, lse: torch.Tensor, ratio: int):
    """``out [B, Ls, H, D]``, ``lse [B, H, Ls]`` → ``([B, H, Ls·r, D], [B, H,
    Ls·r])``, the positions a head group does not cover zero / ``NEG_LSE``."""
    if ratio == 1:
        return out.transpose(1, 2), lse
    b, ls, h, d = out.shape
    out, _ = _pad_to(out, 2, ratio)
    lse, _ = _pad_to(lse.transpose(1, 2), 2, ratio)  # [B, Ls, H_pad]
    h2 = out.shape[2] // ratio
    out_r = out.reshape(b, ls, ratio, h2, d)
    lse_r = lse.reshape(b, ls, ratio, h2)
    dense = out.new_zeros((b, ratio, h2, ls, ratio, d))
    lse_dense = lse.new_full((b, ratio, h2, ls, ratio), NEG_LSE)
    for r in range(ratio):
        dense[:, r, :, :, r, :] = out_r[:, :, r].transpose(1, 2)
        lse_dense[:, r, :, :, r] = lse_r[:, :, r].transpose(1, 2)
    dense = dense.reshape(b, ratio * h2, ls * ratio, d)
    lse_dense = lse_dense.reshape(b, ratio * h2, ls * ratio)
    return dense[:, :h], lse_dense[:, :h]


def _pad_key_counts(sl_local: int, dr: int, seq_pad: int, n_seg: int, h: int) -> np.ndarray:
    """``[n_seg, h]`` int32: the zero pad keys each segment's sparse attention
    shows each head (the sequence tail of the last segment, and the ratio
    padding inside ``dense_to_sparse``)."""
    l_pad = -(-sl_local // dr) * dr
    h_pad = -(-h // dr) * dr
    h2 = h_pad // dr
    counts = np.zeros((n_seg, h), np.int32)
    for seg in range(n_seg):
        extra = seq_pad if seg == n_seg - 1 else 0
        pads = range(sl_local - extra, l_pad)
        for hh in range(h):
            j = hh // h2
            counts[seg, hh] = sum(1 for p in pads if p % dr == j)
    return counts


def _cross_shard(qf, kf, vf, sl, l, causal, axis_name, gather_mode, n_pad_blk, use_flash):
    """A segment over ``rps`` ranks of ``axis_name``: ``qf, kf, vf [B·n, H,
    ls, D]`` are this rank's sparse blocks; returns ``(out, lse)`` for its
    queries against the whole segment (K2–K4, or the plain route when not
    ``use_flash``)."""
    ax = resolve_axis(axis_name)
    world = ax.size
    rps = min(sl // l, world)
    if world % rps:
        raise ValueError(
            f"dilated CP needs the axis size ({world}) divisible by ranks_per_segment ({rps} "
            f"= min({sl}//{l}, world)); pick segment lengths that tile the axis")
    p = ax.index % rps
    if gather_mode == "ring":
        return ring_segment(qf, kf, vf, ax, rps, causal=causal, n_pad=n_pad_blk,
                            use_flash=use_flash)
    if gather_mode != "allgather":
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    start = (ax.index // rps) * rps
    # K and V in one gather, so one backward exchange whatever each rank's schedule
    kvg = collectives.all_gather(torch.stack((kf, vf)), ax)[start : start + rps]
    kg, vg = kvg[:, 0], kvg[:, 1]  # [rps, B·n, H, ls, D]
    if causal:
        schedule = [(p, True)] + [(r, False) for r in range(p)]
        return blockwise_attention(qf, kg, vg, schedule, n_pad=n_pad_blk, use_flash=use_flash)
    # the whole group as one block: [B·n, H, rps·ls, D]
    kcat = kg.permute(1, 2, 0, 3, 4).flatten(2, 3)[None]
    vcat = vg.permute(1, 2, 0, 3, 4).flatten(2, 3)[None]
    n_pad = None if n_pad_blk is None else rps * n_pad_blk
    return blockwise_attention(qf, kcat, vcat, [(0, False)], n_pad=n_pad, use_flash=use_flash)


def _branch(q, k, v, sl, dr, causal, use_flash, axis_name, gather_mode="allgather"):
    """One (segment length, ratio) branch → ``(out [B, H, L, D], lse [B, H, L])``."""
    b, l, h, d = q.shape
    sl_local = min(sl, l)
    qp, pad = _pad_to(q, 1, sl_local)
    kp, _ = _pad_to(k, 1, sl_local)
    vp, _ = _pad_to(v, 1, sl_local)
    n_seg = qp.shape[1] // sl_local

    def segment_sparse(x):
        return dense_to_sparse(x.reshape(b * n_seg, sl_local, h, d), dr)

    qf, kf, vf = (segment_sparse(t).transpose(1, 2) for t in (qp, kp, vp))  # [B·n, H, ls, D]
    counts = _pad_key_counts(sl_local, dr, pad, n_seg, h)
    n_pad_blk = None
    if counts.any():
        n_pad_blk = torch.as_tensor(np.tile(counts, (b, 1)), dtype=torch.float32,
                                    device=q.device)[:, :, None]
    correct = n_pad_blk is not None and not causal
    if axis_name is not None and sl > l:
        # pad keys are taken out block by block inside
        out, lse = _cross_shard(qf, kf, vf, sl, l, causal, axis_name, gather_mode, n_pad_blk,
                                use_flash)
        correct = False
    elif use_flash:
        # the lse feeds the output only through a pad correction; elsewhere it
        # reaches the stop-gradient branch weights alone, and K3/K4 serve
        out, lse = flash_attention_with_lse(qf, kf, vf, causal=causal, lse_grad=correct)
    else:
        out, lse = mha_reference(qf, kf, vf, causal=causal)
    # causal needs no correction: pad keys sit after every real query
    if correct:
        out, lse = _pad_correction(out, lse, n_pad_blk)
    dense, lse_dense = sparse_to_dense(out.transpose(1, 2), lse, dr)
    dense = dense[:, :, :sl_local]
    lse_dense = lse_dense[:, :, :sl_local]
    dense = dense.reshape(b, n_seg, h, sl_local, d).transpose(1, 2)
    dense = dense.reshape(b, h, n_seg * sl_local, d)[:, :, :l]
    lse_full = lse_dense.reshape(b, n_seg, h, sl_local).transpose(1, 2)
    lse_full = lse_full.reshape(b, h, n_seg * sl_local)[:, :, :l]
    return dense, lse_full


def dilated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: DilatedConfig = DilatedConfig(), *, causal: bool = False,
                      axis_name: str | None = None) -> torch.Tensor:
    """Multi-branch dilated attention: ``q, k, v [B, L, H, D]`` → ``[B, L,
    H·D]``, the branches averaged with softmax(lse) weights taken without
    gradient (JAX's ``stop_gradient``)."""
    if len(cfg.segment_lengths) != len(cfg.dilated_ratios):
        raise ValueError("DilatedConfig needs one ratio per segment length")
    outs, lses = [], []
    for sl, dr in zip(cfg.segment_lengths, cfg.dilated_ratios):
        o, s = _branch(q, k, v, sl, dr, causal, cfg.use_flash, axis_name, cfg.gather_mode)
        outs.append(o)
        lses.append(s)
    weights = torch.softmax(torch.stack(lses).detach(), dim=0)  # [n_branch, B, H, L]
    combined = sum(w[..., None] * o for w, o in zip(weights, outs))  # [B, H, L, D]
    b, h, l, d = combined.shape
    return combined.transpose(1, 2).reshape(b, l, h * d)
