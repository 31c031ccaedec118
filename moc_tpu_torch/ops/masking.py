"""Masking helpers shared by the selection/pooling op family (PyTorch port of
``moc_tpu/ops/masking.py``).

Padded bags are ``[..., N, ...]`` tensors with a boolean ``[..., N]``
validity mask. Every top-k style op masks invalid rows to a large finite
negative (finite so that means/softmaxes never produce NaN) and corrects
reduction counts by the number of valid rows. Leading dimensions are a batch
of slides written out (the JAX package vmaps one slide instead).
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops import topk_kernel

# Large finite negative used to exclude padded rows from top-k (see the JAX
# package: count-corrected reductions never read these values).
NEG_INF = -1e30


def masked_logits(logits: torch.Tensor, valid: torch.Tensor,
                  fill: float = NEG_INF) -> torch.Tensor:
    """Replace rows of ``logits [..., N, C]`` where ``valid [..., N]`` is False
    by ``fill``."""
    return torch.where(valid[..., None], logits, fill)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``exp(x - max) / sum``: the formula of ``jax.nn.softmax``, written out
    so both packages round the same steps."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def masked_col_topk(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Column-wise top-k over valid rows: ``(values [..., k, C], indices
    [..., k, C])``, per column the row indices in descending score order with
    ties in ascending index, as ``lax.top_k`` orders them. A STABLE
    descending sort gives that order (``torch.topk`` promises no tie order on
    CUDA). It sorts the monotone rank of the raw bits, because ``lax.top_k``
    ranks −0.0 below +0.0 (it is a total order). When fewer than ``k`` rows are
    valid, trailing entries point at padded rows (score ``NEG_INF``)."""
    m = masked_logits(scores, valid)
    idx = torch.sort(monotone_u32(m), dim=-2, descending=True,
                     stable=True).indices[..., :k, :]
    return torch.gather(m, -2, idx), idx


def masked_row_margin(logits: torch.Tensor) -> torch.Tensor:
    """Per-row |top1 - top2| margin of ``logits [..., N, C]`` → ``[..., N]``
    (values only, so the tie order of ``torch.topk`` does not matter)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return torch.abs(top2[..., 0] - top2[..., 1])


def topk_mean(values: torch.Tensor, j: int, count: torch.Tensor) -> torch.Tensor:
    """Mean of the first ``min(j, count)`` rows of descending-sorted
    ``values [..., k, C]``; ``count [...]`` is the number of genuinely ranked
    rows. Rows past ``count`` are excluded with ``where`` (they may hold
    NaN/inf); a zero-valid bag returns ``NEG_INF``."""
    k = values.shape[-2]
    count = count.to(torch.int64)
    eff = torch.clamp(torch.clamp(count, max=j), min=1)
    pos = torch.arange(k, device=values.device)[:, None]
    picked = torch.where(pos < eff[..., None, None], values, 0.0)
    mean = picked.sum(-2) / eff[..., None].to(values.dtype)
    return torch.where(count[..., None] > 0, mean, NEG_INF)


def bottomk_bg_key(logits_ext: torch.Tensor, valid: torch.Tensor,
                   n_fg: int) -> torch.Tensor:
    """THE bottom-k stage-1 ranking key: negated background-logit sum of
    ``logits_ext [..., N, C_ext]``, invalid rows pushed to the end with
    ``NEG_INF`` (ascending-bg order == descending key order)."""
    return torch.where(valid, -torch.sum(logits_ext[..., n_fg:], dim=-1), NEG_INF)


def bottomk_stage_valid(kb: int, valid: torch.Tensor) -> torch.Tensor:
    """Stage-2 row validity ``[..., kb]`` for a bottom-k gather: positions
    past the number of valid rows point at pad rows and are masked."""
    bk_count = torch.clamp(valid.sum(-1), max=kb)
    return torch.arange(kb, device=valid.device) < bk_count[..., None]


def monotone_u32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 → u32 rank map (the radix-sort trick: flip all
    bits of negatives, set the sign bit of non-negatives), held in int64
    because CPU torch cannot compare uint32. A total order: −0.0 ranks below
    +0.0 unless the caller adds ``+0.0`` first."""
    i = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    # negative: ~bits as u32 == -1 - i;  non-negative: bits | 2^31 == i + 2^31
    return torch.where(i < 0, -1 - i, i + 2 ** 31)


def threshold_topk_mask(keys: torch.Tensor, k: int, axis: int = -1) -> torch.Tensor:
    """Exact top-k MEMBERSHIP mask along ``axis``: the set ``top_k`` selects,
    ties at the k-th value going to the lowest index; exactly ``k`` True per
    slice. The plain PyTorch version of kernel K1
    (``ops/topk_kernel.py``): a 32-step bit descent to the k-th largest value
    ``v_k`` in the monotone rank space, then the keys above ``v_k`` plus the
    first ``k − #above`` keys equal to it, in index order. ``+0.0`` first so
    −0.0 ties +0.0, as float comparison does."""
    u = monotone_u32(keys + 0.0).movedim(axis, -1)
    t = torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
    for b in range(31, -1, -1):
        cand = t | (1 << b)
        cnt = (u > cand[..., None]).sum(-1)
        t = torch.where(cnt >= k, cand, t)
    # t is the largest T with #(u > T) >= k, so v_k = T + 1; when fewer than
    # k keys lie above the minimum rank 0, v_k is the minimum itself
    have = (u > 0).sum(-1) >= k
    vk = torch.where(have, t + 1, 0)[..., None]
    above = u > vk
    fill = k - above.sum(-1, keepdim=True)
    tie = u == vk
    rank = torch.cumsum(tie, dim=-1)
    return (above | (tie & (rank <= fill))).movedim(-1, axis)


def masked_col_topk_mask(scores: torch.Tensor, valid: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Column-wise exact top-k MEMBERSHIP mask over valid rows of
    ``scores [..., N, C]`` — the set ``masked_col_topk`` selects (ties →
    lowest row). Bool ``[..., N, C]``, exactly ``k`` True per column (padded
    rows included when fewer than ``k`` are valid — AND with ``valid`` to
    drop). CPU tensors take the plain version; any other device goes to
    kernel K1, which raises unless it is CUDA."""
    m = masked_logits(scores, valid)
    if m.device.type == "cpu":
        return threshold_topk_mask(m, k, axis=-2)
    return topk_kernel.col_topk_threshold_mask_cuda(m, k)

