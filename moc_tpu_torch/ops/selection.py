"""Patch index-selection union as a boolean mask (PyTorch port of the
threshold path of ``moc_tpu/ops/selection.py``).

All four policies (top-j, delta-softmax, delta-diff, bottom-k-irrelevant)
reduce to "top-k rows of some ``[N]`` key vector". Their keys stack into one
``[..., n_keys, N]`` matrix, and every row but the bottom-k one goes through
ONE launch of the exact top-k membership kernel K1 (``ops.topk_kernel``).
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops import topk_kernel
from moc_tpu_torch.ops.masking import (NEG_INF, bottomk_bg_key,
                                       bottomk_stage_valid, masked_col_topk,
                                       masked_row_margin, monotone_u32, softmax,
                                       threshold_topk_mask)


def _stacked_policy_keys(logits, logits_ext, valid, n_classes, discard):
    """Stack every policy key of ``logits [..., N, C]`` into one
    ``[..., n_keys, N]`` matrix (bottom-k key last)."""
    keys = []
    if "topk" not in discard:
        keys.append(torch.where(valid[..., None, :], logits.transpose(-1, -2),
                                NEG_INF))  # [..., C, N]
    if "delta_softmax" not in discard:
        probs = softmax(logits, dim=-1)
        keys.append(torch.where(valid[..., None, :], probs.transpose(-1, -2),
                                NEG_INF))  # [..., C, N]
    if "delta_diff" not in discard:
        margin = torch.where(valid, masked_row_margin(logits), NEG_INF)
        keys.append(margin[..., None, :])  # [..., 1, N]
    bottomk = "bottomk" not in discard
    if bottomk:
        keys.append(bottomk_bg_key(logits_ext, valid, n_classes)[..., None, :])
    if not keys:
        return None, bottomk
    return torch.cat([x.to(torch.float32) for x in keys], dim=-2), bottomk


def _bottomk_stage2(bk_idx, stage_valid, logits_ext, n_classes, topj, k, n):
    """Per-class top-j of the foreground logits among the (rank-ordered)
    bottom-k rows ``bk_idx [..., k]``; returns original-row indices with the
    out-of-range sentinel ``n``."""
    fg = logits_ext[..., :n_classes]
    fg_rows = torch.gather(fg, -2, bk_idx[..., None].expand(*bk_idx.shape, n_classes))
    _, idx2 = masked_col_topk(fg_rows, stage_valid, min(topj, k))  # [..., k2, C]
    sel_stage = torch.zeros(bk_idx.shape, dtype=torch.bool, device=bk_idx.device)
    sel_stage.scatter_(-1, idx2.flatten(-2), True)
    return torch.where(sel_stage & stage_valid, bk_idx, n)


def topk_threshold_mask(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k membership mask per row of ``keys [..., N]`` (ties →
    lowest index). CPU tensors take the plain version
    (``masking.threshold_topk_mask``); any other device goes to kernel K1 in
    one launch over all rows, which raises unless it is CUDA."""
    if keys.device.type == "cpu":
        return threshold_topk_mask(keys, k, axis=-1)
    rows = keys.reshape(-1, keys.shape[-1]).contiguous()
    return topk_kernel.topk_threshold_mask_cuda(rows, k).view(keys.shape)


def union_selection_threshold(logits: torch.Tensor, logits_ext: torch.Tensor,
                              valid: torch.Tensor, topj: int, n_classes: int,
                              discard: tuple[str, ...] = ()) -> torch.Tensor:
    """OR-union of the four selection policies as a boolean ``[..., N]``
    mask, bit-identical to ``moc_tpu.ops.union_selection_threshold``.

    ``logits [..., N, C]``, ``logits_ext [..., N, C_ext]``, ``valid [..., N]``;
    ``discard`` names follow the reference CLI flags
    ``{"topk", "delta_softmax", "delta_diff", "bottomk"}``. The bottom-k
    stage needs its rows in bg-key RANK order (stage-2 ties resolve by rank
    position), so that one key row takes a stable descending sort of its
    monotone rank instead of the membership kernel: key descending, ties in
    ascending index, −0.0 below +0.0, exactly the order ``lax.top_k`` gives."""
    n = logits.shape[-2]
    k = min(topj, n)
    stacked, bottomk = _stacked_policy_keys(logits, logits_ext, valid,
                                            n_classes, discard)
    lead = logits.shape[:-2]
    if stacked is None:
        return torch.zeros(lead + (n,), dtype=torch.bool, device=logits.device)
    if not bottomk:
        return topk_threshold_mask(stacked, k).any(-2) & valid
    if stacked.shape[-2] > 1:
        union = topk_threshold_mask(stacked[..., :-1, :], k).any(-2)
    else:
        union = torch.zeros(lead + (n,), dtype=torch.bool, device=logits.device)
    order = torch.sort(monotone_u32(stacked[..., -1, :]), dim=-1,
                       descending=True, stable=True).indices
    bk_idx = order[..., :k]
    bk_orig = _bottomk_stage2(bk_idx, bottomk_stage_valid(k, valid), logits_ext,
                              n_classes, topj, k, n)
    hit = torch.zeros(lead + (n + 1,), dtype=torch.bool, device=logits.device)
    hit.scatter_(-1, bk_orig, True)  # the sentinel n lands in the dropped slot
    return (union | hit[..., :n]) & valid


def selection_capacity(topj: int, n_classes: int, n: int | None = None) -> int:
    """Static upper bound on the union size: topj*C (topj policy) + topj*C
    (delta_softmax) + topj (delta_diff) + topj (bottomk, ≤ bottom-k rows)."""
    cap = topj * n_classes * 2 + topj * 2
    if n is not None:
        cap = min(cap, n)
    return cap
