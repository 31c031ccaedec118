"""Patch index-selection policies as boolean masks, their union, and the
fixed-capacity gather (PyTorch port of ``moc_tpu/ops/selection.py``).

Each policy returns a boolean ``[..., N]`` mask over the padded bag, and the
union is their OR. Two exact unions give the same set wherever no key ties
+0.0 with −0.0:

* the threshold path (``union_selection_threshold``): every key row but the
  bottom-k one goes through ONE launch of the exact top-k membership kernel
  K1 (``ops.topk_kernel``), which ranks −0.0 equal to +0.0 (ties → lowest
  index), as float comparison does;
* the sort path (``union_selection``, ``select_and_gather(method="sort")``):
  ``top_k`` ranks every key row, a total order with −0.0 below +0.0, as
  ``lax.top_k`` does.

Each matches the JAX package's path of the same name bit for bit.
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops import topk_kernel
from moc_tpu_torch.ops.masking import (NEG_INF, bottomk_bg_key, bottomk_stage1,
                                       bottomk_stage_valid, gather_rows, masked_col_topk,
                                       masked_row_margin, softmax, threshold_topk_mask,
                                       top_k, topk_fn)


def _scatter_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean ``[..., n]`` mask, True at every index of ``idx [..., m]``;
    an index equal to ``n`` (the out-of-range sentinel) is dropped."""
    hit = torch.zeros(idx.shape[:-1] + (n + 1,), dtype=torch.bool, device=idx.device)
    return hit.scatter_(-1, idx, True)[..., :n]


def select_topj(logits: torch.Tensor, valid: torch.Tensor, topj: int,
                approx: bool = False) -> torch.Tensor:
    """Union of the per-class top-j rows of raw logits ``[..., N, C]``."""
    n = logits.shape[-2]
    _, idx = masked_col_topk(logits, valid, min(topj, n), approx)
    return _scatter_mask(idx.flatten(-2), n) & valid


def select_delta_softmax(logits: torch.Tensor, valid: torch.Tensor, topj: int,
                         approx: bool = False) -> torch.Tensor:
    """Union of the per-class top-j rows of row-softmaxed logits."""
    n = logits.shape[-2]
    _, idx = masked_col_topk(softmax(logits, dim=-1), valid, min(topj, n), approx)
    return _scatter_mask(idx.flatten(-2), n) & valid


def select_delta_diff(logits: torch.Tensor, valid: torch.Tensor, topj: int,
                      approx: bool = False) -> torch.Tensor:
    """Top-j rows by |top1 − top2| margin."""
    n = logits.shape[-2]
    margin = torch.where(valid, masked_row_margin(logits), NEG_INF)
    _, row_idx = topk_fn(approx)(margin, min(topj, n))
    return _scatter_mask(row_idx, n) & valid


def select_bottomk_irrel(logits_ext: torch.Tensor, valid: torch.Tensor, topj: int,
                         n_fg: int, bottomk: int | None = None, detection: bool = False,
                         approx: bool = False) -> torch.Tensor:
    """Two stages: the ``bottomk`` rows of least summed background logit,
    then the per-class top-j of the foreground logits among them. Under
    ``detection`` the foreground is column 0 beside the row's top-1
    background logit."""
    n = logits_ext.shape[-2]
    kb = min(topj if bottomk is None else bottomk, n)
    fg_rows, bk_idx, stage_valid = bottomk_stage1(logits_ext, valid, n_fg, kb, detection,
                                                  approx)
    _, idx2 = masked_col_topk(fg_rows, stage_valid, min(topj, kb), approx)
    sel_stage = _scatter_mask(idx2.flatten(-2), kb) & stage_valid
    return _scatter_mask(torch.where(sel_stage, bk_idx, n), n) & valid


def union_selection_composed(logits: torch.Tensor, logits_ext: torch.Tensor,
                             valid: torch.Tensor, topj: int, n_classes: int,
                             discard: tuple[str, ...] = (),
                             approx: bool = False) -> torch.Tensor:
    """The OR of the per-policy masks, one ranking per policy (the oracle
    of ``union_selection``)."""
    sel = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    if "topk" not in discard:
        sel = sel | select_topj(logits, valid, topj, approx)
    if "delta_softmax" not in discard:
        sel = sel | select_delta_softmax(logits, valid, topj, approx)
    if "delta_diff" not in discard:
        sel = sel | select_delta_diff(logits, valid, topj, approx)
    if "bottomk" not in discard:
        sel = sel | select_bottomk_irrel(logits_ext, valid, topj, n_classes, approx=approx)
    return sel


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
    fg_rows = gather_rows(logits_ext[..., :n_classes], bk_idx)
    _, idx2 = masked_col_topk(fg_rows, stage_valid, min(topj, k))  # [..., k2, C]
    sel_stage = _scatter_mask(idx2.flatten(-2), k) & stage_valid
    return torch.where(sel_stage, bk_idx, n)


def _policy_candidates(logits: torch.Tensor, logits_ext: torch.Tensor,
                       valid: torch.Tensor, topj: int, n_classes: int,
                       discard: tuple[str, ...], approx: bool) -> torch.Tensor:
    """Candidate row indices ``[..., M]`` of all four policies, duplicates
    included, from one ``top_k`` over the stacked ``[..., n_keys, N]`` keys;
    entries that point at invalid rows become the sentinel ``N``."""
    n = logits.shape[-2]
    k = min(topj, n)
    stacked, bottomk = _stacked_policy_keys(logits, logits_ext, valid, n_classes, discard)
    if stacked is None:
        return torch.zeros(valid.shape[:-1] + (0,), dtype=torch.int64, device=valid.device)
    _, idx = topk_fn(approx)(stacked, k)  # [..., n_keys, k]
    if bottomk:  # the last key row feeds stage 2; the rest go straight in
        bk_orig = _bottomk_stage2(idx[..., -1, :], bottomk_stage_valid(k, valid), logits_ext,
                                  n_classes, topj, k, n)
        cand = torch.cat([idx[..., :-1, :].flatten(-2), bk_orig], dim=-1)
    else:
        cand = idx.flatten(-2)
    # rankings beyond the number of valid rows point at NEG_INF (pad) rows
    hit = torch.gather(valid, -1, torch.clamp(cand, max=n - 1)) & (cand < n)
    return torch.where(hit, cand, n)


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
    position), so that one key row takes ``top_k`` instead of the
    membership kernel, as in the JAX package."""
    n = logits.shape[-2]
    k = min(topj, n)
    stacked, bottomk = _stacked_policy_keys(logits, logits_ext, valid,
                                            n_classes, discard)
    if stacked is None:
        return torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    if not bottomk:
        return topk_threshold_mask(stacked, k).any(-2) & valid
    if stacked.shape[-2] > 1:
        union = topk_threshold_mask(stacked[..., :-1, :], k).any(-2)
    else:
        union = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    _, bk_idx = top_k(stacked[..., -1, :], k)
    bk_orig = _bottomk_stage2(bk_idx, bottomk_stage_valid(k, valid), logits_ext,
                              n_classes, topj, k, n)
    return (union | _scatter_mask(bk_orig, n)) & valid


def union_selection(logits: torch.Tensor, logits_ext: torch.Tensor, valid: torch.Tensor,
                    topj: int, n_classes: int, discard: tuple[str, ...] = (),
                    approx: bool = False) -> torch.Tensor:
    """OR-union of the four selection policies as a boolean ``[..., N]``
    mask on the sort path, bit-identical to ``moc_tpu.ops.union_selection``
    and to ``union_selection_composed``: one ``top_k`` over every key row
    and one scatter."""
    cand = _policy_candidates(logits, logits_ext, valid, topj, n_classes, discard, approx)
    return _scatter_mask(cand, logits.shape[-2]) & valid


def selection_capacity(topj: int, n_classes: int, n: int | None = None) -> int:
    """Static upper bound on the union size: topj*C (topj policy) + topj*C
    (delta_softmax) + topj (delta_diff) + topj (bottomk, ≤ bottom-k rows)."""
    cap = topj * n_classes * 2 + topj * 2
    if n is not None:
        cap = min(cap, n)
    return cap


def gather_selected(selected: torch.Tensor, capacity: int):
    """Pack a boolean selection ``selected [..., N]`` into fixed-size buffers:
    ``(idx [..., cap], sel_valid [..., cap], count [...])`` with ``idx`` the
    selected rows in ascending order, 0 past ``count``; ``cap = min(capacity,
    N)``. No host synchronisation: a cumsum ranks the selected rows, and a
    scatter puts each at its rank (the rest, and any beyond ``cap``, land in
    a dropped slot)."""
    n = selected.shape[-1]
    cap = min(capacity, n)
    c = torch.cumsum(selected.to(torch.int64), dim=-1)
    count = c[..., -1]
    dest = torch.where(selected & (c <= cap), c - 1, cap)
    pos = torch.arange(n, device=selected.device).expand(selected.shape)
    idx = torch.zeros(selected.shape[:-1] + (cap + 1,), dtype=torch.int64,
                      device=selected.device).scatter_(-1, dest, pos)[..., :cap]
    sel_valid = torch.arange(cap, device=selected.device) < count[..., None]
    return idx, sel_valid, count


def select_and_gather(logits: torch.Tensor, logits_ext: torch.Tensor, valid: torch.Tensor,
                      topj: int, n_classes: int, capacity: int,
                      discard: tuple[str, ...] = (), approx: bool = False,
                      method: str = "sort"):
    """The union of the four policies packed into ``(idx [..., cap],
    sel_valid [..., cap], count [...])``, ``cap = min(capacity, N)``, as
    ``gather_selected`` packs it; the JAX package's signature and default.

    ``method="threshold"``: ``union_selection_threshold`` packed by
    ``gather_selected``. ``method="sort"``: dedup in CANDIDATE space
    (~2·topj·(C+1) entries) instead of bag space: sort the candidates
    (sentinel ``N`` entries sink to the end), keep first occurrences, and
    compact them by a prefix sum."""
    if method == "threshold" and not approx:
        mask = union_selection_threshold(logits, logits_ext, valid, topj, n_classes, discard)
        return gather_selected(mask, capacity)
    if method not in ("threshold", "sort"):
        raise ValueError(f"unknown selection method {method!r}")
    n = logits.shape[-2]
    cap = min(capacity, n)
    cand = torch.sort(_policy_candidates(logits, logits_ext, valid, topj, n_classes, discard,
                                         approx), dim=-1).values
    first = torch.ones_like(cand, dtype=torch.bool)
    first[..., 1:] = cand[..., 1:] != cand[..., :-1]
    first &= cand < n
    rank = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    dest = torch.where(first & (rank < cap), rank, cap)
    idx = torch.zeros(valid.shape[:-1] + (cap + 1,), dtype=torch.int64,
                      device=valid.device).scatter_(-1, dest, cand)[..., :cap]
    count = first.sum(-1)
    return idx, torch.arange(cap, device=valid.device) < count[..., None], count
