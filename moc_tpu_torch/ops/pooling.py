"""Slide-level pooling families over padded patch-logit bags (PyTorch port
of ``moc_tpu/ops/pooling.py``).

Every family maps patch logits ``[..., N, C]`` and a validity mask
``[..., N]`` to pooled slide logits ``[..., C]``: the mean of each class's
top-j logits under some ranking, count-corrected when fewer than j rows are
valid; an all-pad bag pools to ``NEG_INF``.

* ``topj``, ``delta_softmax``, ``delta_diff``, ``topj_delta_softmax``,
  ``topj_delta_diff`` rank the rows themselves (by logit, row softmax,
  |top1 − top2| margin, or a product of those with the logits);
* the ``bottomk_irrel`` families first keep the ``bottomk`` rows of least
  summed background logit, then rank their foreground logits the same ways
  (``detection`` keeps column 0 beside each row's top-1 background logit).

The foreground families pool through the exact membership mask (kernel K1
on the GPU), unless ``return_indices`` asks for the ranked rows; those and
the bottom-k families take the sorted route (``masked_col_topk``).
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops.masking import (NEG_INF, bottomk_stage1, gather_rows, masked_col_topk,
                                       masked_col_topk_mask, masked_row_margin, softmax,
                                       top_k, topk_mean)


def _masked_sel_mean(logits: torch.Tensor, sel: torch.Tensor, valid: torch.Tensor,
                     topj: int, count: torch.Tensor) -> torch.Tensor:
    """Mean of ``logits`` over the per-class membership mask ``sel [..., N, C]``
    (∩ valid), divided by ``max(min(topj, count), 1)``; all-pad bags pool to
    ``NEG_INF``."""
    keep = sel & valid[..., None]
    eff = torch.clamp(torch.clamp(count, max=topj), min=1)
    # where, not multiply: padded rows may hold NaN/inf and 0·NaN = NaN
    pooled = torch.where(keep, logits, 0.0).sum(-2) / eff[..., None].to(logits.dtype)
    return torch.where(count[..., None] > 0, pooled, NEG_INF)


def _rank_pool(ranking: torch.Tensor, logits: torch.Tensor, valid: torch.Tensor,
               topj: int, count: torch.Tensor) -> torch.Tensor:
    """Pool ``logits`` at the per-class top-j set of ``ranking`` scores
    (``[..., N, C]``, or ``[..., N, 1]`` for one ranking of whole rows), via
    the exact membership mask (kernel K1 on the GPU)."""
    sel = masked_col_topk_mask(ranking, valid, min(topj, logits.shape[-2]))
    return _masked_sel_mean(logits, sel, valid, topj, count)


def _gather_cols(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[..., r, c] = mat[..., idx[..., r, c], c]``."""
    return torch.gather(mat, -2, idx)


def _finish(values, idx, topj: int, count, return_indices: bool):
    pooled = topk_mean(values, topj, count)
    return (pooled, idx) if return_indices else pooled


def _ranked_pool(ranking, logits, valid, topj: int, return_indices: bool):
    """A foreground family: pool ``logits`` at the per-class top-j rows of
    ``ranking [..., N, C]``, on the mask route or, for ``return_indices``,
    the sorted one."""
    n_valid = valid.sum(-1)
    if not return_indices:
        return _rank_pool(ranking, logits, valid, topj, n_valid)
    _, idx = masked_col_topk(ranking, valid, min(topj, logits.shape[-2]))
    return _finish(_gather_cols(logits, idx), idx, topj, n_valid, True)


def topj_pooling(logits, valid, topj: int, *, return_indices: bool = False):
    """Mean of per-class top-j logits (reference ``topj_pooling``)."""
    if not return_indices:
        return _ranked_pool(logits, logits, valid, topj, False)
    vals, idx = masked_col_topk(logits, valid, min(topj, logits.shape[-2]))
    return _finish(vals, idx, topj, valid.sum(-1), True)


def delta_softmax_pooling(logits, valid, topj: int, *, return_indices: bool = False):
    """Rank per class by row-softmax probability; pool original logits."""
    return _ranked_pool(softmax(logits, dim=-1), logits, valid, topj, return_indices)


def delta_diff_pooling(logits, valid, topj: int, *, return_indices: bool = False):
    """Rank rows by |top1-top2| margin; pool whole rows of original logits."""
    n_valid = valid.sum(-1)
    margin = masked_row_margin(logits)
    if not return_indices:
        return _rank_pool(margin[..., None], logits, valid, topj, n_valid)
    _, row_idx = top_k(torch.where(valid, margin, NEG_INF), min(topj, logits.shape[-2]))
    vals = gather_rows(logits, row_idx)
    return _finish(vals, row_idx[..., None].expand(vals.shape), topj, n_valid, True)


def topj_delta_softmax_pooling(logits, valid, topj: int, *, return_indices: bool = False):
    """Rank per class by softmax*logits product; pool original logits."""
    return _ranked_pool(softmax(logits, dim=-1) * logits, logits, valid, topj, return_indices)


def topj_delta_diff_pooling(logits, valid, topj: int, *, return_indices: bool = False):
    """Rank per class by logits*margin product; pool original logits."""
    return _ranked_pool(logits * masked_row_margin(logits)[..., None], logits, valid, topj,
                        return_indices)


def _bottomk_family(logits, valid, topj, n_fg, bottomk, detection, return_indices, rank_fn):
    """The bottom-k-irrelevant families: stage 1 (``bottomk_stage1``), then
    rank the stage's foreground rows with ``rank_fn`` and pool their
    foreground logits; indices map back to rows of the bag."""
    kb = min(topj if bottomk is None else bottomk, logits.shape[-2])
    fg_rows, bk_idx, stage_valid = bottomk_stage1(logits, valid, n_fg, kb, detection)
    _, idx2 = masked_col_topk(rank_fn(fg_rows), stage_valid, min(topj, kb))
    idx = torch.gather(bk_idx[..., None].expand(fg_rows.shape), -2, idx2)
    count = torch.clamp(valid.sum(-1), max=min(kb, topj))  # ranked rows of the stage
    return _finish(_gather_cols(fg_rows, idx2), idx, topj, count, return_indices)


def bottomk_irrel_pooling(logits, valid, topj: int, *, n_fg: int, bottomk: int | None = None,
                          detection: bool = False, return_indices: bool = False):
    """Bottom-k by background sum, then per-class top-j of fg logits."""
    return _bottomk_family(logits, valid, topj, n_fg, bottomk, detection, return_indices,
                           rank_fn=lambda fg: fg)


def bottomk_irrel_delta_softmax_pooling(logits, valid, topj: int, *, n_fg: int,
                                        bottomk: int | None = None, detection: bool = False,
                                        return_indices: bool = False):
    """Bottom-k by background sum, then rank fg rows per class by row-softmax."""
    return _bottomk_family(logits, valid, topj, n_fg, bottomk, detection, return_indices,
                           rank_fn=lambda fg: softmax(fg, dim=-1))


def bottomk_irrel_delta_diff_pooling(logits, valid, topj: int, *, n_fg: int,
                                     bottomk: int | None = None, detection: bool = False,
                                     return_indices: bool = False):
    """Bottom-k by background sum, then rank fg rows by |top1-top2| margin."""
    return _bottomk_family(logits, valid, topj, n_fg, bottomk, detection, return_indices,
                           rank_fn=lambda fg: masked_row_margin(fg)[..., None].expand(fg.shape))


def topj_bottomk_irrel_delta_softmax_pooling(logits, valid, topj: int, *, n_fg: int,
                                             bottomk: int | None = None, detection: bool = False,
                                             return_indices: bool = False):
    """Bottom-k by background sum, then rank fg rows by softmax*fg product."""
    return _bottomk_family(logits, valid, topj, n_fg, bottomk, detection, return_indices,
                           rank_fn=lambda fg: softmax(fg, dim=-1) * fg)


def topj_bottomk_irrel_delta_diff_pooling(logits, valid, topj: int, *, n_fg: int,
                                          bottomk: int | None = None, detection: bool = False,
                                          return_indices: bool = False):
    """Bottom-k by background sum, then rank fg rows by fg*margin product."""
    return _bottomk_family(logits, valid, topj, n_fg, bottomk, detection, return_indices,
                           rank_fn=lambda fg: fg * masked_row_margin(fg)[..., None])


# The families that rank and pool the foreground (tumor-bank) logits in
# zero-shot evaluation; the bottom-k families take the extended bank with
# ``n_fg = n_classes``.
FOREGROUND_POOLINGS = frozenset({
    "topj", "delta_softmax", "delta_diff",
    "topj_delta_softmax", "topj_delta_diff",
})

# Name → family, the JAX package's registry. Bottom-k entries take ``n_fg``.
POOLING_REGISTRY = {
    "topj": topj_pooling,
    "delta_softmax": delta_softmax_pooling,
    "delta_diff": delta_diff_pooling,
    "topj_delta_softmax": topj_delta_softmax_pooling,
    "topj_delta_diff": topj_delta_diff_pooling,
    "bottomk_irrel": bottomk_irrel_pooling,
    "bottomk_irrel_delta_softmax": bottomk_irrel_delta_softmax_pooling,
    "bottomk_irrel_delta_diff": bottomk_irrel_delta_diff_pooling,
    "topj_bottomk_irrel_delta_softmax": topj_bottomk_irrel_delta_softmax_pooling,
    "topj_bottomk_irrel_delta_diff": topj_bottomk_irrel_delta_diff_pooling,
}
