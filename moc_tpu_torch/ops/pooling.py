"""Slide-level pooling over padded patch-logit bags (PyTorch port of the
mask path of ``moc_tpu/ops/pooling.py``).

``topj_pooling`` maps patch logits ``[..., N, C]`` and a validity mask
``[..., N]`` to pooled slide logits ``[..., C]``: the mean of each class's
top-j valid logits, count-corrected when fewer than j rows are valid.
"""

from __future__ import annotations

import torch

from moc_tpu_torch.ops.masking import NEG_INF, masked_col_topk_mask


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
    """Pool ``logits`` at the per-class top-j set of ``ranking`` scores, via
    the exact membership mask (kernel K1 on the GPU)."""
    sel = masked_col_topk_mask(ranking, valid, min(topj, logits.shape[-2]))
    return _masked_sel_mean(logits, sel, valid, topj, count)


def topj_pooling(logits: torch.Tensor, valid: torch.Tensor, topj: int) -> torch.Tensor:
    """Mean of per-class top-j logits (reference ``topj_pooling``)."""
    return _rank_pool(logits, logits, valid, topj, valid.sum(-1))
