"""Bag-level losses: cross-entropy and the smooth top-1 SVM (PyTorch port of
``moc_tpu/train/losses.py``).

``smooth_top1_svm`` is the temperature-smoothed multiclass hinge of the
``topk.svm.SmoothTop1SVM`` the reference imports:

    L(s, y) = τ · log Σ_j exp((s_j + α·1[j≠y]) / τ) − s_y

which tends to max_j(s_j + α·1[j≠y]) − s_y (the margin hinge) as τ → 0.
"""

from __future__ import annotations

import torch

from moc_tpu_torch.models.layers import softmax_cross_entropy as cross_entropy


def _label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # a negative label wraps as numpy's take_along_axis wraps it (-1 → C-1);
    # callers weight such filler rows by 0
    idx = labels.long().remainder(logits.shape[-1])
    return torch.gather(logits, -1, idx[..., None])[..., 0]


def smooth_top1_svm(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0,
                    tau: float = 1.0) -> torch.Tensor:
    """``logits [..., C]``, ``labels [...]`` → per-example smooth hinge."""
    n_classes = logits.shape[-1]
    one_hot = (labels.long()[..., None] == torch.arange(n_classes, device=logits.device))
    margin = alpha * (1.0 - one_hot.to(logits.dtype))
    smoothed = tau * torch.logsumexp((logits + margin) / tau, dim=-1)
    return smoothed - _label_logits(logits, labels)


__all__ = ["bag_loss_fn", "cross_entropy", "smooth_top1_svm"]


def bag_loss_fn(name: str):
    if name == "ce":
        return cross_entropy
    if name == "svm":
        return smooth_top1_svm
    raise ValueError(f"unknown bag loss {name!r}")
