"""Accuracy/calibration helpers (PyTorch port of
``moc_tpu/metrics/classification.py``)."""

from __future__ import annotations

import torch

from moc_tpu_torch.config import CONCH_TEMPERATURE


def softmax_probs(logits: torch.Tensor, temperature: float = CONCH_TEMPERATURE) -> torch.Tensor:
    """Calibrated class probabilities from pooled slide logits ``[M, C]``."""
    z = logits * temperature
    e = torch.exp(z - torch.amax(z, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Top-1 accuracy of ``logits [M, C]`` vs ``labels [M]`` over valid rows."""
    if valid is None:
        valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    hit = (torch.argmax(logits, dim=-1) == labels) & valid
    return hit.sum() / torch.clamp(valid.sum(), min=1)


def balanced_accuracy(logits: torch.Tensor, labels: torch.Tensor, n_classes: int,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per-class recall over the classes present among the valid rows
    (scikit-learn's ``balanced_accuracy_score``)."""
    if valid is None:
        valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    preds = torch.argmax(logits, dim=-1)
    recalls, present = [], []
    for c in range(n_classes):
        in_c = valid & (labels == c)
        recalls.append(((preds == c) & in_c).sum() / torch.clamp(in_c.sum(), min=1))
        present.append(in_c.any())
    w = torch.stack(present).to(torch.float32)
    return torch.sum(torch.stack(recalls) * w) / torch.clamp(w.sum(), min=1.0)
