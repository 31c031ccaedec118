"""Accuracy/calibration helpers (PyTorch port of
``moc_tpu/metrics/classification.py``)."""

from __future__ import annotations

import torch

# CONCH contrastive logit scale: slide logits are multiplied by this
# temperature before the softmax that produces the served probabilities.
CONCH_TEMPERATURE = 56.3477


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
