"""Layers shared by the port's towers (PyTorch port of the helpers of
``moc_tpu/models/layers.py`` that the towers use)."""

from __future__ import annotations

import torch


def l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Clip-guarded L2 normalisation: the one definition CoCa, MUSK and the
    extraction CLI use."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=1e-12)
