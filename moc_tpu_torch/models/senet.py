"""The MOC fusion network: a per-patch classifier-weighting MLP (PyTorch port
of ``moc_tpu/models/senet.py``).

512 → 64 ReLU → 4 Sigmoid, producing per-patch weights for the four patch
classifiers (top-j, delta-softmax, delta-diff, bottom-k-irrelevant). The
initialisation is torch's ``nn.Linear`` default (weights and biases uniform
in ±1/sqrt(fan_in)), which the JAX package reproduces in flax.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class SENet(nn.Module):
    """Per-patch weighting MLP: ``[..., in_dim] -> [..., out_dim]`` in (0, 1).

    ``generator`` draws the initial parameters from an explicit
    ``torch.Generator`` (the same distribution as the default init), so a
    seeded model does not depend on the global RNG."""

    def __init__(self, in_dim: int = 512, hidden_dim: int = 64, out_dim: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dense0 = nn.Linear(in_dim, hidden_dim)
        self.dense1 = nn.Linear(hidden_dim, out_dim)
        if generator is not None:
            with torch.no_grad():
                for layer in (self.dense0, self.dense1):
                    bound = 1.0 / math.sqrt(layer.in_features)
                    layer.weight.uniform_(-bound, bound, generator=generator)
                    layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.dense1(torch.relu(self.dense0(x))))
