"""The MOC fusion network: a per-patch classifier-weighting MLP (PyTorch port
of ``moc_tpu/models/senet.py``).

512 → 64 ReLU → 4 Sigmoid, producing per-patch weights for the four patch
classifiers (top-j, delta-softmax, delta-diff, bottom-k-irrelevant). The
initialisation is torch's ``nn.Linear`` default (weights and biases uniform
in ±1/sqrt(fan_in)), which the JAX package reproduces in flax.
``SENetStack`` holds the SENets of several episodes along a leading axis.
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


# SENetStack parameter → SENet state-dict key
STACK_KEYS = {"w0": "dense0.weight", "b0": "dense0.bias", "w1": "dense1.weight",
              "b1": "dense1.bias"}


def senet_stack_apply(w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """E SENets at once: parameters ``w0 [*T, E, H, D]``, ``b0 [*T, E, H]``,
    ``w1 [*T, E, O, H]``, ``b1 [*T, E, O]`` over ``x [E, ..., D]`` →
    ``[*T, E, ..., O]``. Episode e's rows meet only episode e's parameters;
    the optional leading axes ``T`` (a parameter trajectory) share ``x``,
    which is never copied: its rows are multiplied once by the ``T``
    first layers side by side."""
    lead, (e, h, d), o = w0.shape[:-3], w0.shape[-3:], w1.shape[-2]
    t = math.prod(lead)
    xf = x.reshape(e, -1, d)
    rows = xf.shape[1]
    w0e = w0.reshape(t, e, h, d).permute(1, 3, 0, 2).reshape(e, d, t * h)
    b0e = b0.reshape(t, e, h).permute(1, 0, 2).reshape(e, 1, t * h)
    hidden = torch.relu(torch.baddbmm(b0e, xf, w0e))  # [E, R, T·H]
    if t > 1:
        hidden = hidden.view(e, rows, t, h).transpose(1, 2).reshape(e * t, rows, h)
    w1e = w1.reshape(t, e, o, h).transpose(0, 1).reshape(e * t, o, h).transpose(1, 2)
    b1e = b1.reshape(t, e, o).transpose(0, 1).reshape(e * t, 1, o)
    out = torch.sigmoid(torch.baddbmm(b1e, hidden, w1e))  # [E·T, R, O]
    out = out.view(e, t, *x.shape[1:-1], o).transpose(0, 1)
    return out.reshape(*lead, e, *x.shape[1:-1], o)


class SENetStack(nn.Module):
    """``E`` independent SENets with a leading episode axis: parameters
    ``w0 [E, H, D]``, ``b0 [E, H]``, ``w1 [E, O, H]``, ``b1 [E, O]``; the
    forward maps ``x [E, ..., D]`` to ``[E, ..., O]``, episode e through
    episode e's parameters, as ``SENet`` with those parameters does. The
    port's form of ``jax.vmap`` over the SENet's ``apply``."""

    def __init__(self, n_episodes: int, in_dim: int = 512, hidden_dim: int = 64,
                 out_dim: int = 4):
        super().__init__()
        self.w0 = nn.Parameter(torch.zeros(n_episodes, hidden_dim, in_dim))
        self.b0 = nn.Parameter(torch.zeros(n_episodes, hidden_dim))
        self.w1 = nn.Parameter(torch.zeros(n_episodes, out_dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(n_episodes, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return senet_stack_apply(self.w0, self.b0, self.w1, self.b1, x)

    def state_dict_of(self, e: int) -> dict[str, torch.Tensor]:
        """Episode ``e``'s parameters as a ``SENet`` state dict (copies)."""
        return {key: getattr(self, name)[e].detach().clone()
                for name, key in STACK_KEYS.items()}
