"""Max-pooling instance MIL heads, MIL-fc binary and multiclass (PyTorch port
of ``moc_tpu/models/mil.py``).

* binary: a per-patch 2-way classifier; the slide's logits are those of the
  valid patch with the highest class-1 probability;
* multiclass: per-class 1-d heads; the slide's prediction is the (patch,
  class) cell of highest probability, its logits that patch's row.

Ties go to the lower index, as ``jnp.argmax`` sends them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from moc_tpu_torch.models.layers import (NEG_INF, Dense, StackedDense, dropout, init_flax_like,
                                         softmax)

MIL_SIZES = {"small": (1024, 512), "benchmark": (384, 512), "conch": (512, 512)}


@dataclasses.dataclass(frozen=True)
class MilFcConfig:
    n_classes: int = 2
    size_arg: str = "conch"
    dropout: float = 0.0
    top_k: int = 1


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x [B, N, C]``, ``idx [B]``."""
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


class MILFc(nn.Module):
    """Binary instance-max MIL (the reference's ``MIL_fc``)."""

    def __init__(self, cfg: MilFcConfig = MilFcConfig(), in_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.n_classes != 2:
            raise ValueError("MILFc is binary; use MILFcMC for more classes")
        self.cfg = cfg
        size_in, hidden = MIL_SIZES[cfg.size_arg]
        self.fc = Dense(size_in if in_dim is None else in_dim, hidden)
        self.classifier = Dense(hidden, 2)
        init_flax_like(self, generator or torch.Generator().manual_seed(0))

    def forward(self, feats, valid, *, train: bool = False, generator=None) -> dict:
        h = dropout(torch.relu(self.fc(feats)), self.cfg.dropout, generator if train else None)
        logits = self.classifier(h)  # [B, N, 2]
        probs = softmax(logits, dim=-1)
        top_idx = torch.argmax(torch.where(valid, probs[..., 1], NEG_INF), dim=-1)
        return {"logits": _row(logits, top_idx), "patch_probs": probs, "top_idx": top_idx}


class MILFcMC(nn.Module):
    """Multiclass instance-max MIL (the reference's ``MIL_fc_mc``)."""

    def __init__(self, cfg: MilFcConfig = MilFcConfig(n_classes=3), in_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.n_classes <= 2:
            raise ValueError("MILFcMC is for more than two classes; use MILFc")
        self.cfg = cfg
        size_in, hidden = MIL_SIZES[cfg.size_arg]
        self.fc = Dense(size_in if in_dim is None else in_dim, hidden)
        self.classifiers = StackedDense(cfg.n_classes, hidden, 1)
        init_flax_like(self, generator or torch.Generator().manual_seed(0))

    def forward(self, feats, valid, *, train: bool = False, generator=None) -> dict:
        c = self.cfg.n_classes
        h = dropout(torch.relu(self.fc(feats)), self.cfg.dropout, generator if train else None)
        logits = self.classifiers(h)[..., 0]  # [B, N, C]
        probs = softmax(logits, dim=-1)
        masked = torch.where(valid[..., None], probs, NEG_INF)
        flat_idx = torch.argmax(masked.reshape(masked.shape[0], -1), dim=-1)
        top_patch = torch.div(flat_idx, c, rounding_mode="floor")
        return {"logits": _row(logits, top_patch), "patch_probs": probs, "top_idx": top_patch,
                "y_hat": flat_idx % c}
