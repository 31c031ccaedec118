"""CHIEF: gated-attention MIL conditioned on an anatomical-site text embedding
(PyTorch port of ``moc_tpu/models/chief.py``).

Gated attention pools the projected patch features; a per-site text
embedding (19 anatomical sites × 768, produced offline by a text encoder)
is projected into feature space and added to the pooled slide embedding
before the classifier. The site table is a constructor argument (a learned
``organ_embedding`` parameter, normal(1.0), when absent).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from moc_tpu_torch.models.layers import (AttnNet, Dense, GatedAttnNet, dropout, init_flax_like,
                                         masked_attention_weights, softmax)

CHIEF_SIZES = {
    "xs": (384, 256, 256),
    "small": (768, 512, 256),
    "big": (1024, 512, 384),
    "large": (2048, 1024, 512),
    "conch": (512, 512, 384),
}

N_ANATOMICAL_SITES = 19
TEXT_EMBED_DIM = 768


@dataclasses.dataclass(frozen=True)
class ChiefConfig:
    n_classes: int = 2
    size_arg: str = "large"
    gate: bool = True
    dropout: float = 0.25


class CHIEF(nn.Module):
    def __init__(self, cfg: ChiefConfig = ChiefConfig(), site_embeddings=None,
                 in_dim: int | None = None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        size_in, hidden, attn_hidden = CHIEF_SIZES[cfg.size_arg]
        self.fc = Dense(size_in if in_dim is None else in_dim, hidden)
        attn_cls = GatedAttnNet if cfg.gate else AttnNet
        self.attn = attn_cls(hidden, attn_hidden, 1, cfg.dropout)
        self.text_to_vision = Dense(TEXT_EMBED_DIM, hidden)
        self.classifiers = Dense(hidden, cfg.n_classes)
        if site_embeddings is None:
            self.organ_embedding = nn.Parameter(torch.empty(N_ANATOMICAL_SITES, TEXT_EMBED_DIM))
        else:
            self.register_buffer("organ_embedding", torch.from_numpy(
                np.asarray(site_embeddings, np.float32).copy()), persistent=False)
        init_flax_like(self, generator or torch.Generator().manual_seed(0),
                       {"organ_embedding": 1.0})

    def _site_vec(self, anatomic, rng):
        table = self.organ_embedding
        if table.dim() == 3:  # stacked: one table a row
            rows = torch.arange(table.shape[0], device=table.device)
            site = table[rows, torch.as_tensor(anatomic, device=table.device)]
        else:
            site = table[torch.as_tensor(anatomic, device=table.device)]
        return dropout(torch.relu(self.text_to_vision(site)), self.cfg.dropout, rng)

    def _embed(self, feats, rng):
        h = dropout(torch.relu(self.fc(feats)), self.cfg.dropout, rng)
        return h, self.attn(h, rng).transpose(-1, -2)  # [B, 1, N]

    def forward(self, feats, valid, anatomic=0, *, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """``anatomic``: one site for the batch, or ``[B]``."""
        rng = generator if train else None
        h, scores = self._embed(feats, rng)
        weights = masked_attention_weights(scores, valid)
        m = (weights @ h)[:, 0] + self._site_vec(anatomic, rng)
        return {"logits": self.classifiers(m), "attention": scores,
                # the exported slide embedding pools the RAW input features,
                # not the hidden pooling the logits use
                "wsi_feature": (weights @ feats)[:, 0], "wsi_feature_anatomical": m}

    def patch_probs(self, feats, valid, anatomic=0) -> dict:
        """Heatmap scores: ``sigmoid(attention) × P(class 1 | patch)`` and the
        bag probability."""
        h, scores = self._embed(feats, None)
        weights = masked_attention_weights(scores, valid)
        site = self._site_vec(anatomic, None)
        if site.dim() == 1:
            site = site.expand(h.shape[0], -1)
        bag_prob = softmax(self.classifiers((weights @ h)[:, 0] + site))
        patch_logits = self.classifiers(h + site[:, None, :])
        patch_prob = torch.sigmoid(scores[:, 0]) * softmax(patch_logits)[..., 1]
        return {"bag_prob": bag_prob, "patch_prob": torch.where(valid, patch_prob, 0.0),
                "attention_raw": scores[:, 0]}
