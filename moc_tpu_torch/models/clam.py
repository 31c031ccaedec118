"""CLAM attention-MIL heads (single- and multi-branch) and ABMIL (PyTorch
port of ``moc_tpu/models/clam.py``).

* features → Dense+ReLU → (gated) attention scores;
* slide embedding ``M = softmax(A) @ h``; SB: one shared classifier on
  ``M[0]``; MB: per-class attention branches and per-class 1-d classifiers;
* the instance-level clustering loss: for the slide's class, the k most
  attended valid patches are positives and the k least attended negatives
  for a per-class 2-way instance classifier; for the other classes
  (subtyping only) the top k are negatives.

Padded bags and masks; the per-class loops are stacked heads and one-hot
weights. ABMIL is CLAM-SB trained without the instance loss, and holds no
instance heads (as the JAX package initialises it).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from moc_tpu_torch.models.layers import (AttnNet, Dense, GatedAttnNet, StackedDense, dropout,
                                         init_flax_like, masked_attention_weights,
                                         masked_topk_feats, softmax_cross_entropy)

# size_arg → (in_dim, hidden, attn_hidden)
CLAM_SIZES = {
    "small": (1024, 512, 256),
    "big": (1024, 512, 384),
    "benchmark": (384, 512, 256),
    "conch": (512, 512, 384),
    "gigapath": (1536, 512, 256),
    "virchow": (2560, 512, 256),
}


@dataclasses.dataclass(frozen=True)
class ClamConfig:
    n_classes: int = 2
    size_arg: str = "conch"
    gate: bool = True
    dropout: float = 0.0
    k_sample: int = 8
    subtyping: bool = False
    multi_branch: bool = False  # False = CLAM_SB, True = CLAM_MB


class CLAM(nn.Module):
    """``in_dim`` defaults to the size's; ``instance_heads=False`` leaves out
    the instance classifiers (ABMIL)."""

    def __init__(self, cfg: ClamConfig = ClamConfig(), in_dim: int | None = None,
                 instance_heads: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        size_in, hidden, attn_hidden = CLAM_SIZES[cfg.size_arg]
        in_dim = size_in if in_dim is None else in_dim
        c = cfg.n_classes
        self.fc = Dense(in_dim, hidden)
        attn_cls = GatedAttnNet if cfg.gate else AttnNet
        self.attn = attn_cls(hidden, attn_hidden, c if cfg.multi_branch else 1, cfg.dropout)
        self.classifiers = StackedDense(c, hidden, 1) if cfg.multi_branch else Dense(hidden, c)
        if instance_heads:
            self.instance_classifiers = StackedDense(c, hidden, 2)
        init_flax_like(self, generator or torch.Generator().manual_seed(0))

    def forward(self, feats, valid, label=None, *, instance_eval: bool = False,
                train: bool = False, generator: torch.Generator | None = None) -> dict:
        """Padded slides ``feats [B, N, D]``, ``valid [B, N]`` → ``logits
        [B, C]``, ``attention [B, K, N]``, ``attention_weights``,
        ``patch_logits [B, N, C]`` and ``instance_loss [B]``. Dropout runs
        with ``train`` and a ``generator``."""
        cfg = self.cfg
        rng = generator if train else None
        h = dropout(torch.relu(self.fc(feats)), cfg.dropout, rng)
        scores = self.attn(h, rng).transpose(-1, -2)  # [B, K, N]
        weights = masked_attention_weights(scores, valid)
        slide_emb = weights @ h  # [B, K, hidden]
        if cfg.multi_branch:
            # head c on branch c's embedding
            logits = torch.diagonal(self.classifiers(slide_emb)[..., 0], dim1=-2, dim2=-1)
            patch_logits = self.classifiers(h)[..., 0]
        else:
            logits = self.classifiers(slide_emb[:, 0])
            patch_logits = self.classifiers(h)
        inst_loss = torch.zeros(feats.shape[0], device=feats.device)
        if instance_eval:
            if label is None:
                raise ValueError("instance_eval needs the slide labels")
            inst_loss = self._instance_loss(scores, h, valid, label)
        return {"logits": logits, "attention": scores, "attention_weights": weights,
                "patch_logits": patch_logits, "instance_loss": inst_loss}

    def _instance_loss(self, scores, h, valid, label):
        """The masked, loop-free ``inst_eval``/``inst_eval_out``: per branch
        one mean CE over the concatenated top and bottom k (2k instances),
        and (subtyping) one over the top k as negatives of the other classes."""
        cfg = self.cfg
        k, c = cfg.k_sample, cfg.n_classes
        classes = torch.arange(c, device=h.device)
        one_hot = (label.long()[:, None] == classes).to(h.dtype)  # [B, C]; zeros for -1

        def ce_sums(feats_k, sel_valid, target: int):
            logits = self.instance_classifiers(feats_k)  # [B, k, C, 2]
            per = softmax_cross_entropy(logits, torch.full(logits.shape[:-1], target,
                                                   device=h.device))  # [B, k, C]
            w = sel_valid.to(h.dtype)[..., None]
            return torch.sum(per * w, dim=1), torch.sum(w, dim=(1, 2))

        total = torch.zeros(h.shape[0], c, device=h.device, dtype=h.dtype)
        for branch in range(scores.shape[1]):
            row = scores[:, branch]
            top_feats, top_valid = masked_topk_feats(row, h, valid, k, largest=True)
            bot_feats, bot_valid = masked_topk_feats(row, h, valid, k, largest=False)
            s_top, n_top = ce_sums(top_feats, top_valid, 1)
            s_bot, n_bot = ce_sums(bot_feats, bot_valid, 0)
            in_class = (s_top + s_bot) / torch.clamp(n_top + n_bot, min=1.0)[:, None]
            contrib = one_hot * in_class
            if cfg.subtyping:
                s_out, n_out = ce_sums(top_feats, top_valid, 0)
                contrib = contrib + (1.0 - one_hot) * (s_out / torch.clamp(n_out, min=1.0)[:, None])
            if scores.shape[1] == 1:  # SB: one attention row supervises every class head
                total = total + contrib
            else:
                total = total + (classes == branch).to(h.dtype) * contrib
        loss = torch.sum(total, dim=-1)
        return loss / c if cfg.subtyping else loss


def clam_sb(n_classes: int, size_arg: str = "conch", **kw) -> CLAM:
    return CLAM(ClamConfig(n_classes=n_classes, size_arg=size_arg, multi_branch=False, **kw))


def clam_mb(n_classes: int, size_arg: str = "conch", **kw) -> CLAM:
    return CLAM(ClamConfig(n_classes=n_classes, size_arg=size_arg, multi_branch=True, **kw))


def abmil(n_classes: int, size_arg: str = "conch", **kw) -> CLAM:
    """ABMIL: CLAM-SB trained without the instance loss (no instance heads)."""
    return CLAM(ClamConfig(n_classes=n_classes, size_arg=size_arg, **kw), instance_heads=False)
