"""MOC slide processing for serving: dense classifier views, SENet fusion and
pooling gated by the exact selection union (PyTorch port of the masked path
of ``moc_tpu/moc/core.py``).

The batch is written out: ``feats [B, N, D]`` in, slide logits ``[B, C]``
out. All ``B·(2C+1)`` selection rows go through one launch of kernel K1 and
all ``B·C`` pooling columns through another.
"""

from __future__ import annotations

import dataclasses

import torch

from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.ops import topj_pooling, union_selection_threshold
from moc_tpu_torch.ops.masking import softmax

# The four classifier slots, in the SENet output order of the fusion.
CLASSIFIER_NAMES = ("topk", "delta_softmax", "delta_diff", "bottomk")


@dataclasses.dataclass(frozen=True)
class MOCConfig:
    """Static serving hyper-parameters (reference defaults: topj=400,
    topk=10, CONCH temperature)."""

    n_classes: int
    n_ext_classes: int
    topj: int = 400
    topk: int = 10
    discard: tuple[str, ...] = ()
    temperature: float = 56.3477
    feature_dim: int = 512

    def include_flags(self) -> tuple[bool, bool, bool, bool]:
        return tuple(name not in self.discard for name in CLASSIFIER_NAMES)


def views_from_logits(logits: torch.Tensor, logits_ext: torch.Tensor,
                      n_classes: int) -> torch.Tensor:
    """The 4 classifier views from per-row logits ``[..., M, C]`` and extended
    logits ``[..., M, C + C_bg]`` → ``[..., 4, M, C]``: raw, softmax,
    |top1−top2| margin (broadcast), background max (broadcast)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = torch.abs(top2[..., 0] - top2[..., 1])
    bg_max = torch.amax(logits_ext[..., n_classes:], dim=-1)
    return torch.stack([
        logits,
        softmax(logits, dim=-1),
        margin[..., None].expand(logits.shape),
        bg_max[..., None].expand(logits.shape),
    ], dim=-3)


def _dense_views_weights(senet: SENet, feats: torch.Tensor, w: torch.Tensor,
                         w_ext: torch.Tensor, cfg: MOCConfig):
    """Every classifier view and the SENet weights for ALL rows from ONE f32
    matmul over ``[w | w_ext | SENet dense0]``: the ``[B, N, D]`` features,
    the largest read of the forward, are streamed once.

    Returns ``(views [B, 4, N, C], weights [B, N, 4], logits [B, N, C],
    logits_ext [B, N, C_ext])``."""
    # full f32 for the scoring matmul: TF32 keeps ~3 decimal digits, and a
    # change of a few ulp already flips near-tied selections at the topj
    # boundary, so the selected set would stop matching the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, ce = cfg.n_classes, w_ext.shape[1]
    w_cat = torch.cat([w, w_ext, senet.dense0.weight.t()], dim=1)
    out_all = feats @ w_cat  # [B, N, C + C_ext + H]
    logits = out_all[..., :c]
    logits_ext = out_all[..., c:c + ce]
    views = views_from_logits(logits, logits_ext, c)
    hidden = torch.relu(out_all[..., c + ce:] + senet.dense0.bias)
    weights = torch.sigmoid(senet.dense1(hidden))  # [B, N, 4]
    return views, weights, logits, logits_ext


def fuse_views(weights: torch.Tensor, views: torch.Tensor,
               include: tuple[bool, ...]) -> torch.Tensor:
    """Weighted sum of classifier views: ``weights [..., S, 4]`` (the SENet
    outputs), ``views [..., 4, S, C]`` → ``[..., S, C]``. Discarded
    classifiers contribute nothing."""
    keep = torch.tensor(include, dtype=weights.dtype, device=weights.device)
    return torch.einsum("...sk,...ksc->...sc", weights * keep, views)


def moc_slide_logits_masked(senet: SENet, feats: torch.Tensor, valid: torch.Tensor,
                            w: torch.Tensor, w_ext: torch.Tensor,
                            cfg: MOCConfig) -> torch.Tensor:
    """Exact MOC forward without gather/compaction: every view and the SENet
    weighting are row-local, so the selection union only decides pooling
    eligibility. ``feats [B, N, D]``, ``valid [B, N]`` → pooled ``[B, C]``."""
    views, weights, logits, logits_ext = _dense_views_weights(
        senet, feats, w, w_ext, cfg)
    union = union_selection_threshold(logits, logits_ext, valid, cfg.topj,
                                      cfg.n_classes, cfg.discard)
    fused = fuse_views(weights, views, cfg.include_flags())
    return topj_pooling(fused, union, cfg.topk)
