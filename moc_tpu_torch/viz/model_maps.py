"""Per-patch maps from trained models (PyTorch port of
``moc_tpu/viz/model_maps.py``): the heatmap quantities of the MIL heads and
of a trained MOC SENet, computed on the device, returned as host numpy.

* CLAM/ABMIL attention weights (after the masked softmax), the classic
  CLAM heatmap;
* CHIEF's ``patch_probs`` (``sigmoid(attention) x P(class 1 | patch)``);
* patch-level class logits (CLAM, TransMIL) or probabilities (MIL-fc);
* for MOC, the fused per-patch class logits, the selection union (kernel
  K1's row entry on the card, one launch a slide) and the four SENet view
  weights.

Every forward runs with TF32 off (``models.layers.full_f32``).
"""

from __future__ import annotations

import numpy as np
import torch


def _bag(feats: np.ndarray, valid: np.ndarray, device):
    """One bag as a batch of one on ``device``."""
    from moc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(feats, np.float32), device=dev)[None],
            torch.as_tensor(np.asarray(valid, bool), device=dev)[None])


def _host(x: torch.Tensor) -> np.ndarray:
    return x[0].float().cpu().numpy()


@torch.no_grad()
def trained_patch_maps(cfg, params, feats: np.ndarray, valid: np.ndarray, *,
                       anatomic: int = 0, device=None):
    """Run a trained MIL head over one bag → patch-level maps.

    ``cfg`` is a ``train.mil.MilTrainConfig``; ``params`` the head's state
    (the JAX package's flax tree, as ``utils.checkpoint.load_params`` reads
    it, or a torch state dict); ``feats [N, D]``, ``valid [N]`` bool;
    ``device`` defaults to ``cuda``.

    Returns ``(maps, class_scores, scores_are_probs)``:

    * ``maps``: ``{name: np.ndarray [N]}`` scalar per-patch maps
      (``attn`` / ``attn_c<k>`` attention weights, CHIEF ``patchprob``);
    * ``class_scores``: ``[N, C]`` per-class patch scores or ``None``
      (CHIEF's heatmap quantity is class-1-only);
    * ``scores_are_probs``: True when ``class_scores`` are already
      probabilities (the ``mil`` head emits softmax ``patch_probs``).
    """
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.mil import model_from_params

    t = cfg.model_type
    if t not in ("clam_sb", "clam_mb", "abmil", "transmil", "mil", "chief"):
        raise ValueError(
            f"no patch-level maps for model_type {t!r} (titan pools coords into "
            "a slide embedding with no per-patch scores)")
    f, v = _bag(feats, valid, device)
    model, _ = model_from_params(cfg, params)
    model.to(f.device).eval()
    with full_f32():
        if t == "chief":
            out = model.patch_probs(f, v, anatomic)
        else:
            out = model(f, v)
    if t in ("clam_sb", "clam_mb", "abmil"):
        w = _host(out["attention_weights"])  # [K, N]
        if t == "clam_mb":
            maps = {f"attn_c{k}": w[k] for k in range(w.shape[0])}
        else:
            maps = {"attn": w[0]}
        return maps, _host(out["patch_logits"]), False
    if t == "transmil":
        return {}, _host(out["patch_logits"]), False
    if t == "mil":
        return {}, _host(out["patch_probs"]), True
    maps = {
        "patchprob": _host(out["patch_prob"]),
        "attn": (1.0 / (1.0 + np.exp(-_host(out["attention_raw"]).astype(np.float64))))
        .astype(np.float32),
    }
    return maps, None, False


@torch.no_grad()
def moc_patch_maps(senet, feats: np.ndarray, valid: np.ndarray, w: np.ndarray,
                   w_ext: np.ndarray, cfg, *, device=None):
    """Per-patch maps from a trained MOC SENet over one bag: the fused
    per-patch class logits, the selection union (which patches the four
    index policies admit to pooling) and the four SENet view weights.

    ``senet`` is a ``models.senet.SENet``; ``cfg`` a ``moc.MOCConfig``;
    ``device`` defaults to ``cuda``. The union is
    ``ops.union_selection_threshold`` (K1's row entry on the card), or
    ``ops.union_selection`` under ``select_method="sort"``. Returns
    ``(maps, fused)``: ``maps = {"union": [N] float 0/1, "w_<view>": [N]}``,
    ``fused [N, C]`` patch logits (for every valid row; gate by
    ``maps["union"]`` to show only pooling-eligible patches)."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.moc.core import (CLASSIFIER_NAMES, _dense_views_weights,
                                        _selection_union, fuse_views)

    if senet is None:
        raise ValueError("senet checkpoint did not produce view weights — "
                         "pass the SENet written by cli.main_moc/sweep")
    f, v = _bag(feats, valid, device)
    senet = senet.to(f.device).eval()
    with full_f32():
        views, weights, logits, logits_ext = _dense_views_weights(
            senet, f, torch.as_tensor(np.asarray(w, np.float32), device=f.device),
            torch.as_tensor(np.asarray(w_ext, np.float32), device=f.device), cfg)
        union = _selection_union(logits, logits_ext, v, cfg)
        fused = fuse_views(weights, views, cfg.include_flags())
    maps = {"union": _host(union)}
    wn = _host(weights)
    for i, name in enumerate(CLASSIFIER_NAMES):
        if cfg.include_flags()[i]:
            maps[f"w_{name}"] = wn[:, i]
    return maps, _host(fused)
