"""Zero-shot evaluation: MI-Zero slide evaluation, tile evaluation and their
metrics (PyTorch port of ``moc_tpu/zeroshot/eval.py``).

``run_mizero`` scores each slide's patch embeddings (optionally projected
into the contrastive space) against a classifier ``W [D, C]``, pools the
patch logits with top-j means over a tuple of j values, and reports
accuracy, balanced accuracy, Cohen's kappa (plain and quadratic), ROC-AUC
(binary, or ovo macro for C > 2) and weighted F1 per j. A batch of slides
is scored on its own device, and every j pools through kernel K1 there
(``ops.topj_pooling``: one column launch a j on the GPU). The metrics run
on the host in numpy with scikit-learn's semantics, without scikit-learn.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from moc_tpu_torch.data.batching import BagBatch
from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.metrics.auc import roc_auc_host
from moc_tpu_torch.metrics.classification import CONCH_TEMPERATURE
from moc_tpu_torch.metrics.report import (balanced_accuracy_score, classification_report,
                                          cohen_kappa_score)
from moc_tpu_torch.ops.pooling import topj_pooling

METRICS = ("acc", "bacc", "weighted_kappa", "kappa", "roc_auc", "weighted_f1")


def multi_topj_pooling(logits: torch.Tensor, valid: torch.Tensor,
                       topj: Sequence[int]) -> dict[int, torch.Tensor]:
    """Pooled logits ``[..., C]`` per j of patch logits ``[..., N, C]`` under
    the validity mask ``[..., N]``."""
    return {j: topj_pooling(logits, valid, j) for j in topj}


def classification_metrics(probs: np.ndarray, preds: np.ndarray, targets: np.ndarray,
                           metrics: Sequence[str]) -> dict:
    """The metric block of MI-Zero evaluation; ``metrics`` picks the keys
    (all of them, with ``"report"``, when empty). ROC-AUC is nan where
    scikit-learn's ``roc_auc_score`` raises or gives nan (one class, or
    fewer classes present than columns)."""
    probs, preds, targets = np.asarray(probs), np.asarray(preds), np.asarray(targets)
    rep = classification_report(targets, preds)
    try:
        auc = roc_auc_host(probs, targets)
    except ValueError:
        auc = float("nan")
    out = {"acc": float((preds == targets).mean()),
           "bacc": balanced_accuracy_score(targets, preds),
           "kappa": cohen_kappa_score(targets, preds),
           "weighted_kappa": cohen_kappa_score(targets, preds, weights="quadratic"),
           "roc_auc": float(auc),
           "weighted_f1": float(rep["weighted avg"]["f1-score"]),
           "report": rep}
    return {k: out[k] for k in metrics} if metrics else out


def _probs(logits: np.ndarray, logit_scale: float) -> np.ndarray:
    return torch.softmax(torch.from_numpy(logits) * logit_scale, dim=1).numpy()


def run_mizero(batches: Iterable[BagBatch], classifier: np.ndarray, *,
               logit_scale: float = CONCH_TEMPERATURE,
               topj: Sequence[int] = (1, 5, 10, 50, 100),
               project_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
               metrics: Sequence[str] = METRICS, dump_patch_level: bool = False):
    """Slide-level MI-Zero evaluation over padded bag batches, each scored on
    its own device. ``project_fn`` maps patch features into the contrastive
    space first (``VisionTower.forward_project``); features are then
    L2-normalised and scored against ``classifier [D, C]``. Rows labelled
    −1 are dropped. Returns ``(results {metric: {j: value}}, dump)``; with
    ``dump_patch_level`` the dump also holds each slide's patch logits and,
    where the batch carries them, its coordinates."""
    from moc_tpu_torch.moc.core import _full_f32

    _full_f32()
    topj = tuple(topj)
    w_host = torch.from_numpy(np.asarray(classifier, np.float32))
    pooled_all: dict[int, list] = {j: [] for j in topj}
    targets_all, patch_dump, coords_dump = [], [], []
    for batch in batches:
        w = w_host.to(batch.features.device)
        with torch.no_grad():
            f = batch.features if project_fn is None else project_fn(batch.features)
            f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(min=1e-12)
            logits = f @ w
            pooled = torch.stack(list(multi_topj_pooling(logits, batch.mask, topj).values()),
                                 dim=1)  # [B, n_j, C]
        labels = batch.labels.cpu().numpy()
        keep = labels >= 0
        pooled = pooled.cpu().numpy()[keep]
        for ji, j in enumerate(topj):
            pooled_all[j].append(pooled[:, ji])
        targets_all.append(labels[keep])
        if dump_patch_level:
            pl, counts = logits.cpu().numpy(), batch.n_patches.cpu().numpy()
            coords = None if batch.coords is None else batch.coords.cpu().numpy()
            for i in np.where(keep)[0]:
                patch_dump.append(pl[i, :counts[i]])
                if coords is not None:
                    coords_dump.append(coords[i, :counts[i]])

    targets = np.concatenate(targets_all)
    results: dict[str, dict[int, float]] = {m: {} for m in metrics}
    dump = {"targets": targets, "logits": {}, "preds": {}}
    for j in topj:
        logits_j = np.concatenate(pooled_all[j])
        probs = _probs(logits_j, logit_scale)
        preds = probs.argmax(1)
        m = classification_metrics(probs, preds, targets, metrics)
        for name in metrics:
            results[name][j] = m[name]
        dump["logits"][j] = logits_j
        dump["preds"][j] = preds
    if dump_patch_level:
        dump["patch_logits"] = patch_dump
        dump["coords"] = coords_dump
    return results, dump


def run_zeroshot_tiles(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                       tile_batches: Iterable[tuple[np.ndarray, np.ndarray]],
                       classifier: np.ndarray, *, logit_scale: float = CONCH_TEMPERATURE,
                       metrics: Sequence[str] = METRICS,
                       device: str | torch.device | None = None):
    """Tile-level zero-shot classification: ``encode_fn`` maps an image
    batch (a tensor on ``device``, the GPU unless ``device="cpu"``) to
    normalised embeddings, scored against ``classifier [D, C]``."""
    from moc_tpu_torch.moc.core import _full_f32

    _full_f32()
    device = resolve_device(device)
    w = torch.from_numpy(np.asarray(classifier, np.float32)).to(device)
    logits_all, targets_all = [], []
    with torch.no_grad():
        for imgs, labels in tile_batches:
            emb = encode_fn(torch.from_numpy(np.asarray(imgs, np.float32)).to(device))
            logits_all.append((emb @ w).cpu().numpy())
            targets_all.append(np.asarray(labels))
    logits, targets = np.concatenate(logits_all), np.concatenate(targets_all)
    probs = _probs(logits, logit_scale)
    preds = probs.argmax(1)
    return classification_metrics(probs, preds, targets, metrics), {
        "logits": logits, "targets": targets, "preds": preds}


# the reference's name for the tile-level evaluation
run_zeroshot = run_zeroshot_tiles
