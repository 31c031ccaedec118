"""ROC-AUC as the tie-corrected Mann–Whitney U statistic (PyTorch port of
``moc_tpu/metrics/auc.py``).

Two forms:

* ``roc_auc_host``: numpy, float64, scikit-learn's ``roc_auc_score``
  semantics with the reference's arguments (binary: P(class 1); multiclass:
  ``ovo`` macro), for reporting, and ``roc_auc_ovr_host`` (``ovr`` macro),
  the MIL baselines'. Hosts without scikit-learn run them.
* ``auc_binary``, ``auc_ovo_macro``, ``auc_ovr_macro`` and
  ``auc_from_probs``: torch, on the tensors' device, batched over leading
  axes, with a ``valid`` mask for padded score arrays; a class that is
  absent is weighted out of the macro means.

U counts, for each positive, the negatives scored below it plus half of
those tied with it; AUC = U / (#pos · #neg). That equals the area under
the trapezoidal ROC curve that scikit-learn integrates.
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
import torch


def _rank_auc_f64(pos: np.ndarray, scores: np.ndarray) -> float:
    """AUC of float64 ``scores [M]`` for the boolean positives ``pos [M]``
    (both classes present): ties grouped by exact equality, as scikit-learn's
    ROC curve groups thresholds."""
    _, group, counts = np.unique(scores, return_inverse=True, return_counts=True)
    pos_in = np.bincount(group, weights=pos.astype(np.float64), minlength=len(counts))
    neg_in = counts - pos_in
    neg_below = np.cumsum(neg_in) - neg_in
    u = float(np.sum(pos_in * (neg_below + 0.5 * neg_in)))
    n_pos = float(pos.sum())
    return u / (n_pos * (len(pos) - n_pos))


def _binary_host(labels: np.ndarray, scores: np.ndarray) -> float:
    classes = np.unique(labels)
    if len(classes) > 2:
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    if len(classes) < 2:
        # scikit-learn >= 1.6 warns and returns nan here (older releases raised)
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.", RuntimeWarning, stacklevel=3)
        return float("nan")
    return _rank_auc_f64(labels == classes[1], scores)


def _ovo_host(labels: np.ndarray, probs: np.ndarray) -> float:
    if not np.allclose(1, probs.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                         "i.e. they should sum up to 1.0 over classes")
    classes = np.unique(labels)
    if len(classes) != probs.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns "
                         "in 'y_score'")
    encoded = np.searchsorted(classes, labels)
    pair_scores = []
    for a, b in itertools.combinations(range(len(classes)), 2):
        in_pair = (encoded == a) | (encoded == b)
        sub = encoded[in_pair]
        pair_scores.append(0.5 * (_rank_auc_f64(sub == a, probs[in_pair, a])
                                  + _rank_auc_f64(sub == b, probs[in_pair, b])))
    return float(np.mean(pair_scores))


def roc_auc_host(probs, labels) -> float:
    """``roc_auc_score(labels, probs[:, 1])`` for two columns (or 1-D scores),
    ``roc_auc_score(labels, probs, multi_class="ovo", average="macro")`` for
    more, computed in float64 without scikit-learn. It raises where
    scikit-learn raises: non-finite scores, multiclass labels against one
    score column, a class count that differs from the columns, rows that do
    not sum to 1; a single class present gives nan with a warning."""
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels)
    if not np.isfinite(probs).all():
        raise ValueError("Input contains NaN or infinity.")
    if probs.ndim == 2 and probs.shape[1] == 2:
        return _binary_host(labels, probs[:, 1])
    if probs.ndim == 1:
        return _binary_host(labels, probs)
    if len(np.unique(labels)) <= 2:
        raise ValueError(f"y_score of shape {probs.shape} for binary labels: "
                         "scikit-learn takes a 1-D score here")
    return _ovo_host(labels, probs)


def roc_auc_ovr_host(probs, labels) -> float:
    """``roc_auc_score(labels, probs, multi_class="ovr", average="macro")`` (the
    MIL baselines' multiclass protocol) in float64 without scikit-learn: the
    mean over columns of the AUC of P(class) against that class. It raises
    where scikit-learn raises: non-finite scores, rows that do not sum to 1,
    a class count that differs from the columns."""
    probs = np.asarray(probs, dtype=np.float64)
    labels = np.asarray(labels)
    if not np.isfinite(probs).all():
        raise ValueError("Input contains NaN or infinity.")
    if not np.allclose(1, probs.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                         "i.e. they should sum up to 1.0 over classes")
    classes = np.unique(labels)
    if len(classes) != probs.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns "
                         "in 'y_score'")
    return float(np.mean([_rank_auc_f64(labels == c, probs[:, i])
                          for i, c in enumerate(classes)]))


def _rank_u(scores: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor):
    """Tie-corrected U over the rows where ``pos`` or ``neg`` holds, and the
    pair count, along the last axis of ``scores [..., M]`` (the leading axes
    are a batch), from one sort and cumsums (no ``[M, M]`` matrix): for each
    element, the index of the first and last element of its run of equal
    scores comes from a running max / min of the run boundaries."""
    m = scores.shape[-1]
    order = torch.argsort(scores, dim=-1)
    s = torch.gather(scores, -1, order)
    p = torch.gather(pos.expand(scores.shape), -1, order).to(scores.dtype)
    ng = torch.gather(neg.expand(scores.shape), -1, order).to(scores.dtype)
    cum_neg = torch.cumsum(ng, -1)
    idx = torch.arange(m, device=scores.device).expand(scores.shape)
    one = torch.ones(scores.shape[:-1] + (1,), dtype=torch.bool, device=scores.device)
    is_first = torch.cat([one, s[..., 1:] != s[..., :-1]], -1)
    is_last = torch.cat([s[..., :-1] != s[..., 1:], one], -1)
    gstart = torch.cummax(torch.where(is_first, idx, 0), -1).values
    gend = torch.flip(torch.cummin(torch.flip(torch.where(is_last, idx, m), [-1]), -1).values,
                      [-1])
    neg_below = torch.gather(cum_neg - ng, -1, gstart)
    neg_tied = torch.gather(cum_neg, -1, gend) - neg_below
    return torch.sum(p * (neg_below + 0.5 * neg_tied), -1), torch.sum(p, -1) * torch.sum(ng, -1)


def _ones(labels: torch.Tensor) -> torch.Tensor:
    return torch.ones(labels.shape, dtype=torch.bool, device=labels.device)


def auc_binary(scores: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Binary AUC of ``scores [..., M]`` (higher = class 1) against ``labels
    [..., M]`` over the valid rows, one per leading index; 0.5 where a class
    is absent."""
    valid = _ones(labels) if valid is None else valid
    u, n_pairs = _rank_u(scores, valid & (labels == 1), valid & (labels != 1))
    return torch.where(n_pairs > 0, u / torch.clamp(n_pairs, min=1.0), 0.5)


def auc_ovo_macro(probs: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None,
                  n_classes: int | None = None) -> torch.Tensor:
    """Multiclass ``ovo``-macro AUC of ``probs [..., M, C]``: for each class
    pair (a, b), over the rows labelled a or b, the mean of AUC(P(a), a) and
    AUC(P(b), b); the macro mean over the pairs whose two classes are both
    present."""
    valid = _ones(labels) if valid is None else valid
    c = n_classes if n_classes is not None else probs.shape[-1]
    total = weight = torch.zeros(labels.shape[:-1], dtype=probs.dtype, device=probs.device)
    for a in range(c):
        for b in range(a + 1, c):
            in_pair = valid & ((labels == a) | (labels == b))
            auc_a = auc_binary(probs[..., a], (labels == a).to(torch.int32), in_pair)
            auc_b = auc_binary(probs[..., b], (labels == b).to(torch.int32), in_pair)
            w = ((valid & (labels == a)).any(-1) & (valid & (labels == b)).any(-1)).to(probs.dtype)
            total = total + w * 0.5 * (auc_a + auc_b)
            weight = weight + w
    return total / torch.clamp(weight, min=1.0)


def auc_from_probs(probs: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """The device AUC of the reference's protocol: with two classes the AUC
    of P(class 1), with more the ``ovo`` macro; batched over the leading
    axes of ``probs [..., M, C]``. Where a class is absent it gives 0.5
    (binary) or leaves the class's pairs out of the mean (0 when none is
    left), where ``roc_auc_host`` gives nan or raises."""
    if probs.shape[-1] == 2:
        return auc_binary(probs[..., 1], labels, valid)
    return auc_ovo_macro(probs, labels, valid)


def auc_ovr_macro(probs: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None,
                  n_classes: int | None = None) -> torch.Tensor:
    """Multiclass ``ovr``-macro AUC (the baseline trainers' protocol): the mean
    over classes present among the valid rows of AUC(P(a), a vs the rest)."""
    valid = _ones(labels) if valid is None else valid
    c = n_classes if n_classes is not None else probs.shape[-1]
    total = present = torch.zeros(labels.shape[:-1], dtype=probs.dtype, device=probs.device)
    for a in range(c):
        u, n_pairs = _rank_u(probs[..., a], valid & (labels == a), valid & (labels != a))
        has = (n_pairs > 0).to(probs.dtype)
        total = total + has * u / torch.clamp(n_pairs, min=1.0)
        present = present + has
    return total / torch.clamp(present, min=1.0)
