"""Host classification metrics with scikit-learn's semantics, in numpy
(hosts without scikit-learn run them): the confusion matrix over the labels
present in either array, balanced accuracy, Cohen's kappa (unweighted and
quadratic) and the ``classification_report`` dict with ``zero_division=0``.
"""

from __future__ import annotations

import warnings

import numpy as np


def confusion(targets, preds) -> tuple[np.ndarray, np.ndarray]:
    """``(labels, C)``: the sorted labels present in either array, and
    ``C[i, j]``, the count of target ``labels[i]`` predicted as ``labels[j]``."""
    targets, preds = np.asarray(targets), np.asarray(preds)
    labels = np.union1d(targets, preds)
    t, p = np.searchsorted(labels, targets), np.searchsorted(labels, preds)
    mat = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(mat, (t, p), 1)
    return labels, mat


def balanced_accuracy_score(targets, preds) -> float:
    """Mean recall over the classes present in ``targets``."""
    _, mat = confusion(targets, preds)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(mat) / mat.sum(axis=1)
    if np.isnan(per_class).any():
        warnings.warn("y_pred contains classes not in y_true", stacklevel=2)
        per_class = per_class[~np.isnan(per_class)]
    return float(np.mean(per_class))


def cohen_kappa_score(targets, preds, weights: str | None = None) -> float:
    """Cohen's kappa, unweighted or ``weights="quadratic"``; nan (with a
    warning) where it is undefined, as with one label in common."""
    _, mat = confusion(targets, preds)
    mat = mat.astype(np.float64)
    n = mat.shape[0]
    expected = np.outer(mat.sum(axis=0), mat.sum(axis=1)) / mat.sum()
    if weights is None:
        w = np.ones((n, n))
        np.fill_diagonal(w, 0)
    elif weights == "quadratic":
        grid = np.zeros((n, n)) + np.arange(n)
        w = (grid - grid.T) ** 2
    else:
        raise ValueError(f"weights must be None or 'quadratic', got {weights!r}")
    denominator = np.sum(w * expected)
    if denominator == 0:
        warnings.warn("Cohen's kappa is undefined with one label in common; nan",
                      RuntimeWarning, stacklevel=2)
        return float("nan")
    return float(1 - np.sum(w * mat) / denominator)


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``num / den``, 0 where ``den`` is 0 (``zero_division=0``)."""
    out = np.zeros(num.shape, np.float64)
    np.divide(num, den, out=out, where=den != 0)
    return out


def classification_report(targets, preds) -> dict:
    """scikit-learn's ``classification_report(targets, preds,
    output_dict=True, zero_division=0)``: per label (``"0"``, ``"1"``, ...)
    precision, recall, f1-score and support, then ``accuracy``, ``macro avg``
    and ``weighted avg``."""
    labels, mat = confusion(targets, preds)
    tp = np.diag(mat).astype(np.float64)
    pred_sum, true_sum = mat.sum(axis=0).astype(np.float64), mat.sum(axis=1).astype(np.float64)
    precision, recall = _divide(tp, pred_sum), _divide(tp, true_sum)
    f1 = _divide(2 * tp, true_sum + pred_sum)
    names = ("precision", "recall", "f1-score")
    report = {f"{lab}": {**{k: float(v) for k, v in zip(names, (p, r, f))},
                         "support": float(s)}
              for lab, p, r, f, s in zip(labels, precision, recall, f1, true_sum)}
    report["accuracy"] = float(tp.sum() / mat.sum())
    support = float(true_sum.sum())
    for name, weights in (("macro avg", None), ("weighted avg", true_sum)):
        if weights is not None and weights.sum() == 0:
            avg = {k: 0.0 for k in names}
        else:
            avg = {k: float(np.average(v, weights=weights))
                   for k, v in zip(names, (precision, recall, f1))}
        report[name] = {**avg, "support": support}
    return report
