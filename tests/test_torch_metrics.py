"""The port's AUC and accuracy metrics against the JAX package's on the CPU.

``roc_auc_host`` is held to the JAX package's ``roc_auc_host`` (scikit-learn
with the reference's arguments) within 1e-12, and raises, warns or returns
nan where scikit-learn does; ``auc_binary``, ``auc_ovo_macro`` and
``auc_ovr_macro`` to the JAX package's f32 versions within 1e-6, padded
rows and absent classes included."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.metrics import auc as jauc
from moc_tpu.metrics import classification as jclassification
from moc_tpu_torch.metrics import (auc_binary, auc_ovo_macro, auc_ovr_macro, balanced_accuracy,
                                   roc_auc_host)


def _probs(rng, m, c, ties):
    logits = rng.normal(size=(m, c))
    if ties:
        logits = np.round(logits)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _labels(rng, m, c, absent=None):
    labels = rng.integers(0, c, size=m)
    labels[:c] = np.arange(c)  # every class present...
    if absent is not None:  # ...but this one
        labels[labels == absent] = (absent + 1) % c
    return labels


CASES = [(m, c, ties) for m in (5, 9, 40, 301) for c in (2, 3, 5) for ties in (False, True)]
DEVICE_CASES = [case for case in CASES if case[0] in (9, 301)]


@pytest.mark.parametrize("m,c,ties", CASES)
def test_roc_auc_host_matches_sklearn(m, c, ties):
    rng = np.random.default_rng(m * 10 + c + ties)
    probs, labels = _probs(rng, m, c, ties), _labels(rng, m, c)
    want = jauc.roc_auc_host(probs, labels)
    assert abs(roc_auc_host(probs, labels) - want) <= 1e-12
    # the binary entry on the score column alone
    if c == 2:
        assert abs(roc_auc_host(probs[:, 1], labels) - want) <= 1e-12


@pytest.mark.parametrize("scores", ["random", "ties", "constant", "saturated"])
def test_roc_auc_host_binary_score_kinds(scores):
    rng = np.random.default_rng(5)
    labels = _labels(rng, 60, 2)
    x = {"random": rng.random(60), "ties": np.round(rng.random(60) * 3) / 3,
         "constant": np.full(60, 0.25),
         "saturated": np.where(rng.random(60) < 0.7, 1.0, rng.random(60))}[scores]
    probs = np.stack([1 - x, x], 1).astype(np.float32)
    assert abs(roc_auc_host(probs, labels) - jauc.roc_auc_host(probs, labels)) <= 1e-12
    # labels {0, 2}: the larger is the positive class, as in scikit-learn
    assert abs(roc_auc_host(x, labels * 2) - jauc.roc_auc_host(x, labels * 2)) <= 1e-12


def _outcome(fn, *args):
    """('ok', value), ('nan', warned) or ('raise', type) of one call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = fn(*args)
        except ValueError:
            return ("raise", ValueError)
    if np.isnan(value):
        return ("nan", bool(caught))
    return ("ok", round(value, 12))


@pytest.mark.parametrize("case", ["one_class", "absent_class_3", "absent_class_5", "nan",
                                  "not_probabilities", "multiclass_1d", "binary_labels_3_cols"])
def test_roc_auc_host_fails_where_sklearn_does(case):
    rng = np.random.default_rng(7)
    probs, labels = _probs(rng, 30, 3, False), _labels(rng, 30, 3)
    if case == "one_class":
        probs, labels = _probs(rng, 30, 2, False), np.ones(30, int)
    elif case.startswith("absent_class"):
        c = int(case[-1])
        probs, labels = _probs(rng, 30, c, False), _labels(rng, 30, c, absent=1)
    elif case == "nan":
        probs[3, 1] = np.nan
    elif case == "not_probabilities":
        probs = probs * 2
    elif case == "multiclass_1d":
        probs = probs[:, 0]
    elif case == "binary_labels_3_cols":
        labels = labels % 2
    want = _outcome(jauc.roc_auc_host, probs, labels)
    assert want[0] != "ok", want
    assert _outcome(roc_auc_host, probs, labels) == want


@pytest.mark.parametrize("m,c,ties", DEVICE_CASES)
def test_device_aucs_match_jax(m, c, ties):
    rng = np.random.default_rng(m + 7 * c + ties)
    probs, labels = _probs(rng, m, c, ties), _labels(rng, m, c)
    valid = rng.random(m) < 0.8
    pt, lt, vt = torch.from_numpy(probs), torch.from_numpy(labels), torch.from_numpy(valid)
    pj, lj, vj = jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(valid)
    pairs = [(auc_binary(pt[:, 1], (lt == 1).int(), vt), jauc.auc_binary(pj[:, 1], lj == 1, vj)),
             (auc_ovo_macro(pt, lt, vt), jauc.auc_ovo_macro(pj, lj, vj)),
             (auc_ovr_macro(pt, lt, vt), jauc.auc_ovr_macro(pj, lj, vj)),
             (auc_ovo_macro(pt, lt), jauc.auc_ovo_macro(pj, lj))]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("c", [2, 3, 4])
def test_device_aucs_weight_out_absent_classes(c):
    rng = np.random.default_rng(c)
    probs, labels = _probs(rng, 50, c, False), _labels(rng, 50, c, absent=c - 1)
    pt, lt = torch.from_numpy(probs), torch.from_numpy(labels)
    pj, lj = jnp.asarray(probs), jnp.asarray(labels)
    for got, want in ((auc_ovo_macro(pt, lt), jauc.auc_ovo_macro(pj, lj)),
                      (auc_ovr_macro(pt, lt), jauc.auc_ovr_macro(pj, lj))):
        assert abs(float(got) - float(want)) <= 1e-6
    # one class only: the binary AUC falls back to 0.5, as in the JAX package
    ones = torch.ones(50, dtype=torch.int64)
    assert float(auc_binary(pt[:, 0], ones)) == float(jauc.auc_binary(pj[:, 0], jnp.ones(50))) \
        == 0.5


@pytest.mark.parametrize("c", [2, 3, 5])
@pytest.mark.parametrize("absent", [None, 0])
def test_balanced_accuracy_matches_jax(c, absent):
    rng = np.random.default_rng(c + (absent or 0))
    logits = rng.normal(size=(40, c)).astype(np.float32)
    labels = _labels(rng, 40, c, absent)
    valid = rng.random(40) < 0.9
    got = balanced_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), c,
                            torch.from_numpy(valid))
    want = jclassification.balanced_accuracy(jnp.asarray(logits), jnp.asarray(labels), c,
                                             jnp.asarray(valid))
    assert abs(float(got) - float(want)) <= 1e-6
