"""The port's MI-Zero and tile evaluation against the JAX package's on the
CPU: pooled logits within 1e-6 at j ∈ {1, 5, 10, 50, 100}, the patch-level
and coordinate dumps, and every metric equal to scikit-learn's (which the
JAX package calls) within 1e-12 for C = 2, C = 3 (ovo AUC) and a one-class
split; the host metrics alone over the cases where scikit-learn gives nan
or counts a class that only the predictions hold."""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.data import batching as jbatching
from moc_tpu.data.bags import Bag as JBag
from moc_tpu.zeroshot import eval as jeval
from moc_tpu_torch.data import batching
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.zeroshot import eval as zeval

D, TOPJ = 32, (1, 5, 10, 50, 100)


def _close(got, want, what):
    """Equal within 1e-12, nan equal to nan, dicts key for key."""
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
        return
    if math.isnan(want):
        assert math.isnan(got), what
    else:
        assert got == pytest.approx(want, rel=0, abs=1e-12), what


def _case(n_classes, labels, seed):
    """Bags of 30–300 patches with coords (and one filler labelled −1), and a
    classifier ``[D, C]``; class c's slides lean towards column c."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(D, n_classes)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0)
    bags = []
    for i, y in enumerate([*labels, -1]):
        n = int(rng.integers(30, 300))
        f = rng.normal(size=(n, D)).astype(np.float32)
        if y >= 0:
            f[: n // 3] += 0.6 * w[:, y]
        bags.append((f"s{i}", f, rng.integers(0, 10 ** 5, size=(n, 2)).astype(np.int32), y))
    return bags, w


CASES = {"binary": (2, [0, 1] * 7), "three_class": (3, [0, 1, 2] * 5),
         "one_class": (2, [1] * 9)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("project", [False, True])
def test_run_mizero_matches_jax(case, project):
    n_classes, labels = CASES[case]
    bags, w = _case(n_classes, labels, seed=len(labels) + project)
    proj = (np.random.default_rng(9).normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)
    chunks = [bags[i: i + 6] for i in range(0, len(bags), 6)]
    jbatches = [jbatching.pack_bags([JBag(s, f, c, y) for s, f, c, y in ch], with_coords=True)
                for ch in chunks]
    batches = [batching.pack_bags([Bag(s, f, c, y) for s, f, c, y in ch], device="cpu",
                                  with_coords=True) for ch in chunks]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, wdump = jeval.run_mizero(jbatches, w, topj=TOPJ, dump_patch_level=True,
                                       project_fn=(lambda f: f @ proj) if project else None)
        got, dump = zeval.run_mizero(
            batches, w, topj=TOPJ, dump_patch_level=True,
            project_fn=(lambda f: f @ torch.from_numpy(proj)) if project else None)
    np.testing.assert_array_equal(dump["targets"], wdump["targets"])
    assert len(dump["targets"]) == len(labels)
    for j in TOPJ:
        np.testing.assert_allclose(dump["logits"][j], wdump["logits"][j], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(dump["preds"][j], wdump["preds"][j])
    _close(got, {m: {j: float(v) for j, v in per_j.items()} for m, per_j in want.items()},
           case)
    assert len(dump["patch_logits"]) == len(dump["coords"]) == len(labels)
    for a, b in zip(dump["patch_logits"], wdump["patch_logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(dump["coords"], wdump["coords"]):
        np.testing.assert_array_equal(a, b)
    if case == "one_class":
        assert all(math.isnan(v) for v in got["roc_auc"].values())


METRIC_CASES = {
    "binary": (2, [0, 1, 1, 0, 1, 0, 0, 1, 1, 1], None),
    "three_class_ovo": (3, [0, 1, 2, 2, 1, 0, 2, 1, 0, 2, 2], None),
    "three_class_two_present": (3, [0, 2, 2, 0, 2, 0], None),  # AUC nan: columns ≠ classes
    "one_class": (2, [0] * 7, None),
    "pred_class_absent_from_targets": (3, [0, 1, 1, 0, 1, 0], [2, 1, 1, 0, 2, 0]),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_classification_metrics_equal_sklearn(case):
    n_classes, targets, preds = METRIC_CASES[case]
    rng = np.random.default_rng(len(targets))
    probs = rng.dirichlet(np.ones(n_classes), size=len(targets))
    targets = np.asarray(targets)
    preds = probs.argmax(1) if preds is None else np.asarray(preds)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jeval.classification_metrics(probs, preds, targets, ())
        got = zeval.classification_metrics(probs, preds, targets, ())
        picked = zeval.classification_metrics(probs, preds, targets, ("kappa", "acc"))
    _close(got, want, case)
    assert list(picked) == ["kappa", "acc"]


def test_tile_evaluation_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(D, 3)).astype(np.float32)
    tiles = [(rng.normal(size=(5, D)).astype(np.float32), rng.integers(0, 3, 5))
             for _ in range(3)]

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    want, wdump = jeval.run_zeroshot_tiles(lambda x: jnp.asarray(unit(np.asarray(x))), tiles, w)
    got, dump = zeval.run_zeroshot(
        lambda x: x / torch.linalg.vector_norm(x, dim=-1, keepdim=True), tiles, w,
        device="cpu")
    np.testing.assert_allclose(dump["logits"], wdump["logits"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(dump["preds"], wdump["preds"])
    _close(got, {k: float(v) for k, v in want.items()}, "tiles")


def test_pack_bags_coords_need_every_bag():
    bags = [Bag("a", np.ones((3, 4), np.float32), np.arange(6, dtype=np.int32).reshape(3, 2), 0),
            Bag("b", np.ones((2, 4), np.float32), None, 1)]
    with pytest.raises(ValueError, match="lack coords"):
        batching.pack_bags(bags, device="cpu", with_coords=True)
    batch = batching.pack_bags(bags[:1], n_pad=512, device="cpu", with_coords=True)
    assert batch.coords.shape == (1, 512, 2) and batch.coords[0, 3:].eq(0).all()
    assert batching.pack_bags(bags, device="cpu").coords is None
