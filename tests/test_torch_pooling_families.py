"""The port's single selection policies, its sort-path union and its ten
pooling families against the JAX package on the CPU, from the same numpy
inputs, and against the numpy oracles of ``tests/oracles.py``.

Selection is bit-equal on identical logits, on both exact paths. The two
paths differ where keys tie +0.0 with −0.0 (the sort path ranks −0.0 below
+0.0, as ``lax.top_k`` does; the threshold path ties them): a signed-zero
case holds each path to its JAX twin and shows them apart in both packages.
Pooled values within ``rtol=atol=1e-6``, pooled indices equal; against the
oracles ``1e-5``, as the JAX package's own tests hold them. The slide-level
forward (``eval_batch``) under ``select_method="sort"`` runs its own scoring
matmul, whose CPU summation order differs between XLA and PyTorch:
``1e-5``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu import ops as jops
from moc_tpu.data.bags import Bag as JBag
from moc_tpu.data.batching import pack_bags as jpack_bags
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import init_senet, make_episode_fns
from moc_tpu.ops import selection as jselection
from moc_tpu_torch import ops as tops
from moc_tpu_torch.convert import senet_from_jax
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.data.batching import pack_bags
from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, sample_bag, zero_shot_weights
from moc_tpu_torch.moc import MOCConfig, eval_batch
from moc_tpu_torch.ops import selection as tselection
from tests import oracles as orc

C, N_BG, N_PAD, TOPJ = 3, 4, 333, 23
# valid rows a slide: all, some, fewer than TOPJ, none (pools to NEG_INF)
N_VALID = (N_PAD, 140, 5, 0)
DISCARDS = [(), ("topk",), ("delta_softmax",), ("delta_diff",), ("bottomk",),
            ("delta_softmax", "delta_diff"), ("topk", "delta_softmax", "delta_diff"),
            ("topk", "delta_softmax", "delta_diff", "bottomk")]
FOREGROUND = sorted(jops.FOREGROUND_POOLINGS)
BOTTOMK = sorted(set(jops.POOLING_REGISTRY) - jops.FOREGROUND_POOLINGS)


def _bags(seed: int, ties: bool):
    """``logits [4, N, C]``, ``logits_ext [4, N, C + N_BG]`` (its first C
    columns are ``logits``) and ``valid [4, N]``; padded rows hold NaN.
    ``ties`` rounds to integers, signed zeros included."""
    rng = np.random.default_rng(seed)
    ext = rng.normal(size=(len(N_VALID), N_PAD, C + N_BG)).astype(np.float32)
    if ties:
        ext = np.round(ext)
    valid = np.arange(N_PAD) < np.array(N_VALID)[:, None]
    ext[~valid] = np.nan
    return np.ascontiguousarray(ext[..., :C]), ext, valid


def _per_slide(fn, *arrays):
    """``fn`` of the JAX package on each slide of ``arrays``."""
    return [fn(*(jnp.asarray(a[b]) for a in arrays)) for b in range(arrays[0].shape[0])]


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


POLICIES = {
    "topj": (lambda m, lg, le, v: m.select_topj(lg, v, TOPJ), orc.sel_topj),
    "delta_softmax": (lambda m, lg, le, v: m.select_delta_softmax(lg, v, TOPJ),
                      orc.sel_delta_softmax),
    "delta_diff": (lambda m, lg, le, v: m.select_delta_diff(lg, v, TOPJ), orc.sel_delta_diff),
    "bottomk_irrel": (lambda m, lg, le, v: m.select_bottomk_irrel(le, v, TOPJ, C, bottomk=40),
                      lambda lg, le, j: orc.sel_bottomk_irrel(le, j, C, bottomk=40)),
    "bottomk_irrel_detection": (
        lambda m, lg, le, v: m.select_bottomk_irrel(le, v, TOPJ, C, detection=True),
        lambda lg, le, j: orc.sel_bottomk_irrel(le, j, C, detection=True)),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_single_policies_bit_equal(policy, ties):
    fn, oracle = POLICIES[policy]
    lg, le, valid = _bags(5, ties)
    got = fn(tops, *_t(lg, le, valid)).numpy()
    want = _per_slide(lambda a, b, v: fn(jops, a, b, v), lg, le, valid)
    for b, w in enumerate(want):
        np.testing.assert_array_equal(got[b], np.asarray(w), err_msg=f"slide {b}")
    assert not got[3].any()
    if not ties:  # the oracle's stable argsort ties −0.0 with +0.0
        if policy.startswith("bottomk"):
            want_set = oracle(None, le[0], TOPJ)
        else:
            want_set = oracle(lg[0], TOPJ)
        assert set(np.flatnonzero(got[0]).tolist()) == want_set


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("discard", DISCARDS)
def test_sort_path_unions_bit_equal(discard, ties):
    """``union_selection_composed``, ``union_selection`` and
    ``select_and_gather(method="sort")`` against the JAX package; the
    composed and the batched union agree in the port."""
    lg, le, valid = _bags(11, ties)
    args = _t(lg, le, valid)
    cap = 128
    composed = tselection.union_selection_composed(*args, TOPJ, C, discard).numpy()
    union = tops.union_selection(*args, TOPJ, C, discard).numpy()
    idx, sv, count = tops.select_and_gather(*args, TOPJ, C, cap, discard, method="sort")
    np.testing.assert_array_equal(union, composed)
    for b in range(len(N_VALID)):
        jargs = tuple(jnp.asarray(a[b]) for a in (lg, le, valid))
        np.testing.assert_array_equal(
            composed[b], np.asarray(jselection.union_selection_composed(*jargs, TOPJ, C, discard)))
        np.testing.assert_array_equal(union[b],
                                      np.asarray(jops.union_selection(*jargs, TOPJ, C, discard)))
        ji, jv, jn = jops.select_and_gather(*jargs, TOPJ, C, cap, discard=discard, method="sort")
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(sv[b].numpy(), np.asarray(jv))
        assert int(count[b]) == int(jn)
    assert int(count[3]) == 0


def _signed_zeros(seed: int):
    """All-zero logits with mixed signs (N=16, C=2, a 4-concept background)."""
    rng = np.random.default_rng(seed)
    ext = np.where(rng.random((1, 16, 6)) < 0.5, -0.0, 0.0).astype(np.float32)
    return np.ascontiguousarray(ext[..., :2]), ext, np.ones((1, 16), bool)


@pytest.mark.parametrize("topj", [3, 5])
def test_signed_zero_ties_split_sort_from_threshold(topj):
    """Each exact path matches its JAX twin; the two paths differ, in both
    packages, where keys tie +0.0 with −0.0."""
    lg, le, valid = _signed_zeros(topj)
    args, jargs = _t(lg, le, valid), tuple(jnp.asarray(a[0]) for a in (lg, le, valid))
    got = {"sort": tops.union_selection(*args, topj, 2).numpy()[0],
           "threshold": tops.union_selection_threshold(*args, topj, 2).numpy()[0]}
    want = {"sort": np.asarray(jops.union_selection(*jargs, topj, 2)),
            "threshold": np.asarray(jops.union_selection_threshold(*jargs, topj, 2))}
    for method in ("sort", "threshold"):
        np.testing.assert_array_equal(got[method], want[method], err_msg=method)
        idx, sv, count = tops.select_and_gather(*args, topj, 2, 16, method=method)
        ji, jv, jn = jops.select_and_gather(*jargs, topj, 2, 16, method=method)
        np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji), err_msg=method)
        np.testing.assert_array_equal(sv[0].numpy(), np.asarray(jv), err_msg=method)
        assert int(count[0]) == int(jn)
    assert (got["sort"] != got["threshold"]).any()
    assert (want["sort"] != want["threshold"]).any()


def test_approximate_top_k_is_refused():
    lg, le, valid = _bags(1, False)
    with pytest.raises(ValueError, match="TPU"):
        tops.union_selection(*_t(lg, le, valid), TOPJ, C, approx=True)
    with pytest.raises(ValueError, match="TPU"):
        tops.select_and_gather(*_t(lg, le, valid), TOPJ, C, 128, approx=True,
                               method="threshold")


def test_registries_match_jax():
    assert list(tops.POOLING_REGISTRY) == list(jops.POOLING_REGISTRY)
    assert tops.FOREGROUND_POOLINGS == jops.FOREGROUND_POOLINGS
    for name, fn in tops.POOLING_REGISTRY.items():
        assert fn.__name__ == jops.POOLING_REGISTRY[name].__name__
        assert getattr(tops, fn.__name__) is fn


FAMILY_CASES = ([(name, ri, False) for name in FOREGROUND for ri in (False, True)]
                + [(name, ri, det) for name in BOTTOMK for ri in (False, True)
                   for det in (False, True)])


@pytest.mark.parametrize("name,return_indices,detection", FAMILY_CASES)
@pytest.mark.parametrize("ties", [False, True])
def test_pooling_families_match_jax(name, return_indices, detection, ties):
    lg, le, valid = _bags(17, ties)
    fg = name in tops.FOREGROUND_POOLINGS
    x = lg if fg else le
    kw = {} if fg else {"n_fg": C, "detection": detection}
    got = tops.POOLING_REGISTRY[name](*_t(x, valid), TOPJ, return_indices=return_indices, **kw)
    want = _per_slide(lambda a, v: jops.POOLING_REGISTRY[name](
        a, v, TOPJ, return_indices=return_indices, **kw), x, valid)
    pooled = got[0] if return_indices else got
    for b, w in enumerate(want):
        wp = w[0] if return_indices else w
        np.testing.assert_allclose(pooled[b].numpy(), np.asarray(wp), rtol=1e-6, atol=1e-6,
                                   err_msg=f"slide {b}")
        if return_indices:
            np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(w[1]),
                                          err_msg=f"slide {b}")
    assert (pooled[3] == tops.NEG_INF).all() and torch.isfinite(pooled[:3]).all()


ORACLES = {
    "topj": orc.topj_pool,
    "delta_softmax": orc.delta_softmax_pool,
    "delta_diff": orc.delta_diff_pool,
    "topj_delta_softmax": orc.topj_delta_softmax_pool,
    "topj_delta_diff": orc.topj_delta_diff_pool,
    "bottomk_irrel": lambda le, j: orc.bottomk_irrel_pool(le, j, C),
    "bottomk_irrel_delta_softmax": lambda le, j: orc.bottomk_irrel_rank_pool(
        le, j, C, lambda f: orc.softmax(f, 1)),
    "bottomk_irrel_delta_diff": lambda le, j: orc.bottomk_irrel_rank_pool(
        le, j, C, lambda f: np.broadcast_to(orc.row_margin(f)[:, None], f.shape)),
    "topj_bottomk_irrel_delta_softmax": lambda le, j: orc.bottomk_irrel_rank_pool(
        le, j, C, lambda f: orc.softmax(f, 1) * f),
    "topj_bottomk_irrel_delta_diff": lambda le, j: orc.bottomk_irrel_rank_pool(
        le, j, C, lambda f: f * orc.row_margin(f)[:, None]),
}


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_pooling_families_match_oracles(name):
    """Each family on the unpadded rows of the partly valid slide (and on
    the slide with fewer valid rows than topj) against its numpy oracle."""
    lg, le, valid = _bags(23, False)
    fg = name in tops.FOREGROUND_POOLINGS
    x = lg if fg else le
    kw = {} if fg else {"n_fg": C}
    got = tops.POOLING_REGISTRY[name](*_t(x, valid), TOPJ, **kw).numpy()
    for b in (1, 2):
        np.testing.assert_allclose(got[b], ORACLES[name](x[b, :N_VALID[b]], TOPJ),
                                   rtol=1e-5, atol=1e-5)


def _synthetic_bags(seed, n_bags, min_patches, max_patches, dim):
    cfg = SyntheticWSIConfig(dim=dim, min_patches=min_patches, max_patches=max_patches,
                             seed=seed)
    rng = np.random.default_rng(seed)
    feats = [sample_bag(cfg, i % 2, rng)[0] for i in range(n_bags)]
    w, w_ext = zero_shot_weights(cfg)
    return feats, w, w_ext


@pytest.mark.parametrize("topj,topk,discard", [(400, 10, ()), (32, 5, ("delta_diff",))])
def test_eval_batch_under_sort_matches_jax(topj, topk, discard):
    feats, w, w_ext = _synthetic_bags(4, 4, 300, 1000, 512)
    kw = dict(n_classes=2, n_ext_classes=6, topj=topj, topk=topk, discard=discard,
              feature_dim=512, select_method="sort")
    jcfg = JMOCConfig(**kw)
    _, params = init_senet(jax.random.PRNGKey(0), jcfg)
    jbatch = jpack_bags([JBag(slide_id=str(i), features=f, label=i % 2)
                         for i, f in enumerate(feats)])
    want = np.asarray(make_episode_fns(jcfg)[1](params, jbatch, jnp.asarray(w),
                                                jnp.asarray(w_ext)))
    batch = pack_bags([Bag(slide_id=str(i), features=f, label=i % 2)
                       for i, f in enumerate(feats)], device="cpu")
    senet = senet_from_jax(jax.tree.map(np.asarray, params))
    got = eval_batch(senet, batch, torch.from_numpy(w), torch.from_numpy(w_ext),
                     MOCConfig(**kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
