"""The port's selection union, pooling, SENet and batch forward against the
JAX package on the CPU, from the same numpy inputs.

Selection and pooling membership must be bit-identical on identical
logits. Pooled values may differ in the last ulp (f32 sums in another
order): ``rtol=atol=1e-6``. The whole forward (``eval_batch``) also runs
its own scoring matmul, whose CPU summation order differs between XLA and
PyTorch: ``rtol=atol=1e-5``."""

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
from moc_tpu.moc.core import fuse_views as jfuse_views
from moc_tpu.moc.core import views_from_logits as jviews_from_logits
from moc_tpu.models.senet import SENet as JSENet
from moc_tpu_torch import ops as tops
from moc_tpu_torch.convert import (senet_from_jax, senet_from_state_dict,
                                   senet_state_dict_from_npz, senet_state_dict_to_npz)
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.data.batching import pack_bags
from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, sample_bag, zero_shot_weights
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.moc import MOCConfig, eval_batch, fuse_views, views_from_logits

DISCARDS = [(), ("topk",), ("delta_softmax",), ("delta_diff",), ("bottomk",),
            ("delta_softmax", "delta_diff"), ("topk", "delta_softmax", "delta_diff"),
            ("topk", "delta_softmax", "delta_diff", "bottomk")]


def _padded_logits(seed, n_valid, n_pad, c, n_bg, ties, batch=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(batch, n_pad, c)).astype(np.float32)
    ext = np.concatenate([logits, rng.normal(size=(batch, n_pad, n_bg)).astype(np.float32)],
                         axis=-1)
    if ties:
        logits, ext = np.round(logits), np.round(ext)
    valid = np.zeros((batch, n_pad), bool)
    for b in range(batch):
        valid[b, :max(1, n_valid - 97 * b)] = True
    logits[~valid] = 9.0  # pad rows hold junk the masks must ignore
    ext[~valid] = 9.0
    return logits, ext, valid


@pytest.mark.parametrize("discard", DISCARDS)
@pytest.mark.parametrize("ties", [False, True])
def test_union_selection_threshold_bit_equal(discard, ties):
    c, topj = 3, 23
    logits, ext, valid = _padded_logits(11, 140, 333, c, 4, ties)
    got = tops.union_selection_threshold(torch.from_numpy(logits), torch.from_numpy(ext),
                                         torch.from_numpy(valid), topj, c, discard).numpy()
    for b in range(logits.shape[0]):
        want = np.asarray(jops.union_selection_threshold(
            jnp.asarray(logits[b]), jnp.asarray(ext[b]), jnp.asarray(valid[b]),
            topj, c, discard))
        np.testing.assert_array_equal(got[b], want, err_msg=f"slide {b}")


def test_union_selection_serving_width_bit_equal():
    """The serving topj (400) on a non-aligned bucket, rows past the valid
    count included, C=2 with a 4-concept background bank."""
    logits, ext, valid = _padded_logits(3, 3777, 4096, 2, 4, ties=False, batch=2)
    got = tops.union_selection_threshold(torch.from_numpy(logits), torch.from_numpy(ext),
                                         torch.from_numpy(valid), 400, 2).numpy()
    for b in range(2):
        want = np.asarray(jops.union_selection_threshold(
            jnp.asarray(logits[b]), jnp.asarray(ext[b]), jnp.asarray(valid[b]), 400, 2))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("topj", [1, 10, 64])
def test_topj_pooling_matches_jax(topj):
    rng = np.random.default_rng(topj)
    logits = rng.normal(size=(4, 300, 3)).astype(np.float32)
    logits[1] = np.round(logits[1])  # tie-heavy slide
    valid = np.zeros((4, 300), bool)
    valid[0, :300] = True
    valid[1, :250] = True
    valid[2, :5] = True  # fewer valid rows than topj: count-corrected
    # slide 3 is all padding: pools to NEG_INF
    got = tops.topj_pooling(torch.from_numpy(logits), torch.from_numpy(valid), topj).numpy()
    for b in range(4):
        want = np.asarray(jops.topj_pooling(jnp.asarray(logits[b]), jnp.asarray(valid[b]),
                                            topj))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6)
    assert (got[3] == tops.NEG_INF).all()


def test_selection_capacity_matches_jax():
    for topj, c, n in [(400, 2, None), (400, 2, 1000), (10, 3, 16384), (1, 30, 7)]:
        assert tops.selection_capacity(topj, c, n) == jops.selection.selection_capacity(
            topj, c, n)


def test_views_and_fusion_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 64, 2)).astype(np.float32)
    ext = rng.normal(size=(2, 64, 6)).astype(np.float32)
    weights = rng.random((2, 64, 4)).astype(np.float32)
    views = views_from_logits(torch.from_numpy(logits), torch.from_numpy(ext), 2)
    for include in [(True,) * 4, (True, False, True, False)]:
        fused = fuse_views(torch.from_numpy(weights), views, include).numpy()
        for b in range(2):
            jv = jviews_from_logits(jnp.asarray(logits[b]), jnp.asarray(ext[b]), 2)
            np.testing.assert_allclose(views[b].numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                fused[b], np.asarray(jfuse_views(jnp.asarray(weights[b]), jv, include)),
                rtol=1e-6, atol=1e-7)


def test_senet_from_jax_and_npz_round_trip(tmp_path):
    model = JSENet(in_dim=512, out_dim=4)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 512)))
    x = np.random.default_rng(0).normal(size=(33, 512)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    senet = senet_from_jax(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        np.testing.assert_allclose(senet(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-6, atol=1e-6)
    path = senet_state_dict_to_npz(senet, str(tmp_path / "senet.npz"))
    back = senet_from_state_dict(senet_state_dict_from_npz(path))
    for key, value in senet.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def test_senet_seeded_init_is_torch_default_distribution():
    a = SENet(generator=torch.Generator().manual_seed(5))
    b = SENet(generator=torch.Generator().manual_seed(5))
    for key, value in a.state_dict().items():
        assert torch.equal(b.state_dict()[key], value)
    bound = 1 / np.sqrt(512)
    w = a.dense0.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound


def _synthetic_bags(seed, n_bags, min_patches, max_patches, dim):
    cfg = SyntheticWSIConfig(dim=dim, min_patches=min_patches, max_patches=max_patches,
                             seed=seed)
    rng = np.random.default_rng(seed)
    feats = [sample_bag(cfg, i % 2, rng)[0] for i in range(n_bags)]
    w, w_ext = zero_shot_weights(cfg)
    return feats, w, w_ext


@pytest.mark.parametrize("topj,topk,discard", [(400, 10, ()), (32, 5, ("bottomk",))])
def test_eval_batch_matches_jax(topj, topk, discard):
    feats, w, w_ext = _synthetic_bags(2, 4, 300, 1000, 512)
    jcfg = JMOCConfig(n_classes=2, n_ext_classes=6, topj=topj, topk=topk,
                      discard=discard, feature_dim=512)
    _, params = init_senet(jax.random.PRNGKey(0), jcfg)
    jbatch = jpack_bags([JBag(slide_id=str(i), features=f, label=i % 2)
                         for i, f in enumerate(feats)])
    want = np.asarray(make_episode_fns(jcfg)[1](params, jbatch, jnp.asarray(w),
                                                jnp.asarray(w_ext)))

    cfg = MOCConfig(n_classes=2, n_ext_classes=6, topj=topj, topk=topk, discard=discard,
                    feature_dim=512)
    batch = pack_bags([Bag(slide_id=str(i), features=f, label=i % 2)
                       for i, f in enumerate(feats)], device="cpu")
    assert batch.padded_len == jbatch.padded_len
    senet = senet_from_jax(jax.tree.map(np.asarray, params))
    got = eval_batch(senet, batch, torch.from_numpy(w), torch.from_numpy(w_ext), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the state-dict form of the SENet gives the same forward
    again = eval_batch(senet.state_dict(), batch, torch.from_numpy(w),
                       torch.from_numpy(w_ext), cfg)
    assert torch.equal(again, got)
