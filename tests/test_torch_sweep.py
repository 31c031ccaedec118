"""The port's fused episode sweep (``moc_tpu_torch.moc.sweep``) against the JAX
package's on the CPU, at a small size (D = 64, bags of 60–480 patches, topj
24, 2 folds of shot 2, 3 epochs).

The host-side stackers and the pool indices are exactly equal to JAX's. The
batched SENet equals separate SENets (forward, gradients, three Adam steps
within 1e-7). The eval packs match JAX's (validity bit-equal, views within
1e-6, logits within 1e-5). On a weak-signal corpus, where val AUC is below 1
and best-val selection matters, ``run_sweep_pooled`` from JAX's initial
parameters and JAX's keep masks gives JAX's best epochs, AUCs and accuracies
(1e-5), zero-shot floor (acc and AUC equal, loss within 1e-5) and best
parameters (1e-5); it equals the port's stacked ``run_sweep``, and each of
its episodes equals the port's own ``run_episode`` of that fold."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moc_tpu.moc.episode as jepisode
import moc_tpu.moc.sweep as jsweep
from moc_tpu.data import BagLoader as JBagLoader
from moc_tpu.data import EpisodeBags as JEpisodeBags
from moc_tpu.data import SlideTable as JSlideTable
from moc_tpu.data import make_synthetic_corpus as jmake_corpus
from moc_tpu.data import read_split_csv as jread_split_csv
from moc_tpu.data.batching import BagBatch as JBagBatch
from moc_tpu.data.synthetic import SyntheticWSIConfig as JSyntheticWSIConfig
from moc_tpu.metrics import auc as jauc
from moc_tpu.models.senet import SENet as JSENet
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import core as jcore
from moc_tpu.moc.episode import episode_init_key, epoch_slide_keys
from moc_tpu_torch.convert import senet_from_jax, senet_stack_from_states
from moc_tpu_torch.data import BagLoader, EpisodeBags, SlideTable, read_split_csv
from moc_tpu_torch.data.batching import BagBatch
from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, make_synthetic_corpus
from moc_tpu_torch.metrics import auc_from_probs
from moc_tpu_torch.models.senet import SENet, SENetStack
from moc_tpu_torch.moc import (MOCConfig, assemble_episode, episode_from_bags, episode_index,
                               eval_batch, init_senet, make_optimizer, moc_logits_packed,
                               pack_slide_pool, pad_and_stack_episodes, pool_episode_splits,
                               pooled_bytes_estimate, precompute_eval_pack, run_episode,
                               run_sweep, run_sweep_pooled, stack_episode_bags,
                               sweep_episode_results, unique_split_ids)

DIM, TOPJ, TOPK, SHOT, FOLDS, EPOCHS = 64, 24, 10, 2, (0, 1), 3
VISITS = SHOT * 2
# a weak-signal corpus: AUCs below 1, so ranking and best-val selection matter
CORPUS = dict(slides_per_class=10, min_patches=60, max_patches=480, dim=DIM, seed=7,
              signal=0.1, tumor_frac=0.1)
SEEDS = (0, 3)
FIELDS = ("train_feats", "train_mask", "train_labels", "val_feats", "val_mask", "val_labels",
          "test_feats", "test_mask", "test_labels")


def _cfgs(**kw):
    common = dict(n_classes=2, n_ext_classes=6, topj=TOPJ, topk=TOPK, feature_dim=DIM,
                  num_epochs=EPOCHS, **kw)
    return JMOCConfig(**common), MOCConfig(**common)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The weak corpus made by both packages, their splits of both folds of
    shot 2, and both folds' episodes loaded by each (eval chunks of 3, so
    that chunks carry filler rows)."""
    root = tmp_path_factory.mktemp("sweep")
    layout = dict(shots=(1, SHOT), n_folds=len(FOLDS), val_per_class=2, test_per_class=4)
    jc = jmake_corpus(str(root / "jax"), JSyntheticWSIConfig(**CORPUS), **layout)
    tc = make_synthetic_corpus(str(root / "port"), SyntheticWSIConfig(**CORPUS), **layout)
    jt = JSlideTable.from_csv(jc["csv_path"], jc["label_dict"])
    tt = SlideTable.from_csv(tc["csv_path"], tc["label_dict"])
    jl, tl = JBagLoader(jt, jc["data_dir"], cache=True), BagLoader(tt, tc["data_dir"], cache=True)
    js = [jread_split_csv(jc["split_paths"][(SHOT, f)]) for f in FOLDS]
    ts = [read_split_csv(tc["split_paths"][(SHOT, f)]) for f in FOLDS]
    jeps = [JEpisodeBags.load(jl, s.train, s.val, s.test, repeat_num=VISITS, eval_batch_size=3)
            for s in js]
    teps = [EpisodeBags.load(tl, s.train, s.val, s.test, repeat_num=VISITS, eval_batch_size=3,
                             device="cpu") for s in ts]
    return dict(jc=jc, tc=tc, jl=jl, tl=tl, js=js, ts=ts, jeps=jeps, teps=teps)


def _assert_stacked_equal(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)


def _jax_init_states(jcfg, seeds):
    return [senet_from_jax(jax.tree.map(np.asarray, jepisode.init_senet(
        episode_init_key(s), jcfg)[1])).state_dict() for s in seeds]


def _jax_keep_fn(seeds):
    """The keep masks JAX's sweep draws: visit i of epoch t of episode e is
    ``bernoulli(fold_in(epoch_key(seeds[e], t), i), 0.5, (N,))``."""
    def keep_fn(e, epoch, visits, n):
        keys = epoch_slide_keys(seeds[e], epoch, visits)
        return torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(keys[i], 0.5, (n,)))
                                          for i in range(visits)]))
    return keep_fn


# ------------------------------------------------------------------ stackers and pool

def test_pool_and_indices_match_jax(corpus):
    jc, tc = corpus["jc"], corpus["tc"]
    ids = unique_split_ids(corpus["ts"])
    assert ids == jsweep.unique_split_ids(corpus["js"])
    assert len(ids) < sum(len(s.train) + len(s.val) + len(s.test) for s in corpus["ts"])
    feats, mask, row, labels = pack_slide_pool(corpus["tl"].read_all(ids), ids)
    jfeats, jmask, jrow, jlabels = jsweep.pack_slide_pool(corpus["jl"].read_all(ids), ids)
    for got, want in ((feats, jfeats), (mask, jmask), (labels, jlabels)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert row == jrow
    got, want = episode_index(corpus["ts"], row, labels), jsweep.episode_index(
        corpus["js"], jrow, jlabels)
    for name in ("train_idx", "train_labels", "val_idx", "val_labels", "test_idx", "test_labels"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), name)
    pooled = pool_episode_splits(corpus["tl"], corpus["ts"])
    jpooled = jsweep.pool_episode_splits(corpus["jl"], corpus["js"])
    jcfg, cfg = _cfgs()
    assert pooled_bytes_estimate(pooled) == jsweep.pooled_bytes_estimate(jpooled)
    assert pooled_bytes_estimate(pooled, cfg) == jsweep.pooled_bytes_estimate(jpooled, jcfg)
    assert tc["weights"].shape == jc["weights"].shape


def test_stackers_match_jax(corpus):
    teps, jeps = corpus["teps"], corpus["jeps"]
    assert any((~b.real_rows()).any() for ep in teps for b in ep.val + ep.test)  # filler rows
    per_ep = [episode_from_bags(ep.train, ep.val, ep.test) for ep in teps]
    jper_ep = [jsweep.episode_from_bags(ep.train, ep.val, ep.test) for ep in jeps]
    for got, want in zip(per_ep, jper_ep):
        _assert_stacked_equal(got, want)
    slow = pad_and_stack_episodes(per_ep)
    _assert_stacked_equal(slow, jsweep.pad_and_stack_episodes(jper_ep))
    fast = stack_episode_bags(teps)
    _assert_stacked_equal(fast, jsweep.stack_episode_bags(jeps))
    _assert_stacked_equal(fast, slow)


def test_assemble_episode_matches_jax(corpus):
    pooled = pool_episode_splits(corpus["tl"], corpus["ts"])
    jpooled = jsweep.pool_episode_splits(corpus["jl"], corpus["js"])
    got = assemble_episode(torch.from_numpy(pooled.pool_feats),
                           torch.from_numpy(pooled.pool_mask), pooled.index)
    want = jax.vmap(lambda ix: jsweep.assemble_episode(jpooled.pool_feats, jpooled.pool_mask,
                                                       ix))(jpooled.index)
    _assert_stacked_equal(got, want)
    # filler rows gather pool row 0 but carry no valid patch
    for split in ("train", "val", "test"):
        labels = getattr(got, f"{split}_labels")
        assert not getattr(got, f"{split}_mask")[labels < 0].any()


def _fuzz_chunk(rng, n_rows, n_real, n_patches, d=8):
    labels = np.full((n_rows,), -1, np.int32)
    labels[:n_real] = rng.integers(0, 2, n_real)
    feats = rng.normal(size=(n_rows, n_patches, d)).astype(np.float32)
    mask = rng.random((n_rows, n_patches)) < 0.8
    mask[n_real:] = False
    feats[~mask] = 0.0
    n = mask.sum(1).astype(np.int32)
    port = BagBatch(features=torch.from_numpy(feats), mask=torch.from_numpy(mask),
                    labels=torch.from_numpy(labels), n_patches=torch.from_numpy(n))
    return port, JBagBatch(features=jnp.asarray(feats), mask=jnp.asarray(mask),
                           labels=jnp.asarray(labels), n_patches=jnp.asarray(n))


class _Ep:
    def __init__(self, train, val, test):
        self.train, self.val, self.test = train, val, test


@pytest.mark.parametrize("trial", range(4))
def test_stackers_trim_filler_fuzz(trial):
    """Random chunk layouts (odd buckets, filler-heavy chunks, chunks of
    filler only): both stackers agree with each other and with JAX's, keep
    exactly the real slides in order, and pad no further than the widest
    episode."""
    rng = np.random.default_rng(7 + trial)
    eps, jeps = [], []
    for _ in range(3):
        train = _fuzz_chunk(rng, 4, 4, int(rng.integers(6, 20)))
        val = [_fuzz_chunk(rng, int(rng.integers(2, 6)), int(rng.integers(0, 3)),
                           int(rng.integers(6, 20))) for _ in range(2)]
        test = [_fuzz_chunk(rng, int(rng.integers(2, 6)), int(rng.integers(1, 3)),
                            int(rng.integers(6, 20)))]
        eps.append(_Ep(train[0], [v[0] for v in val], [t[0] for t in test]))
        jeps.append(_Ep(train[1], [v[1] for v in val], [t[1] for t in test]))
    fast = stack_episode_bags(eps)
    slow = pad_and_stack_episodes([episode_from_bags(ep.train, ep.val, ep.test) for ep in eps])
    _assert_stacked_equal(fast, slow)
    _assert_stacked_equal(fast, jsweep.stack_episode_bags(jeps))
    for split in ("val", "test"):
        reals = [[int(x) for c in getattr(ep, split) for x in c.labels.numpy() if x >= 0]
                 for ep in eps]
        assert getattr(fast, f"{split}_labels").shape[1] == max(max(map(len, reals)), 1)
        for i, want in enumerate(reals):
            np.testing.assert_array_equal(getattr(fast, f"{split}_labels")[i][:len(want)], want)


def test_empty_eval_split_stacks(corpus):
    """A fold with no val slides stacks to one filler row (label -1, no
    valid patch), whether every episode's split is empty or one's only."""
    teps, jeps = corpus["teps"], corpus["jeps"]
    for which in ((0, 1), (0,)):
        emptied = [dataclasses.replace(ep, val=[]) if i in which else ep
                   for i, ep in enumerate(teps)]
        jemptied = [dataclasses.replace(ep, val=[]) if i in which else ep
                    for i, ep in enumerate(jeps)]
        fast = stack_episode_bags(emptied)
        slow = pad_and_stack_episodes([episode_from_bags(ep.train, ep.val, ep.test)
                                       for ep in emptied])
        _assert_stacked_equal(fast, jsweep.stack_episode_bags(jemptied))
        _assert_stacked_equal(slow, jsweep.pad_and_stack_episodes(
            [jsweep.episode_from_bags(ep.train, ep.val, ep.test) for ep in jemptied]))
        for stacked in (fast, slow):
            assert stacked.val_labels.shape[0] == 2
            assert (stacked.val_labels[0] == -1).all() and not stacked.val_mask[0].any()
        if which == (0,):
            np.testing.assert_array_equal(fast.val_labels[1], slow.val_labels[1])
            assert (fast.val_labels[1] >= 0).any()


def test_one_shot_at_a_time(corpus):
    ep0, ep1 = (episode_from_bags(ep.train, ep.val, ep.test) for ep in corpus["teps"])
    shrunk = dataclasses.replace(ep1, train_feats=ep1.train_feats[:2],
                                 train_mask=ep1.train_mask[:2], train_labels=ep1.train_labels[:2])
    with pytest.raises(ValueError, match="one shot at a time"):
        pad_and_stack_episodes([ep0, shrunk])
    short = dataclasses.replace(corpus["teps"][1], train=BagBatch(
        *(t[:2] for t in (corpus["teps"][1].train.features, corpus["teps"][1].train.mask,
                          corpus["teps"][1].train.labels, corpus["teps"][1].train.n_patches))))
    with pytest.raises(ValueError, match="one shot at a time"):
        stack_episode_bags([corpus["teps"][0], short])
    s0, s1 = corpus["ts"]
    with pytest.raises(ValueError, match="one shot at a time"):
        episode_index([s0, dataclasses.replace(s1, train=s1.train[:1])],
                      {sid: 0 for sid in unique_split_ids([s0, s1])}, np.zeros(1, np.int32))


# ------------------------------------------------------------------ device metrics, SENet stack

@pytest.mark.parametrize("c", [2, 3])
def test_auc_from_probs_matches_jax(c):
    """Batched over 6 rows of 9 slides: valid masks, ties, and rows where a
    class is absent (binary: 0.5; ovo: the pair weighted out of the mean, 0
    where no pair is left), as JAX's device AUC."""
    rng = np.random.default_rng(c)
    logits = np.round(rng.normal(size=(6, 9, c)), 1).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, c, (6, 9)).astype(np.int32)
    labels[1] = 0  # one class only
    labels[2, :] = np.arange(9) % (c - 1) if c > 2 else labels[2]  # class c-1 absent
    valid = rng.random((6, 9)) < 0.8
    valid[3] = False  # nothing valid
    got = auc_from_probs(torch.from_numpy(probs), torch.from_numpy(labels),
                         torch.from_numpy(valid)).numpy()
    for i in range(6):
        want = float(jauc.auc_from_probs(jnp.asarray(probs[i]), jnp.asarray(labels[i]),
                                         jnp.asarray(valid[i])))
        assert abs(float(got[i]) - want) <= 1e-6, (i, got[i], want)
    assert float(got[1]) == float(got[3]) == (0.5 if c == 2 else 0.0)
    one = auc_from_probs(torch.from_numpy(probs[0]), torch.from_numpy(labels[0]))
    assert abs(float(one) - float(jauc.auc_from_probs(jnp.asarray(probs[0]),
                                                      jnp.asarray(labels[0])))) <= 1e-6


def test_senet_stack_matches_separate_senets():
    """Three episodes' SENets stacked: the forward, the gradients of the
    summed losses, and three Adam steps over the stack equal three SENets
    with three Adams (parameters within 1e-7); ``state_dict_of`` unstacks."""
    _, cfg = _cfgs()
    nets = [init_senet(s, cfg) for s in (0, 1, 2)]
    stack = senet_stack_from_states([n.state_dict() for n in nets])
    assert isinstance(stack, SENetStack) and stack.w0.shape == (3, 64, DIM)
    for e, net in enumerate(nets):
        assert all(torch.equal(stack.state_dict_of(e)[k], v) for k, v in
                   net.state_dict().items())
    opts = [make_optimizer(n.parameters(), cfg) for n in nets]
    stack_opt = make_optimizer(stack.parameters(), cfg)
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        x = torch.randn((3, 40, DIM), generator=gen)
        target = torch.rand((3, 40, 4), generator=gen)
        out = stack(x)
        for e, net in enumerate(nets):
            torch.testing.assert_close(out[e], net(x[e]), rtol=1e-6, atol=1e-7)
        stack_opt.zero_grad()
        ((out - target) ** 2).sum().backward()
        for e, (net, opt) in enumerate(zip(nets, opts)):
            opt.zero_grad()
            ((net(x[e]) - target[e]) ** 2).sum().backward()
            if step == 0:
                for name, key in (("w0", "dense0.weight"), ("b1", "dense1.bias")):
                    g = dict(net.named_parameters())[key].grad
                    torch.testing.assert_close(getattr(stack, name).grad[e], g, rtol=1e-5,
                                               atol=1e-6)
            opt.step()
        stack_opt.step()
    for e, net in enumerate(nets):
        for key, t in net.state_dict().items():
            assert (stack.state_dict_of(e)[key] - t).abs().max().item() <= 1e-7, (e, key)


def _pack_inputs(seed):
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(2, 3, 512, DIM)) / np.sqrt(DIM)).astype(np.float32)
    valid = np.zeros((2, 3, 512), bool)
    for (e, m), n in zip(np.ndindex(2, 3), (470, 133, 512, 60, 301, 0)):
        valid[e, m, :n] = True
    w = rng.normal(size=(DIM, 2)).astype(np.float32)
    w_ext = np.concatenate([w, rng.normal(size=(DIM, 4)).astype(np.float32)], 1)
    return feats, valid, w, w_ext


@pytest.mark.parametrize("discard", [(), ("bottomk",)])
def test_eval_pack_and_packed_logits_match_jax(discard):
    """Packs of two episodes' three slides (one with no valid patch) against
    JAX's per slide: validity bit-equal, features equal, views within 1e-6;
    packed logits of each episode's SENet within 1e-5 of JAX's and of the
    port's ``eval_batch``; a two-epoch trajectory ``[T, E]`` over the same
    pack equals each epoch's stack."""
    feats, valid, w, w_ext = _pack_inputs(len(discard))
    jcfg, cfg = _cfgs(discard=discard)
    jparams = [jepisode.init_senet(episode_init_key(s), jcfg)[1] for s in SEEDS]
    states = [senet_from_jax(jax.tree.map(np.asarray, p)).state_dict() for p in jparams]
    stack = senet_stack_from_states(states)
    tw, twe = torch.from_numpy(w), torch.from_numpy(w_ext)
    pack = precompute_eval_pack(torch.from_numpy(feats), torch.from_numpy(valid), tw, twe, cfg)
    with torch.no_grad():
        logits = moc_logits_packed(stack, pack, cfg)
    assert logits.shape == (2, 3, 2)
    model = JSENet(in_dim=DIM, out_dim=4)
    for e, m in np.ndindex(2, 3):
        jpack = jcore.precompute_eval_pack(jnp.asarray(feats[e, m]), jnp.asarray(valid[e, m]),
                                           jnp.asarray(w), jnp.asarray(w_ext), jcfg)
        np.testing.assert_array_equal(pack.valid[e, m].numpy(), np.asarray(jpack.valid))
        np.testing.assert_array_equal(pack.feats[e, m].numpy(), np.asarray(jpack.feats))
        np.testing.assert_allclose(pack.views[e, m].numpy(), np.asarray(jpack.views),
                                   rtol=1e-6, atol=1e-6)
        want = jcore.moc_logits_packed(model.apply, jparams[e], jpack, jcfg)
        np.testing.assert_allclose(logits[e, m].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for e in range(2):
        batch = BagBatch(features=torch.from_numpy(feats[e]), mask=torch.from_numpy(valid[e]),
                         labels=torch.zeros(3, dtype=torch.int32),
                         n_patches=torch.from_numpy(valid[e].sum(1).astype(np.int32)))
        direct = eval_batch(states[e], batch, tw, twe, cfg)
        single = SENet(DIM)
        single.load_state_dict(states[e])
        with torch.no_grad():
            packed = moc_logits_packed(single, dataclasses.replace(
                pack, feats=pack.feats[e], valid=pack.valid[e], views=pack.views[e]), cfg)
        torch.testing.assert_close(packed, direct, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(packed, logits[e], rtol=1e-5, atol=1e-5)
    traj = {k: torch.stack([p.detach(), p.detach() * 0.5]) for k, p in stack.named_parameters()}
    with torch.no_grad():
        both = moc_logits_packed(traj, pack, cfg)
        assert both.shape == (2, 2, 3, 2)
        torch.testing.assert_close(both[0], logits, rtol=1e-6, atol=1e-6)
        half = senet_stack_from_states(states)
        for p in half.parameters():
            p.mul_(0.5)
        torch.testing.assert_close(both[1], moc_logits_packed(half, pack, cfg), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------------ the sweep

@pytest.fixture(scope="module")
def jax_sweep(corpus):
    """JAX's pooled sweep of both folds (seeds 0 and 3), zero-shot floor in."""
    jcfg, _ = _cfgs()
    jpooled = jsweep.pool_episode_splits(corpus["jl"], corpus["js"])
    result = jsweep.run_sweep_pooled(jpooled, corpus["jc"]["weights"],
                                     corpus["jc"]["weights_ext"], jcfg, repeat_num=VISITS,
                                     seeds=jnp.asarray(SEEDS, jnp.int32), with_zs=True)
    return jax.tree.map(np.asarray, result), jpooled


def _port_sweep(corpus, jpooled, **kw):
    jcfg, cfg = _cfgs()
    pooled = pool_episode_splits(corpus["tl"], corpus["ts"])
    assert pooled.pool_feats.shape == np.shape(jpooled.pool_feats)
    return run_sweep_pooled(pooled, corpus["tc"]["weights"], corpus["tc"]["weights_ext"], cfg,
                            repeat_num=VISITS, seeds=SEEDS, with_zs=True, device="cpu",
                            keep_fn=_jax_keep_fn(SEEDS),
                            init_states=_jax_init_states(jcfg, SEEDS), **kw)


def test_run_sweep_pooled_matches_jax(corpus, jax_sweep):
    want, jpooled = jax_sweep
    got = _port_sweep(corpus, jpooled)
    np.testing.assert_array_equal(got.best_epoch.numpy(), want.best_epoch)
    for name in ("best_val_auc", "test_auc_at_best", "test_acc_at_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert (want.best_val_auc < 1).any() and (want.best_val_auc > 0).all()
    zs = got.zs.numpy()
    np.testing.assert_array_equal(zs[..., 1:], want.zs[..., 1:])  # acc, auc
    np.testing.assert_allclose(zs[..., 0], want.zs[..., 0], rtol=0, atol=1e-5)
    assert (want.zs[:, :, 2] < 1).any()  # the weak corpus ranks imperfectly
    for e in range(2):
        want_p = senet_from_jax(jax.tree.map(lambda x: x[e], want.best_params)).state_dict()
        res = sweep_episode_results(got)[e]
        for key, t in res.params.items():
            assert (t - want_p[key]).abs().max().item() <= 1e-5, (e, key)
        assert np.array(res.losses).shape == (EPOCHS, VISITS)
        assert np.isfinite(res.losses).all()


def test_run_sweep_equals_run_sweep_pooled(corpus, jax_sweep):
    """The stacked path (``stack_episode_bags`` of the loaded episodes) and
    the pooled one give the same sweep."""
    jcfg, cfg = _cfgs()
    pooled = _port_sweep(corpus, jax_sweep[1])
    stacked = run_sweep(stack_episode_bags(corpus["teps"]), corpus["tc"]["weights"],
                        corpus["tc"]["weights_ext"], cfg, repeat_num=VISITS, seeds=SEEDS,
                        with_zs=True, device="cpu", keep_fn=_jax_keep_fn(SEEDS),
                        init_states=_jax_init_states(jcfg, SEEDS))
    assert torch.equal(stacked.best_epoch, pooled.best_epoch)
    for name in ("best_val_auc", "test_auc_at_best", "test_acc_at_best", "zs", "losses"):
        torch.testing.assert_close(getattr(stacked, name), getattr(pooled, name), rtol=0,
                                   atol=1e-5, msg=name)
    for k, t in stacked.best_params.items():
        torch.testing.assert_close(t, pooled.best_params[k], rtol=0, atol=1e-5)


def test_sweep_matches_run_episode_per_fold(corpus):
    """The port's fused sweep against its own ``run_episode`` of each fold,
    both drawing their initial SENet and keep masks from the seed (the pool's
    bucket is the episodes' train bucket, 512): the same best epoch, the
    same zero-shot floor, values within 1e-5, the same losses."""
    _, cfg = _cfgs()
    w, w_ext = corpus["tc"]["weights"], corpus["tc"]["weights_ext"]
    pooled = pool_episode_splits(corpus["tl"], corpus["ts"])
    assert pooled.pool_feats.shape[1] == corpus["teps"][0].train.padded_len
    seeds = (5, 5)
    fused = sweep_episode_results(run_sweep_pooled(pooled, w, w_ext, cfg, repeat_num=VISITS,
                                                   seeds=seeds, with_zs=True, device="cpu"))
    for fold, ep in enumerate(corpus["teps"]):
        stream = run_episode(ep, w, w_ext, cfg, seed=seeds[fold])
        f = fused[fold]
        assert f.best_epoch == stream.best_epoch, fold
        for key in ("best_val", "test_at_best_val", "test_acc_at_best_val"):
            assert abs(getattr(f, key) - getattr(stream, key)) <= 1e-5, (fold, key)
        for part in ("zero_shot_train", "zero_shot_val", "zero_shot_test"):
            a, b = getattr(f, part), getattr(stream, part)
            assert abs(a["acc"] - b["acc"]) <= 1e-6 and abs(a["auc"] - b["auc"]) <= 1e-5
            assert abs(a["loss"] - b["loss"]) <= 1e-5, (fold, part)
        np.testing.assert_allclose(f.losses, stream.losses, rtol=0, atol=1e-5)
        for key, t in f.params.items():
            assert (t - stream.params[key]).abs().max().item() <= 1e-5, (fold, key)


def test_dense_sweep_matches_jax(corpus):
    """The ``dense`` tier's fused sweep (``sweep_step`` and the eval packs of
    ``moc_slide_logits_dense``, no selection union) against JAX's from the
    same initial SENets and keep masks: best epochs equal, AUCs, accuracies
    and best parameters within 1e-5, the zero-shot floor equal."""
    jcfg, cfg = _cfgs(dense=True)
    jpooled = jsweep.pool_episode_splits(corpus["jl"], corpus["js"])
    want = jax.tree.map(np.asarray, jsweep.run_sweep_pooled(
        jpooled, corpus["jc"]["weights"], corpus["jc"]["weights_ext"], jcfg, repeat_num=VISITS,
        seeds=jnp.asarray(SEEDS, jnp.int32), with_zs=True))
    pooled = pool_episode_splits(corpus["tl"], corpus["ts"])
    got = run_sweep_pooled(pooled, corpus["tc"]["weights"], corpus["tc"]["weights_ext"], cfg,
                           repeat_num=VISITS, seeds=SEEDS, with_zs=True, device="cpu",
                           keep_fn=_jax_keep_fn(SEEDS), init_states=_jax_init_states(jcfg, SEEDS))
    np.testing.assert_array_equal(got.best_epoch.numpy(), want.best_epoch)
    for name in ("best_val_auc", "test_auc_at_best", "test_acc_at_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.zs.numpy()[..., 1:], want.zs[..., 1:])
    for e in range(2):
        want_p = senet_from_jax(jax.tree.map(lambda x: x[e], want.best_params)).state_dict()
        for key, t in sweep_episode_results(got)[e].params.items():
            assert (t - want_p[key]).abs().max().item() <= 1e-5, (e, key)
