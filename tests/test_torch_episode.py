"""MOC episode training in the port against the JAX package on the CPU: the
data host path (table, splits, bags, episode batches), the selection
packing, ``slide_process``, the masked and gather routes, the ablation
fusion, one training epoch and a whole ``run_episode``.

Both packages start from the same numpy corpus (``default_rng`` draws), the
same initial SENet (JAX's ``init_senet``, carried across by
``convert.senet_from_jax``) and the same patch-keep masks (JAX's
``bernoulli`` of each visit's key, handed to the port as ``keep``).
Selection is bit-equal on identical logits; views within 1e-6; losses and
first-step gradients within 1e-5; parameters within Adam's bound of lr a
step; the episode's best epoch, accuracies and AUCs equal."""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import moc_tpu.moc.episode as jepisode
from moc_tpu import ops as jops
from moc_tpu.data import BagLoader as JBagLoader
from moc_tpu.data import EpisodeBags as JEpisodeBags
from moc_tpu.data import SlideTable as JSlideTable
from moc_tpu.data import make_synthetic_corpus as jmake_corpus
from moc_tpu.data import read_split_csv as jread_split_csv
from moc_tpu.data.bags import read_bag as jread_bag
from moc_tpu.data.splits import Split as JSplit
from moc_tpu.data.splits import write_split_csv as jwrite_split_csv
from moc_tpu.data.synthetic import SyntheticWSIConfig as JSyntheticWSIConfig
from moc_tpu.models.senet import SENet as JSENet
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import make_episode_fns
from moc_tpu.moc import core as jcore
from moc_tpu.moc.episode import episode_init_key, epoch_slide_keys
from moc_tpu_torch import ops as tops
from moc_tpu_torch.convert import senet_from_jax
from moc_tpu_torch.data import (BagLoader, EpisodeBags, SlideTable, Split, make_synthetic_corpus,
                                read_bag, read_split_csv, write_split_csv)
from moc_tpu_torch.data.synthetic import SyntheticWSIConfig
from moc_tpu_torch.moc import (MOCConfig, ablation_slide_logits, make_optimizer,
                               moc_slide_logits, run_episode, selection_capacity_for,
                               slide_process, train_epoch, zs_pooled_logits)

DIM, TOPJ, TOPK = 64, 24, 10
# the separable corpus of the JAX package's episode test, and a weak-signal
# one whose AUCs sit below 1, so that ranking and best-val selection matter
CORPUS = dict(slides_per_class=10, min_patches=60, max_patches=480, dim=DIM, seed=7)
STRONG, WEAK = dict(signal=0.9), dict(signal=0.1, tumor_frac=0.1)


def _episodes(root, extra):
    """The same corpus made by both packages, and shot-2 fold-0 episodes."""
    kw = dict(CORPUS, **extra)
    layout = dict(shots=(1, 2), n_folds=2, val_per_class=2, test_per_class=4)
    jc = jmake_corpus(str(root / "jax"), JSyntheticWSIConfig(**kw), **layout)
    tc = make_synthetic_corpus(str(root / "port"), SyntheticWSIConfig(**kw), **layout)
    js = jread_split_csv(jc["split_paths"][(2, 0)])
    ts = read_split_csv(tc["split_paths"][(2, 0)])
    jt = JSlideTable.from_csv(jc["csv_path"], jc["label_dict"])
    tt = SlideTable.from_csv(tc["csv_path"], tc["label_dict"])
    jep = JEpisodeBags.load(JBagLoader(jt, jc["data_dir"], cache=True), js.train, js.val,
                            js.test, repeat_num=4, eval_batch_size=4)
    tep = EpisodeBags.load(BagLoader(tt, tc["data_dir"], cache=True), ts.train, ts.val,
                           ts.test, repeat_num=4, eval_batch_size=4, device="cpu")
    return {"jc": jc, "tc": tc, "jt": jt, "tt": tt, "jep": jep, "tep": tep}


@pytest.fixture(scope="module")
def strong(tmp_path_factory):
    return _episodes(tmp_path_factory.mktemp("strong"), STRONG)


@pytest.fixture(scope="module")
def weak(tmp_path_factory):
    return _episodes(tmp_path_factory.mktemp("weak"), WEAK)


def _cfgs(**kw):
    common = dict(n_classes=2, n_ext_classes=6, topj=TOPJ, topk=TOPK, feature_dim=DIM, **kw)
    return JMOCConfig(**common), MOCConfig(**common)


def _w(corpus, jax_side):
    w, we = corpus["weights"], corpus["weights_ext"]
    return (jnp.asarray(w), jnp.asarray(we)) if jax_side else (torch.from_numpy(w),
                                                               torch.from_numpy(we))


def _jax_masks(seed, epoch, visits, n):
    """The keep masks JAX's ``slide_process`` draws for one epoch's visits."""
    keys = epoch_slide_keys(seed, epoch, visits)
    return np.stack([np.asarray(jax.random.bernoulli(keys[i], 0.5, (n,)))
                     for i in range(visits)])


def _jax_init(jcfg):
    _, params = jepisode.init_senet(episode_init_key(0), jcfg)
    return params


# ------------------------------------------------------------------ data host path

def test_corpus_table_and_splits_match_jax(strong):
    jc, tc = strong["jc"], strong["tc"]
    jt, tt = strong["jt"], strong["tt"]
    assert list(tt.slide_ids) == list(jt.slide_ids)
    assert list(tt.labels) == list(jt.labels)
    assert list(tt.case_ids) == list(jt.frame["case_id"])
    assert tt.num_classes == jt.num_classes == 2 and len(tt) == len(jt) == 20
    for c in (0, 1):
        assert list(tt.class_indices(c)) == list(jt.class_indices(c))
    assert all(tt.label_of(s) == jt.label_of(s) for s in jt.slide_ids)
    sub_ids = list(jt.slide_ids[[3, 1, 17]])
    assert list(tt.subset_by_slide_ids(sub_ids).slide_ids) == \
        list(jt.subset_by_slide_ids(sub_ids).slide_ids)
    assert sorted(tc["split_paths"]) == sorted(jc["split_paths"])
    for key, path in jc["split_paths"].items():
        js, ts = jread_split_csv(path), read_split_csv(tc["split_paths"][key])
        assert dataclasses.astuple(ts) == dataclasses.astuple(js), key
        ts.check_disjoint()
    for a, b in zip(tc["weights"], jc["weights"]):
        np.testing.assert_array_equal(a, b)


def test_bags_match_jax_h5(strong):
    jc, tc = strong["jc"], strong["tc"]
    for sid in strong["jt"].slide_ids:
        got = read_bag(tc["data_dir"], sid, label=1)
        want = jread_bag(jc["data_dir"], sid, use_h5=True)
        assert got.slide_id == sid and got.label == 1
        np.testing.assert_array_equal(got.features, want.features)


@pytest.mark.parametrize("boolean_style", [False, True])
def test_split_csv_both_styles_read_by_both_packages(tmp_path, boolean_style):
    """The JAX package writes either style; the port reads both, and its own
    column-style file is byte-equal to the JAX package's."""
    split = (("s_0", "s_1", "007"), ("s_2",), ("s_3", "s_4"))
    jwrite_split_csv(str(tmp_path / "jax.csv"), JSplit(*split), boolean_style=boolean_style)
    assert dataclasses.astuple(read_split_csv(str(tmp_path / "jax.csv"))) == split
    write_split_csv(str(tmp_path / "port.csv"), Split(*split))
    assert dataclasses.astuple(jread_split_csv(str(tmp_path / "port.csv"))) == split
    if not boolean_style:
        assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    with pytest.raises(ValueError, match="overlap"):
        Split(("a",), ("a",), ()).check_disjoint()


def _assert_batch_equal(got, want):
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(want.features))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


def test_episode_bags_match_jax(strong):
    jep, tep = strong["jep"], strong["tep"]
    _assert_batch_equal(tep.train, jep.train)
    for part in ("val", "test"):
        assert len(getattr(tep, part)) == len(getattr(jep, part))
        for got, want in zip(getattr(tep, part), getattr(jep, part)):
            _assert_batch_equal(got, want)
    np.testing.assert_array_equal(tep.train_epoch_order(), jep.train_epoch_order())
    np.testing.assert_array_equal(
        tep.train_epoch_order(np.random.default_rng(3), shuffle=True),
        jep.train_epoch_order(np.random.default_rng(3), shuffle=True))
    # past the eval budget the chunks stay on the host, with the same values
    over = EpisodeBags.load(BagLoader(strong["tt"], strong["tc"]["data_dir"]),
                            tep_ids(strong, "train"), tep_ids(strong, "val"),
                            tep_ids(strong, "test"), eval_batch_size=4,
                            eval_device_budget_gb=0.0, device="cpu")
    assert over.repeat_num == 4
    for got, want in zip(over.test, jep.test):
        _assert_batch_equal(got, want)


def tep_ids(corpus, part):
    return getattr(read_split_csv(corpus["tc"]["split_paths"][(2, 0)]), part)


def test_bag_loader_cache_under_concurrent_reads(strong):
    """More reader threads than cores on a shortened switch interval: the LRU
    cache's byte count must equal the bytes it holds, within its budget."""
    tt, data_dir = strong["tt"], strong["tc"]["data_dir"]
    ids = list(tt.slide_ids)
    one = read_bag(data_dir, ids[0]).features.nbytes
    loader = BagLoader(tt, data_dir, num_workers=32, cache=True,
                       cache_budget_gb=6 * one / 2**30)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            bags = loader.read_all(ids * 3)
    finally:
        sys.setswitchinterval(interval)
    assert [b.slide_id for b in bags] == ids * 3
    assert all(b.label == tt.label_of(b.slide_id) for b in bags)
    held = sum(b.features.nbytes for b in loader._cache.values())
    assert loader._cache_bytes == held
    assert held <= 6 * one * 2 or len(loader._cache) == 1  # bags differ in size
    unbounded = BagLoader(tt, data_dir, cache=True)
    threads = [threading.Thread(target=unbounded.read_all, args=(ids,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert set(unbounded._cache) == set(ids)
    assert unbounded._cache_bytes == sum(b.features.nbytes for b in unbounded._cache.values())


# ------------------------------------------------------------------ selection packing

@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("capacity", [128, 700])
def test_gather_selected_matches_jax(density, capacity):
    rng = np.random.default_rng(int(density * 100) + capacity)
    sel = rng.random((3, 512)) < density
    idx, valid, count = tops.gather_selected(torch.from_numpy(sel), capacity)
    for b in range(3):
        ji, jv, jn = jops.gather_selected(jnp.asarray(sel[b]), capacity)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))
        assert int(count[b]) == int(jn)


@pytest.mark.parametrize("topj,c,n", [(400, 2, 32768), (400, 2, 4096), (400, 2, 1024),
                                      (10, 3, 4096), (24, 2, 512), (375, 3, 1510)])
def test_selection_capacity_for_matches_jax(topj, c, n):
    assert selection_capacity_for(topj, c, n) == jcore.selection_capacity_for(topj, c, n)


def _bag_logits(seed, ties):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2, 512, DIM)) / np.sqrt(DIM)
    feats = (np.round(feats * 4) / 4 if ties else feats).astype(np.float32)
    valid = np.zeros((2, 512), bool)
    valid[0, :470], valid[1, :133] = True, True
    keep = rng.random((2, 512)) < 0.5
    w = rng.normal(size=(DIM, 2)).astype(np.float32)
    w_ext = np.concatenate([w, rng.normal(size=(DIM, 4)).astype(np.float32)], 1)
    return feats, valid, keep, w, w_ext


@pytest.mark.parametrize("discard", [(), ("bottomk",), ("delta_diff", "topk")])
@pytest.mark.parametrize("ties", [False, True])
def test_select_and_gather_bit_equal(discard, ties):
    feats, valid, keep, w, w_ext = _bag_logits(1, ties)
    logits_all = np.einsum("bnd,dc->bnc", feats, np.concatenate([w, w_ext], 1))
    # integer ties, as the union's own tests use: softmax keys of other
    # ties may differ by an ulp between XLA's exp and torch's
    logits_all = np.round(logits_all * 3) if ties else logits_all
    lg, le = logits_all[..., :2], logits_all[..., 2:]
    cap = selection_capacity_for(TOPJ, 2, 512)
    idx, sv, count = tops.select_and_gather(torch.from_numpy(lg), torch.from_numpy(le),
                                            torch.from_numpy(valid & keep), TOPJ, 2, cap,
                                            discard, method="threshold")
    for b in range(2):
        ji, jv, jn = jops.select_and_gather(jnp.asarray(lg[b]), jnp.asarray(le[b]),
                                            jnp.asarray(valid[b] & keep[b]), TOPJ, 2, cap,
                                            discard=discard, method="threshold")
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(sv[b].numpy(), np.asarray(jv))
        assert int(count[b]) == int(jn) > 0


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("discard", [(), ("delta_softmax",)])
def test_slide_process_matches_jax(with_keep, discard):
    feats, valid, keep, w, w_ext = _bag_logits(2, False)
    jcfg, cfg = _cfgs(discard=discard)
    got = slide_process(torch.from_numpy(feats), torch.from_numpy(valid), torch.from_numpy(w),
                        torch.from_numpy(w_ext), cfg,
                        torch.from_numpy(keep) if with_keep else None)
    for b in range(2):
        jvalid = valid[b] & keep[b] if with_keep else valid[b]
        want = jcore.slide_process(jnp.asarray(feats[b]), jnp.asarray(jvalid), jnp.asarray(w),
                                   jnp.asarray(w_ext), jcfg, None)
        np.testing.assert_array_equal(got.idx[b].numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(want.valid))
        assert int(got.count[b]) == int(want.count)
        np.testing.assert_array_equal(got.feats[b].numpy(), np.asarray(want.feats))
        np.testing.assert_allclose(got.views[b].numpy(), np.asarray(want.views),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ routes and fusion

@pytest.mark.parametrize("discard", [(), ("bottomk",), ("delta_softmax", "delta_diff")])
def test_masked_route_equals_gather_route(strong, discard):
    """Pooled logits and SENet gradients of the two formulations of one
    training visit, within 1e-5."""
    tep = strong["tep"]
    w, w_ext = _w(strong["tc"], False)
    keep = torch.from_numpy(_jax_masks(0, 0, 1, tep.train.padded_len))
    jcfg, _ = _cfgs()
    state = senet_from_jax(jax.tree.map(np.asarray, _jax_init(jcfg))).state_dict()
    out = {}
    for impl in ("masked", "gather"):
        _, cfg = _cfgs(discard=discard, exact_impl=impl)
        senet = senet_from_jax(jax.tree.map(np.asarray, _jax_init(jcfg)))
        senet.load_state_dict(state)
        logits = moc_slide_logits(senet, tep.train.features[1:2], tep.train.mask[1:2], w,
                                  w_ext, cfg, keep)
        torch.nn.functional.cross_entropy(logits, tep.train.labels[1:2].long()).backward()
        out[impl] = (logits.detach(), {n: p.grad for n, p in senet.named_parameters()})
    np.testing.assert_allclose(out["masked"][0], out["gather"][0], rtol=1e-5, atol=1e-5)
    for name, g in out["gather"][1].items():
        scale = g.abs().max().item()
        assert scale > 0, name
        assert (out["masked"][1][name] - g).abs().max().item() <= 1e-5 * scale, name


@pytest.mark.parametrize("mode", ["avg", "sum", "max"])
@pytest.mark.parametrize("impl", ["auto", "gather"])
def test_ablation_fusion_matches_jax(mode, impl):
    feats, valid, _, w, w_ext = _bag_logits(3, False)
    jcfg, cfg = _cfgs(exact_impl=impl)
    got = ablation_slide_logits(torch.from_numpy(feats), torch.from_numpy(valid),
                                torch.from_numpy(w), torch.from_numpy(w_ext), cfg, mode)
    for b in range(2):
        want = jcore.ablation_slide_logits(jnp.asarray(feats[b]), jnp.asarray(valid[b]),
                                           jnp.asarray(w), jnp.asarray(w_ext), jcfg, mode)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_zs_pooled_logits_match_jax(strong):
    jcfg, cfg = _cfgs()
    jep, tep = strong["jep"], strong["tep"]
    got = zs_pooled_logits(tep.train.features, tep.train.mask, *_w(strong["tc"], False), cfg)
    jw = _w(strong["jc"], True)
    want = jax.vmap(lambda f, v: jepisode.zs_pooled_logits(f, v, *jw, jcfg))(
        jep.train.features, jep.train.mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(jops.POOLING_REGISTRY))
def test_zs_pooled_logits_match_jax_for_every_family(strong, name):
    """Every ``zs_pooling`` family: the foreground ones pool ``feats @ w``,
    the bottom-k ones ``feats @ w_ext`` with ``n_fg = n_classes``."""
    jcfg, cfg = _cfgs(zs_pooling=name)
    jep, tep = strong["jep"], strong["tep"]
    got = zs_pooled_logits(tep.train.features, tep.train.mask, *_w(strong["tc"], False), cfg)
    jw = _w(strong["jc"], True)
    want = jax.vmap(lambda f, v: jepisode.zs_pooled_logits(f, v, *jw, jcfg))(
        jep.train.features, jep.train.mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw,err", [(dict(score_dtype="float16"), ValueError),
                                    (dict(score_dtype="int8", dense=True), ValueError),
                                    (dict(approx_topk=True), ValueError),
                                    (dict(exact_impl="dense"), ValueError)])
def test_config_refuses_unported_tiers(kw, err):
    """What the port refuses: the TPU's approximate top-k and values outside
    the JAX choices. The dense and bf16-score tiers construct (their
    forwards are held against JAX in ``tests/test_torch_tiers.py``)."""
    with pytest.raises(err, match="score_dtype|TPU|exact_impl"):
        MOCConfig(n_classes=2, n_ext_classes=6, **kw)
    for ok in (dict(dense=True), dict(score_dtype="bfloat16"),
               dict(dense=True, score_dtype="bfloat16")):
        cfg = MOCConfig(n_classes=2, n_ext_classes=6, **ok)
        assert (cfg.dense, cfg.score_dtype) == (ok.get("dense", False),
                                                ok.get("score_dtype", "float32"))


@pytest.mark.parametrize("kw", [dict(select_method="sort"), dict(zs_pooling="delta_softmax")])
def test_config_takes_the_sort_path_and_every_zs_pooling(strong, kw):
    """Accepted and run, against the JAX package on the same slides: the
    masked forward (sort) or the zero-shot floor (a pooling family); any
    value outside the JAX choices raises."""
    jcfg, cfg = _cfgs(**kw)
    tep, jep = strong["tep"], strong["jep"]
    w, w_ext = _w(strong["tc"], False)
    jw = _w(strong["jc"], True)
    if "select_method" in kw:
        params = _jax_init(jcfg)
        got = moc_slide_logits(senet_from_jax(jax.tree.map(np.asarray, params)),
                               tep.train.features, tep.train.mask, w, w_ext, cfg)
        want = jax.vmap(lambda f, v: jcore.moc_slide_logits(
            JSENet(in_dim=DIM, out_dim=4).apply, params, f, v, *jw, jcfg))(
            jep.train.features, jep.train.mask)
    else:
        got = zs_pooled_logits(tep.train.features, tep.train.mask, w, w_ext, cfg)
        want = jax.vmap(lambda f, v: jepisode.zs_pooled_logits(f, v, *jw, jcfg))(
            jep.train.features, jep.train.mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name in jops.POOLING_REGISTRY:
        assert MOCConfig(n_classes=2, n_ext_classes=6, zs_pooling=name).zs_pooling == name
    for bad in (dict(select_method="radix"), dict(zs_pooling="max")):
        with pytest.raises(ValueError, match="unknown"):
            MOCConfig(n_classes=2, n_ext_classes=6, **bad)
    jcfg = JMOCConfig(n_classes=2, n_ext_classes=6)
    cfg = MOCConfig(n_classes=2, n_ext_classes=6)
    for f in ("topj", "topk", "drop_prob", "learning_rate", "weight_decay", "num_epochs",
              "temperature", "feature_dim", "approx_topk", "select_method", "dense",
              "score_dtype", "zs_pooling", "exact_impl", "discard"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


# ------------------------------------------------------------------ training

def _jax_first_grads(jep, jcfg, params, i, rng, w, w_ext):
    model = JSENet(in_dim=DIM, out_dim=4)

    def loss(p):
        logits = jcore.moc_slide_logits(model.apply, p, jep.train.features[i],
                                        jep.train.mask[i], w, w_ext, jcfg, rng)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[None], jep.train.labels[i][None])[0]

    g = jax.grad(loss)(params)["params"]
    return {"dense0.weight": np.asarray(g["Dense_0"]["kernel"]).T,
            "dense0.bias": np.asarray(g["Dense_0"]["bias"]),
            "dense1.weight": np.asarray(g["Dense_1"]["kernel"]).T,
            "dense1.bias": np.asarray(g["Dense_1"]["bias"])}


def test_one_epoch_matches_jax(strong):
    """JAX's scanned ``train_epoch`` against the port's, from one initial
    SENet and one set of keep masks: losses and first-step gradients within
    1e-5 (of each parameter's largest |grad|), parameters within 1e-5. No
    SENet gradient is rounding noise (unlike the key bias of pretraining):
    each parameter's largest |grad| is far above f32 rounding."""
    _assert_one_epoch_matches_jax(strong)


def test_one_epoch_under_sort_matches_jax(strong):
    """The same epoch with ``select_method="sort"`` in both packages."""
    _assert_one_epoch_matches_jax(strong, select_method="sort")


def _assert_one_epoch_matches_jax(strong, **cfg_kw):
    jep, tep = strong["jep"], strong["tep"]
    jcfg, cfg = _cfgs(**cfg_kw)
    params = _jax_init(jcfg)
    order = jep.train_epoch_order()
    visits, n = len(order), jep.train.padded_len
    rngs = epoch_slide_keys(0, 0, visits)
    jw = _w(strong["jc"], True)
    train_j, _, _ = make_episode_fns(jcfg)
    p1, _, jlosses = train_j(params, jepisode.make_optimizer(jcfg).init(params), jep.train,
                             jnp.asarray(order), rngs, *jw)

    keep = torch.from_numpy(_jax_masks(0, 0, visits, n))
    w, w_ext = _w(strong["tc"], False)
    first = senet_from_jax(jax.tree.map(np.asarray, params))
    i = int(order[0])
    logits = moc_slide_logits(first, tep.train.features[i:i + 1], tep.train.mask[i:i + 1], w,
                              w_ext, cfg, keep[:1])
    torch.nn.functional.cross_entropy(logits, tep.train.labels[i:i + 1].long()).backward()
    want_g = _jax_first_grads(jep, jcfg, params, i, rngs[0], *jw)
    for name, p in first.named_parameters():
        scale = np.abs(want_g[name]).max()
        assert scale > 1e-4, f"{name}: largest |grad| {scale} is near rounding noise"
        assert np.abs(p.grad.numpy() - want_g[name]).max() <= 1e-5 * scale, name

    senet = senet_from_jax(jax.tree.map(np.asarray, params))
    losses = train_epoch(senet, make_optimizer(senet.parameters(), cfg), tep.train, order,
                         keep, w, w_ext, cfg)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0, atol=1e-5)
    want_p = senet_from_jax(jax.tree.map(np.asarray, p1)).state_dict()
    for name, t in senet.state_dict().items():
        diff = (t - want_p[name]).abs().max().item()
        assert diff <= min(1e-5, visits * cfg.learning_rate), (name, diff)


def test_run_episode_matches_jax(weak, monkeypatch):
    """A 3-epoch episode on the weak corpus from JAX's initial SENet and
    masks: the same zero-shot floor, best epoch, best val AUC, test AUC and
    accuracy at best val, and losses within 1e-5 of JAX's, visit by visit."""
    jcfg, cfg = _cfgs(num_epochs=3)
    jlosses = []
    make = jepisode.make_episode_fns

    def recording(c):
        train, ev, zs = make(c)

        def train_recorded(*args):
            out = train(*args)
            jlosses.append(np.asarray(out[2]).tolist())
            return out

        return train_recorded, ev, zs

    monkeypatch.setattr(jepisode, "make_episode_fns", recording)
    want = jepisode.run_episode(weak["jep"], weak["jc"]["weights"], weak["jc"]["weights_ext"],
                                jcfg, seed=0)
    init = senet_from_jax(jax.tree.map(np.asarray, _jax_init(jcfg))).state_dict()
    got = run_episode(weak["tep"], weak["tc"]["weights"], weak["tc"]["weights_ext"], cfg, seed=0,
                      keep_fn=lambda e, v, n: torch.from_numpy(_jax_masks(0, e, v, n)),
                      init_state=init)
    g, w = got.to_dict(), want.to_dict()
    assert list(g) == list(w)
    for key in ("best_val", "test_at_best_val", "test_acc_at_best_val", "best_epoch"):
        assert g[key] == w[key], key
    for key in ("zero_shot_train", "zero_shot_val", "zero_shot_test"):
        assert (g[key]["acc"], g[key]["auc"]) == (w[key]["acc"], w[key]["auc"]), key
        assert abs(g[key]["loss"] - w[key]["loss"]) <= 1e-5, key
    assert 0 < w["zero_shot_train"]["auc"] < 1  # the weak corpus ranks imperfectly
    np.testing.assert_allclose(np.array(got.losses), np.array(jlosses), rtol=0, atol=1e-5)
    want_p = senet_from_jax(jax.tree.map(np.asarray, want.params)).state_dict()
    for name, t in got.params.items():
        assert (t - want_p[name]).abs().max().item() <= 1e-5, name
