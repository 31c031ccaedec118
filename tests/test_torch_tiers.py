"""The serving tiers in the port against the JAX package on the CPU: dense,
bf16 scoring, bf16 and int8 storage, and dense with int8, through
``eval_batch`` against JAX's ``make_episode_fns``; the routing of
``moc_slide_logits`` as ``tests/test_moc_core.py`` asserts it for JAX; int8
training refused; one dense training epoch against JAX's from one SENet and
one set of keep masks; the zero-shot floor of the int8 tier.

Both packages get the same numpy bags (``default_rng``), the same SENet
(JAX's ``init_senet``, carried across by ``senet_from_jax``) and the same
weights. Where bf16 products meet, the two frameworks may round one sum a
bf16 ulp apart: those tiers are compared as the JAX package compares bf16
scoring with the exact tier (union overlap above 0.95, views of the common
rows within 1e-6) or on pooled values that no boundary flip reaches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import moc_tpu.moc.episode as jepisode
from moc_tpu import ops as jops
from moc_tpu.data import batching as jbatching
from moc_tpu.data.bags import Bag as JBag
from moc_tpu.models.senet import SENet as JSENet
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import core as jcore
from moc_tpu.moc import make_episode_fns
from moc_tpu_torch.convert import senet_from_jax
from moc_tpu_torch.data import batching, synthetic
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.moc import (MOCConfig, ablation_slide_logits, eval_batch, make_optimizer,
                               moc_slide_logits, moc_slide_logits_dense,
                               moc_slide_logits_masked, slide_process, train_epoch,
                               zs_pooled_logits)
from moc_tpu_torch.moc import core
from moc_tpu_torch.moc.episode import zs_eval_batches
from tests.test_torch_episode import STRONG, _episodes, _jax_init, _jax_masks

DIM, TOPJ, TOPK = 64, 24, 10
LENGTHS = (700, 1024, 300, 1)  # one bag in the 1024 bucket fills it; one has a single patch


def _cfgs(**kw):
    common = dict(n_classes=2, n_ext_classes=6, topj=TOPJ, topk=TOPK, feature_dim=DIM, **kw)
    return JMOCConfig(**common), MOCConfig(**common)


@pytest.fixture(scope="module")
def bags():
    """Synthetic bags of unit-norm rows (CONCH's embeddings are) with the
    oracle weights (unit-norm columns, as the text tower's), both packages'
    Bag lists, and one SENet in both packages. Logits of unit vectors stay
    within [-1, 1], so no softmax key saturates to a tie at 1.0, whose
    order would rest on each framework's last ulp of exp."""
    cfg = synthetic.SyntheticWSIConfig(dim=DIM, min_patches=1024, max_patches=1024,
                                       signal=0.3, seed=13)
    rng = np.random.default_rng(13)
    feats = [synthetic.sample_bag(cfg, i % 2, rng)[0][:n] for i, n in enumerate(LENGTHS)]
    w, w_ext = synthetic.zero_shot_weights(cfg)
    _, params = jepisode.init_senet(jax.random.PRNGKey(5), _cfgs()[0])
    return {"port": [Bag(f"s{i}", f, label=i % 2) for i, f in enumerate(feats)],
            "jax": [JBag(slide_id=f"s{i}", features=f, label=i % 2)
                    for i, f in enumerate(feats)],
            "w": w, "w_ext": w_ext, "params": params,
            "senet": senet_from_jax(jax.tree.map(np.asarray, params))}


JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TIERS = {  # name: (storage dtype, MOCConfig fields)
    "dense": ("float32", dict(dense=True)),
    "score_bf16": ("float32", dict(score_dtype="bfloat16")),
    "storage_bf16": ("bfloat16", {}),
    "storage_int8": ("int8", {}),
    "dense_int8": ("int8", dict(dense=True)),
    "exact": ("float32", {}),
}


def _tier_logits(bags, tier):
    storage, kw = TIERS[tier]
    jcfg, cfg = _cfgs(**kw)
    batch = batching.pack_bags(bags["port"], device="cpu", dtype=storage)
    jbatch = jbatching.pack_bags(bags["jax"], dtype=JDTYPE[storage])
    got = eval_batch(bags["senet"], batch, torch.from_numpy(bags["w"]),
                     torch.from_numpy(bags["w_ext"]), cfg)
    _, jeval, _ = make_episode_fns(jcfg)
    want = jeval(bags["params"], jbatch, jnp.asarray(bags["w"]), jnp.asarray(bags["w_ext"]))
    return got.numpy(), np.asarray(want), batch


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_eval_batch_tier_matches_jax(bags, tier):
    """Every tier's pooled logits against JAX's ``eval_batch`` of the same
    tier within 1e-5 (the storage tiers from each package's own
    ``pack_bags``, whose bytes are equal); the single-patch bag included."""
    got, want, batch = _tier_logits(bags, tier)
    assert got.shape == want.shape == (len(LENGTHS), 2)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    print(f"{tier}: max |port - jax| of the pooled logits {err:.3e}")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert batch.features.dtype == batching.STORAGE_DTYPES[TIERS[tier][0]]


@pytest.mark.parametrize("tier,reference,tol", [("storage_bf16", "exact", 5e-2),
                                                ("score_bf16", "exact", 1e-5),
                                                ("storage_int8", "exact", 5e-2),
                                                ("dense_int8", "dense", 5e-2)])
def test_quantized_tiers_track_their_f32_forward(bags, tier, reference, tol):
    """The bf16 and int8 tiers stay near the f32 forward of their route (the
    JAX package's bound for bf16 storage, 5e-2; bf16 scoring re-scores the
    selected rows in f32) and keep its predictions on these bags."""
    got, ref = _tier_logits(bags, tier)[0], _tier_logits(bags, reference)[0]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert (got.argmax(1) == ref.argmax(1)).all()


# ------------------------------------------------------------------ routing

def _rand_bag(rng, n, n_valid, d=32, b=2):
    feats = rng.normal(size=(b, n, d)).astype(np.float32)
    feats[:, n_valid:] = 0.0
    valid = np.zeros((b, n), bool)
    valid[:, :n_valid] = True
    return torch.from_numpy(feats), torch.from_numpy(valid)


def _senet(d, seed=0):
    cfg = JMOCConfig(n_classes=2, n_ext_classes=6, feature_dim=d)
    params = jepisode.init_senet(jax.random.PRNGKey(seed), cfg)[1]
    return params, senet_from_jax(jax.tree.map(np.asarray, params))


def _ws(rng, d=32):
    return (torch.from_numpy(rng.normal(size=(d, 2)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(d, 6)).astype(np.float32)))


def _jax_per_slide(fn, params, feats, valid, w, w_ext, jcfg, **kw):
    apply = JSENet(in_dim=feats.shape[-1], out_dim=4).apply
    outs = [fn(apply, params, jnp.asarray(feats[i].float().numpy()),
               jnp.asarray(valid[i].numpy()), jnp.asarray(w.numpy()),
               jnp.asarray(w_ext.numpy()), jcfg, None, **kw) for i in range(feats.shape[0])]
    return np.stack([np.asarray(o) for o in outs])


def test_dense_equals_exact_on_separable_logits():
    """Dense (selection-free) equals the exact forward where the fused top-k
    rows all lie in the union (planted rows), as in JAX."""
    rng = np.random.default_rng(0)
    n, d = 512, 32
    feats = torch.from_numpy(rng.normal(size=(1, n, d)).astype(np.float32) * 0.1)
    feats[:, :20] += 3.0
    valid = torch.ones((1, n), dtype=torch.bool)
    w, w_ext = _ws(rng, d)
    _, senet = _senet(d)
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, topj=64, topk=10, feature_dim=d)
    with torch.no_grad():
        exact = moc_slide_logits(senet, feats, valid, w, w_ext, cfg)
        dense = moc_slide_logits_dense(senet, feats, valid, w, w_ext, cfg)
    np.testing.assert_allclose(exact.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)


def test_dense_fused_senet_matches_unfused_and_jax():
    """The dense tier's one product over ``[w | w_ext | SENet dense0]``
    equals separate products and the SENet module, and JAX's dense forward."""
    rng = np.random.default_rng(0)
    n, d = 300, 512
    feats = torch.from_numpy(rng.normal(size=(1, n, d)).astype(np.float32))
    valid = torch.from_numpy(np.arange(n) < 250)[None]
    w, w_ext = _ws(rng, d)
    params, senet = _senet(d, seed=3)
    jcfg, cfg = (c(n_classes=2, n_ext_classes=6, topj=40, topk=10, feature_dim=d, dense=True)
                 for c in (JMOCConfig, MOCConfig))
    with torch.no_grad():
        got = moc_slide_logits_dense(senet, feats, valid, w, w_ext, cfg)
        logits, logits_ext = feats @ w, feats @ w_ext
        views = core.views_from_logits(logits, logits_ext, 2)
        fused = core.fuse_views(senet(feats), views, cfg.include_flags())
        from moc_tpu_torch.ops import topj_pooling

        want = topj_pooling(fused, valid, cfg.topk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    jwant = _jax_per_slide(jcore.moc_slide_logits_dense, params, feats, valid, w, w_ext, jcfg)
    np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-5, atol=1e-5)


def _selected(sel, b=0):
    idx, valid = sel.idx[b].numpy(), sel.valid[b].numpy()
    return {int(i): p for p, i in enumerate(idx) if valid[p]}


def test_bf16_score_views_exact_and_selection_close():
    """``score_dtype="bfloat16"``: the union may move near-tied boundary
    rows, but the views of the rows both select are f32-exact (the re-score):
    within 1e-6 of the largest |view| (the re-score's 512-term sums may run
    in another order than the full-bag product's, ~1e-5 at views of ~40);
    the bf16 selection against JAX's on the same bags, the same way."""
    rng = np.random.default_rng(0)
    n, d = 512, 512
    feats = torch.from_numpy(rng.normal(size=(1, n, d)).astype(np.float32))
    valid = torch.from_numpy(np.arange(n) < 450)[None]
    w, w_ext = _ws(rng, d)
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, topj=40, topk=10, feature_dim=d)
    cfg16 = dataclasses.replace(cfg, score_dtype="bfloat16")
    exact, fast = slide_process(feats, valid, w, w_ext, cfg), slide_process(feats, valid, w,
                                                                            w_ext, cfg16)
    jfast = jcore.slide_process(jnp.asarray(feats[0].numpy()), jnp.asarray(valid[0].numpy()),
                                jnp.asarray(w.numpy()), jnp.asarray(w_ext.numpy()),
                                JMOCConfig(n_classes=2, n_ext_classes=6, topj=40, topk=10,
                                           feature_dim=d, score_dtype="bfloat16"))
    jsel = {int(i): p for p, i in enumerate(np.asarray(jfast.idx))
            if bool(np.asarray(jfast.valid)[p])}
    for other, other_views in ((_selected(exact), exact.views[0].numpy()),
                               (jsel, np.asarray(jfast.views))):
        mine = _selected(fast)
        common = sorted(set(mine) & set(other))
        overlap = len(common) / max(len(set(mine) | set(other)), 1)
        assert overlap > 0.95, overlap
        got = fast.views[0][:, [mine[i] for i in common]].numpy()
        want = other_views[:, [other[i] for i in common]]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert fast.feats.dtype == torch.float32


def test_dense_bf16_keeps_argmax_on_separable():
    rng = np.random.default_rng(1)
    n, d = 400, 512
    _, senet = _senet(d)
    w, w_ext = _ws(rng, d)
    valid = torch.from_numpy(np.arange(n) < 350)[None]
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, topj=40, topk=10, feature_dim=d, dense=True)
    for label in (0, 1):
        mu = w[:, label].numpy() * 0.05
        feats = torch.from_numpy(rng.normal(size=(1, n, d)).astype(np.float32) + mu)
        with torch.no_grad():
            f32 = moc_slide_logits_dense(senet, feats, valid, w, w_ext, cfg)
            b16 = moc_slide_logits_dense(senet, feats, valid, w, w_ext,
                                         dataclasses.replace(cfg, score_dtype="bfloat16"))
        assert int(f32.argmax()) == int(b16.argmax())
        np.testing.assert_allclose(b16.numpy(), f32.numpy(), rtol=3e-2, atol=3e-2)


def test_routes_masked_by_default_and_bf16_scoring_through_gather():
    """``exact_impl="auto"``: inference with f32 scoring is the masked
    forward, bit for bit; bf16 scoring of f32 features is the gather route
    (its exactness needs the re-score), bit for bit; training (a keep mask)
    is the gather route; all three agree with the other formulation."""
    rng = np.random.default_rng(4)
    feats, valid = _rand_bag(rng, 256, 200)
    w, w_ext = _ws(rng)
    _, senet = _senet(32)
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, feature_dim=32, topj=16, topk=8)
    assert cfg.exact_impl == "auto"
    gather = dataclasses.replace(cfg, exact_impl="gather")
    with torch.no_grad():
        assert torch.equal(moc_slide_logits(senet, feats, valid, w, w_ext, cfg),
                           moc_slide_logits_masked(senet, feats, valid, w, w_ext, cfg))
        cfg16 = dataclasses.replace(cfg, score_dtype="bfloat16")
        via = moc_slide_logits(senet, feats, valid, w, w_ext, cfg16)
        assert torch.equal(via, moc_slide_logits(senet, feats, valid, w, w_ext,
                                                 dataclasses.replace(cfg16, exact_impl="gather")))
        keep = torch.from_numpy(rng.random((2, 256)) < 0.5)
        np.testing.assert_allclose(
            moc_slide_logits(senet, feats, valid, w, w_ext, cfg, keep).numpy(),
            moc_slide_logits_masked(senet, feats, valid, w, w_ext, cfg, keep).numpy(),
            rtol=1e-6, atol=1e-6)
        assert torch.equal(moc_slide_logits(senet, feats, valid, w, w_ext, cfg, keep),
                           moc_slide_logits(senet, feats, valid, w, w_ext, gather, keep))


def test_bf16_resident_features_route_masked_and_match_gather_and_jax():
    """bf16-resident features stay on the masked route (nothing wider to
    re-score), whose values the gather route gives on the same features
    (within bf16's ulp), track the f32 forward, and match JAX's forward of
    the same bf16 features within 1e-5."""
    rng = np.random.default_rng(21)
    f32, valid = _rand_bag(rng, 256, 200)
    f16 = f32.to(torch.bfloat16)
    w, w_ext = _ws(rng)
    params, senet = _senet(32)
    cfg16 = MOCConfig(n_classes=2, n_ext_classes=6, feature_dim=32, topj=16, topk=8,
                      score_dtype="bfloat16")
    with torch.no_grad():
        via = moc_slide_logits(senet, f16, valid, w, w_ext, cfg16)
        assert torch.equal(via, moc_slide_logits_masked(senet, f16, valid, w, w_ext, cfg16))
        gather = moc_slide_logits(senet, f16, valid, w, w_ext,
                                  dataclasses.replace(cfg16, exact_impl="gather"))
        np.testing.assert_allclose(via.numpy(), gather.numpy(), rtol=3e-2, atol=3e-2)
        exact = moc_slide_logits(senet, f32, valid, w, w_ext,
                                 dataclasses.replace(cfg16, score_dtype="float32"))
        np.testing.assert_allclose(via.numpy(), exact.numpy(), rtol=5e-2, atol=5e-2)
        # f32 scoring of bf16 features: the exact upcast, as JAX promotes
        cfg = dataclasses.replace(cfg16, score_dtype="float32")
        got = moc_slide_logits(senet, f16, valid, w, w_ext, cfg)
    jcfg = JMOCConfig(n_classes=2, n_ext_classes=6, feature_dim=32, topj=16, topk=8)
    apply = JSENet(in_dim=32, out_dim=4).apply
    want = np.stack([np.asarray(jcore.moc_slide_logits(
        apply, params, jnp.asarray(f32[i].numpy()).astype(jnp.bfloat16),
        jnp.asarray(valid[i].numpy()), jnp.asarray(w.numpy()), jnp.asarray(w_ext.numpy()),
        jcfg, None)) for i in range(2)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_int8_routes_masked_and_training_on_it_raises(bags):
    """int8 rows take the masked route under every ``exact_impl``, and a keep
    mask (training) raises ValueError, as does ``train_epoch`` on an int8
    batch."""
    batch = batching.pack_bags(bags["port"], device="cpu", dtype="int8")
    w, w_ext = torch.from_numpy(bags["w"]), torch.from_numpy(bags["w_ext"])
    _, cfg = _cfgs()
    with torch.no_grad():
        masked = moc_slide_logits_masked(bags["senet"], batch.features, batch.mask, w, w_ext,
                                         cfg, scales=batch.scales)
        for impl in ("auto", "masked", "gather"):
            got = moc_slide_logits(bags["senet"], batch.features, batch.mask, w, w_ext,
                                   dataclasses.replace(cfg, exact_impl=impl),
                                   scales=batch.scales)
            assert torch.equal(got, masked), impl
    keep = torch.ones(batch.mask.shape, dtype=torch.bool)
    with pytest.raises(ValueError, match="serving tier"):
        moc_slide_logits(bags["senet"], batch.features, batch.mask, w, w_ext, cfg, keep,
                         scales=batch.scales)
    senet = senet_from_jax(jax.tree.map(np.asarray, bags["params"]))
    with pytest.raises(ValueError, match="serving tier"):
        train_epoch(senet, make_optimizer(senet.parameters(), cfg), batch, [0, 1], keep, w,
                    w_ext, cfg)


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_ablation_routes_as_in_jax(score_dtype):
    """The fixed fusions: masked and gather agree with f32 scoring; bf16
    scoring takes the gather route; each matches JAX's ablation forward."""
    rng = np.random.default_rng(12)
    feats, valid = _rand_bag(rng, 256, 190)
    w, w_ext = _ws(rng)
    kw = dict(n_classes=2, n_ext_classes=6, feature_dim=32, topj=16, topk=8,
              score_dtype=score_dtype)
    for mode in ("avg", "sum", "max"):
        got = ablation_slide_logits(feats, valid, w, w_ext, MOCConfig(**kw), mode)
        gather = ablation_slide_logits(feats, valid, w, w_ext,
                                       MOCConfig(**kw, exact_impl="gather"), mode)
        if score_dtype == "bfloat16":
            assert torch.equal(got, gather), mode
        else:
            np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=1e-6, atol=1e-6)
        want = np.stack([np.asarray(jcore.ablation_slide_logits(
            jnp.asarray(feats[i].numpy()), jnp.asarray(valid[i].numpy()),
            jnp.asarray(w.numpy()), jnp.asarray(w_ext.numpy()), JMOCConfig(**kw), mode))
            for i in range(2)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=mode)


@pytest.mark.parametrize("name", ["topj", "bottomk_irrel"])
def test_int8_zero_shot_floor_matches_jax(bags, name):
    """``zs_pooled_logits`` with int8 scales (the W8A8 product) against JAX's
    ``zs_batch`` on the int8 tier, and the floor's metrics through
    ``zs_eval_batches``."""
    jcfg, cfg = _cfgs(zs_pooling=name)
    batch = batching.pack_bags(bags["port"], device="cpu", dtype="int8")
    jbatch = jbatching.pack_bags(bags["jax"], dtype=jnp.int8)
    w, w_ext = torch.from_numpy(bags["w"]), torch.from_numpy(bags["w_ext"])
    got = zs_pooled_logits(batch.features, batch.mask, w, w_ext, cfg, scales=batch.scales)
    _, _, jzs = make_episode_fns(jcfg)
    want = np.asarray(jzs(jbatch, jnp.asarray(bags["w"]), jnp.asarray(bags["w_ext"])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    metrics = zs_eval_batches([batch], w, w_ext, cfg, torch.device("cpu"))
    jmetrics = jepisode.zs_eval_batches(jzs, [jbatch], jnp.asarray(bags["w"]),
                                        jnp.asarray(bags["w_ext"]), jcfg)
    assert metrics.acc == jmetrics.acc and metrics.auc == jmetrics.auc
    assert abs(metrics.loss - jmetrics.loss) <= 1e-5


# ------------------------------------------------------------------ dense training

@pytest.fixture(scope="module")
def strong(tmp_path_factory):
    return _episodes(tmp_path_factory.mktemp("strong"), STRONG)


def test_one_dense_epoch_matches_jax(strong):
    """JAX's scanned ``train_epoch`` of the dense tier against the port's,
    from one initial SENet and JAX's keep masks: the first step's gradients
    within 1e-5 of each parameter's largest |grad|, every visit's loss
    within 1e-5, the parameters after the epoch within 1e-5."""
    jep, tep = strong["jep"], strong["tep"]
    jcfg, cfg = _cfgs(dense=True)
    params = _jax_init(jcfg)
    order = jep.train_epoch_order()
    visits, n = len(order), jep.train.padded_len
    rngs = jepisode.epoch_slide_keys(0, 0, visits)
    jw = (jnp.asarray(strong["jc"]["weights"]), jnp.asarray(strong["jc"]["weights_ext"]))
    train_j, _, _ = make_episode_fns(jcfg)
    p1, _, jlosses = train_j(params, jepisode.make_optimizer(jcfg).init(params), jep.train,
                             jnp.asarray(order), rngs, *jw)
    keep = torch.from_numpy(_jax_masks(0, 0, visits, n))
    w, w_ext = (torch.from_numpy(strong["tc"][k]) for k in ("weights", "weights_ext"))

    i = int(order[0])
    model = JSENet(in_dim=DIM, out_dim=4)

    def jloss(p):
        logits = jcore.moc_slide_logits_dense(model.apply, p, jep.train.features[i],
                                              jep.train.mask[i], *jw, jcfg, rngs[0])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[None], jep.train.labels[i][None])[0]

    g = jax.grad(jloss)(params)["params"]
    want_g = {"dense0.weight": np.asarray(g["Dense_0"]["kernel"]).T,
              "dense0.bias": np.asarray(g["Dense_0"]["bias"]),
              "dense1.weight": np.asarray(g["Dense_1"]["kernel"]).T,
              "dense1.bias": np.asarray(g["Dense_1"]["bias"])}
    first = senet_from_jax(jax.tree.map(np.asarray, params))
    logits = moc_slide_logits_dense(first, tep.train.features[i:i + 1],
                                    tep.train.mask[i:i + 1], w, w_ext, cfg, keep[:1])
    torch.nn.functional.cross_entropy(logits, tep.train.labels[i:i + 1].long()).backward()
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
        assert diff <= 1e-5, (name, diff)


def test_tf32_flags_after_each_tier(bags):
    """The f32-scoring tiers turn TF32 off and leave it off (the exact tier
    always has); the bf16-scoring and int8 tiers leave the flags as they
    found them, under each of the four settings, with equal logits."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for tier in sorted(TIERS):
            storage, kw = TIERS[tier]
            _, cfg = _cfgs(**kw)
            batch = batching.pack_bags(bags["port"], device="cpu", dtype=storage)
            outs = []
            for matmul in (False, True):
                for cudnn in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = matmul
                    torch.backends.cudnn.allow_tf32 = cudnn
                    outs.append(eval_batch(bags["senet"], batch, torch.from_numpy(bags["w"]),
                                           torch.from_numpy(bags["w_ext"]), cfg))
                    after = (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32)
                    if cfg.score_dtype == "float32" and storage != "int8":
                        assert after == (False, False), tier
                    else:
                        assert after == (matmul, cudnn), tier
            assert all(torch.equal(outs[0], o) for o in outs[1:]), tier
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
