"""The port's CLIP adapter zoo (``models.adapters``) against the JAX
package's on the CPU: all 8 ``uncertainty`` kinds, ``ClipAdapter``,
``TipAdapter``, ``MoEClipAdapter`` (soft and switch gates, the balance
loss), ``AMUAdapter`` (bottleneck and linear main branches) and
``zero_shot_pooled``, forwards and gradients, with JAX's parameters
carried over by ``convert.from_jax``; the numpy helpers
(``linear_adapter_init``, ``gt_mask_keep``, ``fewshot_aux_features``)
equal. Tolerances: forwards within 1e-5 of the largest |value|, gradients
within 1e-5 of the largest |grad|; the switch gate's top-1 bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.models import adapters as jad
from moc_tpu_torch.convert import flax_tree_state, from_jax, to_jax
from moc_tpu_torch.models import adapters as ad

N, D, C, TOPJ, D_AUX = 48, 32, 3, 5, 24
CFG = dict(c_in=D, n_classes=C, reduction=4, clip_ratio=0.2, topj=TOPJ)
KINDS = ["entropy", "energy", "max", "max-min", "var", "top5", "moment", "none"]


def _inputs(seed=0, n_valid=40, nan_pads=False):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    valid = np.arange(N) < n_valid
    if nan_pads:  # pads may hold anything; the pooled forward must not see them
        feats[~valid] = np.nan
    aux = rng.normal(size=(N, D_AUX)).astype(np.float32)
    clf = rng.normal(size=(D, C)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    return feats, valid, aux, clf


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest |value|"


@pytest.mark.parametrize("kind", KINDS)
def test_uncertainty_matches_jax(kind):
    logits = np.random.default_rng(1).normal(size=(N, 6)).astype(np.float32) * 3
    _close(ad.uncertainty(torch.from_numpy(logits), kind, 1.5),
           jad.uncertainty(jnp.asarray(logits), kind, 1.5), what=kind)
    with pytest.raises(ValueError, match="invalid uncertainty"):
        ad.uncertainty(torch.from_numpy(logits), "bogus", 1.0)


def _cases():
    feats, valid, aux, clf = _inputs()
    cache = jad.linear_adapter_init(feats[:10], np.arange(10) % C, C, D)
    aux_cache = np.random.default_rng(5).normal(size=(D_AUX, C)).astype(np.float32)
    cfg, pcfg = jad.AdapterConfig(**CFG), ad.AdapterConfig(**CFG)
    return {
        "clip": (jad.ClipAdapter(cfg), lambda g: ad.ClipAdapter(pcfg, g), False),
        "tip": (jad.TipAdapter(cfg), lambda g: ad.TipAdapter(pcfg, generator=g), False),
        "tip_cache": (jad.TipAdapter(cfg, cache_init=cache),
                      lambda g: ad.TipAdapter(pcfg, cache_init=cache, generator=g), False),
        "moe_soft": (jad.MoEClipAdapter(cfg, n_experts=3),
                     lambda g: ad.MoEClipAdapter(pcfg, 3, generator=g), False),
        "moe_switch": (jad.MoEClipAdapter(cfg, n_experts=3, use_switch_gate=True,
                                          use_balance_loss=True),
                       lambda g: ad.MoEClipAdapter(pcfg, 3, True, True, generator=g), False),
        "amu": (jad.AMUAdapter(cfg, c_in_aux=D_AUX, aux_ratio=0.3, uncertainty_type="entropy"),
                lambda g: ad.AMUAdapter(pcfg, D_AUX, 0.3, "entropy", generator=g), True),
        "amu_linear": (jad.AMUAdapter(cfg, c_in_aux=D_AUX, aux_ratio=0.3,
                                      uncertainty_type="moment", aux_cache_init=aux_cache,
                                      main_adapter="linear", main_cache_init=cache),
                       lambda g: ad.AMUAdapter(pcfg, D_AUX, 0.3, "moment",
                                               aux_cache_init=aux_cache, main_adapter="linear",
                                               main_cache_init=cache, generator=g), True),
    }


CASES = sorted(_cases())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", CASES)
def test_adapter_forward_and_grads_match_jax(name):
    """Pooled logits (and the aux pool or the balance loss) and the gradients
    of every parameter, from JAX's initial parameters, on a padded bag; the
    pooled forward unchanged when the pads hold NaN (their gradients are NaN
    in either package: 0·NaN in the kernel's product)."""
    jmod, make, uses_aux = _cases()[name]
    feats, valid, aux, clf = _inputs()
    args = (feats, valid, aux, clf) if uses_aux else (feats, valid, clf)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0),
                                                *map(jnp.asarray, args)))
    rng = np.random.default_rng(9)
    weights = [rng.normal(size=(C,)).astype(np.float32), np.float32(0.7)]

    def loss(out, ws):
        outs = out if isinstance(out, tuple) else (out,)
        return sum((o * w).sum() for o, w in zip(outs, ws))

    def jloss(p):
        out = jmod.apply(p, *map(jnp.asarray, args))
        return loss(out, [jnp.asarray(w) for w in weights]), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    module = from_jax(make(torch.Generator().manual_seed(0)), params, torch_layouts=False)
    out = module(*(torch.from_numpy(np.asarray(a)) for a in args))
    loss(out, [torch.tensor(w) for w in weights]).backward()
    outs = out if isinstance(out, tuple) else (out,)
    jouts = jout if isinstance(jout, tuple) else (jout,)
    assert len(outs) == len(jouts)
    for o, jo in zip(outs, jouts):
        assert bool(torch.isfinite(o).all())
        _close(o.detach(), jo, what=f"{name} output")
    flat = _flat(jgrads["params"])
    scale = max(np.abs(v).max() for v in flat.values())
    grads = {n: p.grad for n, p in module.named_parameters()}
    assert set(grads) == set(flat)
    for n, g in grads.items():
        err = np.abs(g.numpy() - flat[n]).max() / scale
        assert err <= 1e-5, f"{name} {n}: {err:.3e}"
    nan_args = list(args)
    nan_args[0] = _inputs(nan_pads=True)[0]
    with torch.no_grad():
        again = module(*(torch.from_numpy(np.asarray(a)) for a in nan_args))
    # the pooled logits (the balance loss multiplies the pads' gate by 0, as
    # JAX's does, so NaN pads reach it in both)
    assert torch.equal(outs[0].detach(), again[0] if isinstance(again, tuple) else again)
    tree = to_jax(module)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, {"params": dict(sorted(params["params"].items()))}))


def test_moe_switch_top1_and_balance_loss_match_jax():
    """The switch gate's top-1 per token bit for bit (ties to expert 0 when
    the gate's kernel is zero), and ``load_balancing_loss`` over a batch of
    slides equal to JAX's per slide."""
    feats, valid, _, clf = _inputs()
    cfg = jad.AdapterConfig(**CFG)
    jmod = jad.MoEClipAdapter(cfg, n_experts=4, use_switch_gate=True, use_balance_loss=True)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(2), jnp.asarray(feats),
                                                jnp.asarray(valid), jnp.asarray(clf)))
    params["params"]["gate"]["kernel"] = np.zeros_like(params["params"]["gate"]["kernel"])
    jpooled, jloss = jmod.apply(params, jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(clf))
    module = from_jax(ad.MoEClipAdapter(ad.AdapterConfig(**CFG), 4, True, True), params,
                      torch_layouts=False)
    pooled, bal = module(torch.from_numpy(feats), torch.from_numpy(valid), torch.from_numpy(clf))
    _close(pooled.detach(), jpooled)
    _close(bal.detach(), jloss)
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(4), size=(3, 20)).astype(np.float32)
    probs[1, :5] = 0.25  # ties
    idx = np.argmax(probs, -1)
    v = rng.random((3, 20)) < 0.7
    got = ad.load_balancing_loss(torch.from_numpy(probs),
                                 torch.argmax(torch.from_numpy(probs), -1), torch.from_numpy(v))
    assert np.array_equal(torch.argmax(torch.from_numpy(probs), -1).numpy(), idx)
    want = np.stack([np.asarray(jad.load_balancing_loss(jnp.asarray(probs[i]),
                                                        jnp.asarray(idx[i]), jnp.asarray(v[i])))
                     for i in range(3)])
    _close(got, want)


def test_balance_loss_needs_the_switch_gate():
    with pytest.raises(ValueError, match="use_switch_gate"):
        ad.MoEClipAdapter(ad.AdapterConfig(**CFG), 3, use_switch_gate=False,
                          use_balance_loss=True)


@pytest.mark.parametrize("topj", [1, 5, 60])
def test_zero_shot_pooled_matches_jax(topj):
    feats, valid, _, clf = _inputs(n_valid=12)
    _close(ad.zero_shot_pooled(torch.from_numpy(feats), torch.from_numpy(valid),
                               torch.from_numpy(clf), topj),
           jad.zero_shot_pooled(jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(clf), topj))


def test_batched_adapters_pool_each_slide_as_jax_vmaps():
    """A leading slide axis: each row pools as JAX's single-slide call."""
    f0, v0, _, clf = _inputs(0, 40)
    f1, v1, _, _ = _inputs(1, 7)
    jmod = jad.ClipAdapter(jad.AdapterConfig(**CFG))
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(f0),
                                                jnp.asarray(v0), jnp.asarray(clf)))
    module = from_jax(ad.ClipAdapter(ad.AdapterConfig(**CFG)), params, torch_layouts=False)
    got = module(torch.from_numpy(np.stack([f0, f1])), torch.from_numpy(np.stack([v0, v1])),
                 torch.from_numpy(clf))
    for i, (f, v) in enumerate(((f0, v0), (f1, v1))):
        _close(got[i].detach(), jmod.apply(params, jnp.asarray(f), jnp.asarray(v),
                                           jnp.asarray(clf)))


def test_numpy_helpers_equal_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(12, D)).astype(np.float32)
    labels = np.arange(12) % C
    assert np.array_equal(ad.linear_adapter_init(feats, labels, C, D),
                          jad.linear_adapter_init(feats, labels, C, D))
    coords = rng.integers(0, 4000, (30, 2))
    mask = rng.random((50, 40)) < 0.2
    assert np.array_equal(ad.gt_mask_keep(coords, (4224, 3224), mask),
                          jad.gt_mask_keep(coords, (4224, 3224), mask))
    slides = [rng.normal(size=(n, D)).astype(np.float32) for n in (5, 9, 3)]
    keeps = [None, rng.random(9) < 0.5, None]
    for kp in (None, keeps):
        got, want = ad.fewshot_aux_features(slides, [0, 1, 0], kp), \
            jad.fewshot_aux_features(slides, [0, 1, 0], kp)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_seeded_init_draws_kaiming_a5():
    """Without JAX's tree the kernels come from the generator: the same seed
    gives the same adapter, with std (1/sqrt 3)/sqrt(fan_in)."""
    cfg = ad.AdapterConfig(c_in=256, n_classes=2)
    a = ad.ClipAdapter(cfg, torch.Generator().manual_seed(3))
    b = ad.ClipAdapter(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    std = a.adapter.down.kernel.std().item()
    assert abs(std - (1 / np.sqrt(3)) / np.sqrt(256)) < 0.05 * std
    assert set(flax_tree_state(to_jax(a)["params"])) == set(a.state_dict())
