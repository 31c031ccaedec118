"""The port's Mixture-of-Experts (``parallel.moe``) against the JAX package's
on the CPU: ``capacity_for`` (eval fraction included), the top-1 and top-2
routing records on the same gate logits (expert, slot and keep bit for
bit; gate weights within 1e-6), the [S, E, C] dispatch bit for bit and
combine within 1e-6, and ``MoELayer`` forward and gradients in every
``dispatch_impl``, with and without ``expert_subln`` and ``input_mask``.

Inputs are numpy-seeded; JAX's parameters are carried across by
``convert.masked_token_model_from_jax`` (the stacked expert leaves keep
flax's names and layouts). Tolerances: f32 forwards within 1e-5 of the
largest |value|, gradients within 1e-5 of the largest |grad|; the
``einsum_bf16`` dispatch and the bf16 expert products within 2e-2 and a
mean |diff| of 1% of the mean |value|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.parallel import moe as jmoe
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.parallel import moe

S, D, HID, E = 96, 32, 64, 4


def _logits(seed, s=S, e=E, ties=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(s, e)).astype(np.float32)
    if ties:  # rows whose two largest logits tie, and a row of equal logits
        logits[::9, 1] = logits[::9, 0] = np.maximum(logits[::9, 0], logits[::9, 1]) + 1.0
        logits[5] = 0.25
    return logits


def _mask(seed, s=S):
    return np.random.default_rng(seed).random(s) < 0.2


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_capacity_for_matches_jax():
    for s in (1, 7, 96, 1000, 8192):
        for e in (1, 3, 4, 8):
            for gate in ("top1", "top2"):
                for cf in (1.0, 1.25, 2.0):
                    for frac, is_eval in ((None, False), (0.3, False), (0.3, True),
                                          (0.0, True)):
                        args = (s, e, gate, cf, frac, is_eval)
                        assert moe.capacity_for(*args) == jmoe.capacity_for(*args), args


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gate", ["top1", "top2", "top2_norm_before"])
def test_routing_records_bit_equal(gate, masked):
    """Compact records and the [S, E, C] tensors on the same logits, at a
    capacity small enough that tokens drop."""
    logits = _logits(1)
    mask = _mask(2) if masked else None
    cap = moe.capacity_for(S, E, "top1" if gate == "top1" else "top2", 1.0) // 2
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    if gate == "top1":
        jfn = lambda **kw: jmoe.top1_gate(jnp.asarray(logits), cap, jm, **kw)
        tfn = lambda **kw: moe.top1_gate(torch.from_numpy(logits), cap, tm, **kw)
    else:
        nbd = gate == "top2_norm_before"
        jfn = lambda **kw: jmoe.top2_gate(jnp.asarray(logits), cap, jm, nbd, **kw)
        tfn = lambda **kw: moe.top2_gate(torch.from_numpy(logits), cap, tm, nbd, **kw)
    (jrec, jaux), (trec, taux) = jfn(compact=True), tfn(compact=True)
    assert len(jrec) == len(trec) == (1 if gate == "top1" else 2)
    dropped = 0
    for (je, js, jk, jg), (te, ts, tk, tg) in zip(jrec, trec):
        assert np.array_equal(np.asarray(je), te.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert np.array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
        dropped += int((tk.numpy() == 0).sum())
    assert dropped > 0  # the capacity bites
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    (jc, jd, _), (tc, td, _) = jfn(), tfn()
    assert np.array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)


def _layer_pair(seed, impl, subln, compute_dtype=None):
    jcfg = jmoe.MoEConfig(n_experts=E, dispatch_impl=impl, expert_subln=subln,
                          compute_dtype=compute_dtype)
    tcfg = moe.MoEConfig(n_experts=E, dispatch_impl=impl, expert_subln=subln,
                         compute_dtype=compute_dtype)
    x = np.random.default_rng(seed).normal(size=(S, D)).astype(np.float32)
    jlayer = jmoe.MoELayer(D, HID, jcfg)
    params = jlayer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    # random expert biases and LN affines, so every leaf's path shows
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
        np.float32), jax.tree.map(np.asarray, params))
    tlayer = moe.MoELayer(D, HID, tcfg)
    state = masked_token_model_from_jax(params)
    assert set(state) == set(tlayer.state_dict())
    tlayer.load_state_dict(state)
    return jlayer, params, tlayer, x


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("subln", [False, True])
@pytest.mark.parametrize("impl", ["gather", "einsum", "einsum_bf16"])
def test_moe_layer_matches_jax(impl, subln, masked):
    """``MoELayer`` forward, aux and gradients (input and every parameter)."""
    jlayer, params, tlayer, x = _layer_pair(3, impl, subln)
    mask = _mask(4) if masked else None
    r = np.random.default_rng(5).normal(size=(S, D)).astype(np.float32)

    def jloss(p, x):
        y, aux = jlayer.apply(p, x, None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tlayer(xt, None if mask is None else torch.from_numpy(mask))
    (torch.sum(ty * torch.from_numpy(r)) + taux).backward()
    bf16 = impl == "einsum_bf16"
    tol = 2e-2 if bf16 else 1e-5
    assert _rel(ty.detach().numpy(), jy) <= tol
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    if bf16:
        mean = np.abs(ty.detach().numpy() - np.asarray(jy)).mean() / np.abs(np.asarray(jy)).mean()
        assert mean <= 1e-2
    want = masked_token_model_from_jax(jax.tree.map(np.asarray, jgp))
    got = {n: p.grad for n, p in tlayer.named_parameters()}
    scale = max(max(float(np.abs(w.numpy()).max()) for w in want.values()),
                float(np.abs(np.asarray(jgx)).max()))
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= tol * scale, (name, err, scale)
    assert float(np.abs(xt.grad.numpy() - np.asarray(jgx)).max()) <= tol * scale


def test_bf16_expert_products_match_jax():
    """``compute_dtype="bfloat16"``: the expert products in bf16, routing in f32."""
    jlayer, params, tlayer, x = _layer_pair(6, "gather", True, "bfloat16")
    jy, jaux = jlayer.apply(params, jnp.asarray(x))
    ty, taux = tlayer(torch.from_numpy(x))
    assert _rel(ty.detach().numpy(), jy) <= 2e-2
    mean = np.abs(ty.detach().numpy() - np.asarray(jy)).mean() / np.abs(np.asarray(jy)).mean()
    assert mean <= 1e-2
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_dispatch_impls_agree():
    """The three formulations route alike: ``gather`` and ``einsum`` give the
    same output within f32 rounding."""
    _, _, layer, x = _layer_pair(7, "gather", False)
    y = {}
    for impl in ("gather", "einsum"):
        layer.cfg = moe.MoEConfig(n_experts=E, dispatch_impl=impl, expert_subln=False)
        y[impl] = layer(torch.from_numpy(x))[0].detach()
    assert float((y["gather"] - y["einsum"]).abs().max()) <= 1e-5 * float(y["einsum"].abs().max())


def test_expert_parallelism_is_refused():
    """The expert axis names an axis of the active mesh (the 4-rank runs are
    ``test_torch_dist_layers``'s): without one it is refused; over a mesh of
    one rank the layer holds every expert and computes what the local one
    does."""
    from moc_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no active mesh"):
        moe.MoELayer(D, HID, moe.MoEConfig(n_experts=E), axis_name="expert")
    with pytest.raises(RuntimeError, match="no active mesh"):
        moe.moe_dispatch_combine(torch.zeros(S, D), torch.zeros(S, E), lambda t: t,
                                 moe.MoEConfig(n_experts=E), axis_name="expert")
    local = moe.MoELayer(D, HID, moe.MoEConfig(n_experts=E))
    local.reset_flax_(torch.Generator().manual_seed(0))
    with make_mesh({"expert": 1}) as mesh:
        layer = moe.MoELayer(D, HID, moe.MoEConfig(n_experts=E), axis_name="expert")
        layer.load_state_dict(moe.local_expert_state(local.state_dict(), "expert"))
    x = torch.randn(S, D, generator=torch.Generator().manual_seed(1))
    (y, aux), (want, want_aux) = layer(x), local(x)
    assert mesh.shape == {"expert": 1}
    assert torch.equal(y, want) and float(aux) == float(want_aux)
