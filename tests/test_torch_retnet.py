"""RetNet in the port against the JAX package on the CPU: the position
tables and decay mask, multi-scale retention in its parallel, recurrent and
chunkwise forms against JAX's and against each other (recurrent state
threaded across calls at absolute positions), the GLU in both activations
and the whole ``RetNetDecoder`` in the three forms, with gradients in the
parallel one.

Inputs are numpy-seeded at L ≤ 64, width 32; JAX's parameters are carried
across by ``convert.from_jax``. Tolerances: forwards within 1e-5 of the
largest |value|, gradients within 1e-5 of the largest |grad|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.nn import retnet as jret
from moc_tpu_torch.convert import from_jax, to_jax
from moc_tpu_torch.nn import retnet

KW = dict(embed_dim=32, value_dim=64, heads=4, ffn_dim=64, layers=2)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


def _x(seed, length=32):
    return np.random.default_rng(seed).normal(size=(2, length, KW["embed_dim"])).astype(
        np.float32)


def test_tables_match_jax():
    for offset in (0, 7):
        for got, want in zip(retnet.retention_rel_pos(20, 4, 8, offset),
                             jret.retention_rel_pos(20, 4, 8, offset)):
            assert _rel(got, want) <= 1e-6
    _, _, decay = jret.retention_rel_pos(20, 4, 8)
    assert _rel(retnet._decay_mask(20, torch.from_numpy(np.asarray(decay))),
                jret._decay_mask(20, decay)) <= 1e-6
    x = _x(0)[:, :20].reshape(2, 20, 4, 8)
    sin, cos, _ = jret.retention_rel_pos(20, 4, 8)
    want = jret.theta_shift(jnp.asarray(x), sin[:, None], cos[:, None])
    got = retnet.theta_shift(torch.from_numpy(x), torch.from_numpy(np.asarray(sin))[:, None],
                             torch.from_numpy(np.asarray(cos))[:, None])
    assert _rel(got, want) <= 1e-6


def _retention(seed, stabilize=True):
    cfg = jret.RetNetConfig(**KW)
    jmod = jret.MultiScaleRetention(cfg, stabilize=stabilize)
    x = _x(seed)
    params = _np(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    tmod = retnet.MultiScaleRetention(retnet.RetNetConfig(**KW), stabilize=stabilize)
    from_jax(tmod, params)
    return jmod, params, tmod, x


@pytest.mark.parametrize("mode", ["parallel", "recurrent", "chunkwise"])
def test_retention_forms_match_jax(mode):
    jmod, params, tmod, x = _retention(1)
    want, jstate = jmod.apply(params, jnp.asarray(x), mode=mode, chunk_size=8)
    with torch.no_grad():
        got, state = tmod(torch.from_numpy(x), mode=mode, chunk_size=8)
    assert _rel(got, want) <= 1e-5
    if mode == "parallel":
        assert state is None and jstate is None
    else:
        assert _rel(state[0], jstate[0]) <= 1e-5
        assert float(np.abs(np.asarray(state[1], np.float64) - np.asarray(jstate[1])).max()
                     ) <= 1e-5 * max(1.0, float(np.abs(np.asarray(jstate[1])).max()))


def test_retention_forms_agree():
    """Without the parallel form's detached row scale the three forms are one
    function; the recurrent form threads its state across calls."""
    _, _, tmod, x = _retention(2, stabilize=False)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        par, _ = tmod(xt, mode="parallel")
        rec, _ = tmod(xt, mode="recurrent")
        chk, _ = tmod(xt, mode="chunkwise", chunk_size=8)
        first, s = tmod(xt[:, :12], mode="recurrent")
        second, _ = tmod(xt[:, 12:], mode="recurrent", state=s, pos_offset=12)
    assert _rel(rec, par) <= 1e-5 and _rel(chk, par) <= 1e-5
    assert _rel(torch.cat([first, second], 1), rec) <= 1e-5


@pytest.mark.parametrize("activation", ["gelu", "swish"])
def test_retnet_decoder_matches_jax(activation):
    cfg = jret.RetNetConfig(**KW, activation=activation)
    jmodel = jret.RetNetDecoder(cfg)
    x = _x(3)
    params = _np(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                          params)
    tmodel = from_jax(retnet.RetNetDecoder(retnet.RetNetConfig(**KW, activation=activation)),
                      params)
    back = to_jax(tmodel, torch_layouts=True)["params"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params["params"]),
                            jax.tree_util.tree_leaves(back)):
        assert np.array_equal(w, g), jax.tree_util.keystr(path)
    r = rng.normal(size=x.shape).astype(np.float32)
    (_, jout), jgrads = jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * r), o))(jmodel.apply(p, jnp.asarray(x))[0]),
        has_aux=True)(params)
    out, _ = tmodel(torch.from_numpy(x))
    torch.sum(out * torch.from_numpy(r)).backward()
    assert _rel(out, jout) <= 1e-5
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    want = from_jax(retnet.RetNetDecoder(tmodel.cfg), _np(jgrads)).state_dict()
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert float((got[name] - w).abs().max()) <= 1e-5 * scale, name
    for mode in ("recurrent", "chunkwise"):
        want, _ = jmodel.apply(params, jnp.asarray(x), mode=mode, chunk_size=8)
        with torch.no_grad():
            got, states = tmodel(torch.from_numpy(x), mode=mode, chunk_size=8)
        assert _rel(got, want) <= 1e-5 and len(states) == KW["layers"]
