"""The port's chunked-bag accumulation (``train.accum``) against the JAX
package's on the CPU: ``streaming_attention_pool`` with and without remat
against JAX's scan and against the unchunked masked attention pool
(pooled embedding, logsumexp and the gradients of the embedding and
scoring parameters, within 1e-5 of the largest |value|), NaN pads, an
all-pad bag pooling to zeros, and ``chunk_bag``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.train import accum as jaccum
from moc_tpu_torch.train import accum

N, F, D, CHUNK = 37, 12, 16, 8


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest |value|"


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(F, D)).astype(np.float32) * 0.4,
            "v": rng.normal(size=(D,)).astype(np.float32)}


def _bag(n_valid, seed=1, nan_pads=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, F)).astype(np.float32)
    valid = np.arange(N) < n_valid
    if nan_pads:
        x[~valid] = np.nan
    return x, valid


def _port_fns(p):
    w = torch.tensor(p["w"], requires_grad=True)
    v = torch.tensor(p["v"], requires_grad=True)
    return (lambda x: torch.tanh(x @ w)), (lambda h: h @ v), w, v


def _jax_fns(p):
    return (lambda x: jnp.tanh(x @ p["w"])), (lambda h: h @ p["v"])


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("n_valid", [37, 20, 1])
def test_streaming_pool_matches_jax_and_the_unchunked_pool(remat, n_valid):
    p = _params()
    x, valid = _bag(n_valid, nan_pads=False)
    wl = np.random.default_rng(2).normal(size=(D,)).astype(np.float32)

    def jloss(p):
        embed, score = _jax_fns(p)
        chunks, cv = jaccum.chunk_bag(jnp.asarray(x), jnp.asarray(valid), CHUNK)
        pooled, lse = jaccum.streaming_attention_pool(embed, score, chunks, cv, remat=remat)
        return jnp.sum(pooled * wl) + 0.3 * lse, (pooled, lse)

    (_, (jpooled, jlse)), jg = jax.value_and_grad(jloss, has_aux=True)(p)
    embed, score, w, v = _port_fns(p)
    chunks, cv = accum.chunk_bag(torch.from_numpy(x), torch.from_numpy(valid), CHUNK)
    pooled, lse = accum.streaming_attention_pool(embed, score, chunks, cv, remat=remat)
    ((pooled * torch.from_numpy(wl)).sum() + 0.3 * lse).backward()
    _close(pooled.detach(), jpooled, what="pooled")
    _close(lse.detach(), jlse, what="lse")
    scale = max(np.abs(jg["w"]).max(), np.abs(jg["v"]).max())
    for got, want in ((w.grad, jg["w"]), (v.grad, jg["v"])):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale
    # NaN pads leave the forward as it was (their gradients are NaN in either
    # package: the encoder's backward multiplies them by 0)
    xn, _ = _bag(n_valid, nan_pads=True)
    with torch.no_grad():
        again = accum.streaming_attention_pool(
            embed, score, *accum.chunk_bag(torch.from_numpy(xn), torch.from_numpy(valid), CHUNK),
            remat=remat)
    assert torch.equal(again[0], pooled.detach()) and torch.equal(again[1], lse.detach())

    # the unchunked masked attention pool: softmax over the valid rows
    with torch.no_grad():
        xv = torch.from_numpy(x[valid])
        h = embed(xv)
        a = torch.softmax(score(h), dim=0)
        _close(pooled.detach(), a @ h, what="unchunked")
        _close(lse.detach(), torch.logsumexp(score(h), 0), what="unchunked lse")


def test_all_pad_bag_pools_to_zeros():
    p = _params()
    x, valid = _bag(0, nan_pads=True)
    embed, score, w, _ = _port_fns(p)
    chunks, cv = accum.chunk_bag(torch.from_numpy(x), torch.from_numpy(valid), CHUNK)
    pooled, lse = accum.streaming_attention_pool(embed, score, chunks, cv)
    assert torch.equal(pooled.detach(), torch.zeros(D))
    jembed, jscore = _jax_fns(p)
    jchunks, jcv = jaccum.chunk_bag(jnp.asarray(x), jnp.asarray(valid), CHUNK)
    jpooled, jlse = jaccum.streaming_attention_pool(jembed, jscore, jchunks, jcv)
    assert np.array_equal(np.asarray(jpooled), pooled.detach().numpy())
    assert float(lse.detach()) == pytest.approx(float(jlse), rel=1e-6)
    x0 = np.zeros_like(x)
    pooled, _ = accum.streaming_attention_pool(
        embed, score, *accum.chunk_bag(torch.from_numpy(x0), torch.from_numpy(valid), CHUNK))
    pooled.sum().backward()
    assert torch.equal(w.grad, torch.zeros_like(w))


@pytest.mark.parametrize("n,chunk", [(37, 8), (32, 8), (5, 16)])
def test_chunk_bag_matches_jax(n, chunk):
    x = np.random.default_rng(0).normal(size=(n, 3, 2)).astype(np.float32)
    valid = np.random.default_rng(1).random(n) < 0.6
    got = accum.chunk_bag(torch.from_numpy(x), torch.from_numpy(valid), chunk)
    want = jaccum.chunk_bag(jnp.asarray(x), jnp.asarray(valid), chunk)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and np.array_equal(g.numpy(), np.asarray(w_))


def test_remat_recomputes_the_encoder_in_the_backward():
    """With remat the backward runs the encoder once more per chunk; without
    it, never; the gradients are equal."""
    p = _params()
    x, valid = _bag(30, nan_pads=False)
    grads = []
    for remat, extra in ((False, 0), (True, 5)):
        calls = []
        embed, score, w, _ = _port_fns(p)

        def counted(x, embed=embed, calls=calls):
            calls.append(1)
            return embed(x)

        chunks, cv = accum.chunk_bag(torch.from_numpy(x), torch.from_numpy(valid), CHUNK)
        pooled, _ = accum.streaming_attention_pool(counted, score, chunks, cv, remat=remat)
        assert len(calls) == 5
        pooled.sum().backward()
        assert len(calls) == 5 + extra
        grads.append(w.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
