"""Kernel K1's plain PyTorch version against the JAX package: exact top-k
membership masks (``threshold_topk_mask``, ``masked_col_topk_mask``) and the
rank-ordered ``masked_col_topk``, bit for bit, on ties, ±0.0, pads, k above
the valid count and N that is not a multiple of 128. The kernel itself runs
only on a GPU (``tests/test_torch_cuda.py`` and ``chip_smoke.py``); here its
wrapper must refuse CPU tensors and bad arguments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.ops import masking as jmask
from moc_tpu.ops.topk_kernel import topk_threshold_mask_tpu
from moc_tpu_torch.ops import masking as tmask
from moc_tpu_torch.ops import selection as tsel
from moc_tpu_torch.ops import topk_kernel

KINDS = ("normal", "ties", "signed_zeros", "padded")


def _keys(kind: str, rows: int, n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(rows, n)).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 3, size=(rows, n)).astype(np.float32)
    if kind == "signed_zeros":
        return rng.choice([-0.0, 0.0, 1.0, -1.0], size=(rows, n)).astype(np.float32)
    # NEG_INF-padded rows holding fewer valid keys than k
    x = rng.normal(size=(rows, n)).astype(np.float32)
    x[:, max(1, k // 3):] = jmask.NEG_INF
    return x


def _lax_topk_set(x: np.ndarray, k: int) -> np.ndarray:
    """The set ``lax.top_k`` selects after ``+0.0``: ``lax.top_k`` itself ranks
    −0.0 below +0.0, while the threshold search (both packages) ties them."""
    _, idx = jax.lax.top_k(jnp.asarray(x) + 0.0, k)
    ref = np.zeros(x.shape, bool)
    np.put_along_axis(ref, np.asarray(idx), True, axis=-1)
    return ref


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(256, 40), (300, 17), (128, 128), (1000, 400),
                                 (4096, 10), (129, 1)])
def test_threshold_mask_matches_jax(kind, n, k):
    x = _keys(kind, 4, n, k, seed=n * 7 + k)
    got = tmask.threshold_topk_mask(torch.from_numpy(x), k).numpy()
    assert (got.sum(-1) == k).all()
    np.testing.assert_array_equal(
        got, np.asarray(jmask.threshold_topk_mask(jnp.asarray(x), k, axis=-1)))
    np.testing.assert_array_equal(got, _lax_topk_set(x, k))
    if n % 128 == 0:  # the Pallas kernel takes lane-aligned rows only
        np.testing.assert_array_equal(
            got, np.asarray(topk_threshold_mask_tpu(jnp.asarray(x), k)))
    # selection's dispatch sends CPU tensors to the same plain version
    np.testing.assert_array_equal(
        tsel.topk_threshold_mask(torch.from_numpy(x), k).numpy(), got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k,n_valid", [(300, 10, 300), (512, 10, 7),
                                         (1000, 400, 650)])
def test_masked_col_topk_mask_matches_jax(kind, n, k, n_valid):
    x = _keys(kind, 3, n, k, seed=n + k).T.copy()  # [N, C]
    valid = np.arange(n) < n_valid
    want = np.asarray(jmask.masked_col_topk_mask(jnp.asarray(x), jnp.asarray(valid), k))
    # batch of two slides: the second one's rows reversed
    xb = np.stack([x, x[::-1].copy()])
    vb = np.stack([valid, valid[::-1].copy()])
    got = tmask.masked_col_topk_mask(torch.from_numpy(xb), torch.from_numpy(vb), k).numpy()
    np.testing.assert_array_equal(got[0], want)
    want1 = np.asarray(jmask.masked_col_topk_mask(jnp.asarray(xb[1]), jnp.asarray(vb[1]), k))
    np.testing.assert_array_equal(got[1], want1)


@pytest.mark.parametrize("kind", KINDS)
def test_masked_col_topk_rank_order_matches_lax_topk(kind):
    """The stable sort gives ``lax.top_k``'s order: key descending, ties by
    ascending index, −0.0 below +0.0."""
    n, k = 700, 123
    x = _keys(kind, 3, n, k, seed=5).T.copy()
    valid = np.arange(n) < 500
    jv, ji = jmask.masked_col_topk(jnp.asarray(x), jnp.asarray(valid), k)
    tv, ti = tmask.masked_col_topk(torch.from_numpy(x), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_masking_helpers_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 50, 6)).astype(np.float32)
    logits[0, 3] = 0.5  # tied top-2 row: margin 0
    valid = rng.random((2, 50)) < 0.7
    t_l, t_v = torch.from_numpy(logits), torch.from_numpy(valid)
    for b in range(2):
        jl, jv = jnp.asarray(logits[b]), jnp.asarray(valid[b])
        np.testing.assert_array_equal(tmask.masked_logits(t_l, t_v)[b].numpy(),
                                      np.asarray(jmask.masked_logits(jl, jv)))
        np.testing.assert_array_equal(tmask.masked_row_margin(t_l)[b].numpy(),
                                      np.asarray(jmask.masked_row_margin(jl)))
        np.testing.assert_allclose(tmask.bottomk_bg_key(t_l, t_v, 2)[b].numpy(),
                                   np.asarray(jmask.bottomk_bg_key(jl, jv, 2)),
                                   rtol=1e-6)
        for kb in (10, 45):
            np.testing.assert_array_equal(
                tmask.bottomk_stage_valid(kb, t_v)[b].numpy(),
                np.asarray(jmask.bottomk_stage_valid(kb, jv)))
    vals = np.sort(logits, axis=1)[:, ::-1].copy()
    counts = np.array([0, 7], np.int32)
    got = tmask.topk_mean(torch.from_numpy(vals), 10, torch.from_numpy(counts)).numpy()
    for b in range(2):
        want = np.asarray(jmask.topk_mean(jnp.asarray(vals[b]), 10, jnp.asarray(counts[b])))
        np.testing.assert_allclose(got[b], want, rtol=1e-6)
    assert (got[0] == jmask.NEG_INF).all()


def test_monotone_map_matches_jax():
    # no subnormals: XLA on the CPU flushes them to zero, PyTorch keeps them
    x = np.array([-np.inf, -1e30, -2.5, -1e-30, -0.0, 0.0, 1e-30, 3.0, np.inf],
                 np.float32)
    want = np.asarray(jmask.monotone_u32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(tmask.monotone_u32(torch.from_numpy(x) + 0.0).numpy(), want)
    assert (np.diff(tmask.monotone_u32(torch.from_numpy(x)).numpy()) > 0).all()


@pytest.mark.parametrize("bad,match", [("cpu", "CUDA tensors"), ("dtype", "float32"),
                                       ("k_low", "k <= N"), ("k_high", "k <= N"),
                                       ("rank", r"\[R, N\]")])
def test_kernel_wrappers_refuse_bad_input(bad, match):
    """The wrappers launch on CUDA tensors or raise: no quiet fallback."""
    x = torch.zeros((4, 64))
    k = 5
    if bad == "dtype":
        x = x.double()
    elif bad == "k_low":
        k = 0
    elif bad == "k_high":
        k = 65
    elif bad == "rank":
        x = x[0]
    before = (topk_kernel.topk_threshold_mask_cuda.launches,
              topk_kernel.col_topk_threshold_mask_cuda.launches)
    with pytest.raises(ValueError, match=match):
        topk_kernel.topk_threshold_mask_cuda(x, k)
    if bad != "rank":
        with pytest.raises(ValueError, match=match):
            topk_kernel.col_topk_threshold_mask_cuda(x.T.contiguous(), k)
    assert (topk_kernel.topk_threshold_mask_cuda.launches,
            topk_kernel.col_topk_threshold_mask_cuda.launches) == before
