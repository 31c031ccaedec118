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
# the tie cases the kernel's branches rely on: ties equal to the fill, ties
# beyond it at the end of a row, all-equal rows
TIE_KINDS = ("exact_fill", "tail_ties", "all_equal")


def _keys(kind: str, rows: int, n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(rows, n)).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 3, size=(rows, n)).astype(np.float32)
    if kind == "signed_zeros":
        return rng.choice([-0.0, 0.0, 1.0, -1.0], size=(rows, n)).astype(np.float32)
    if kind == "all_equal":
        return np.full((rows, n), 0.5, np.float32)
    if kind in ("exact_fill", "tail_ties"):
        # k // 3 keys above v_k = 1.0; the rest of the k members are ties at
        # it: as many ties as the fill, at random places (the kernel's fast
        # path), or more than the fill, at the end of the row (ranked)
        x = (rng.normal(size=(rows, n)) - 10).astype(np.float32)
        above = k // 3
        ties = k - above if kind == "exact_fill" else min(n - above, 2 * (k - above) + 1)
        for row in x:
            if kind == "exact_fill":
                pos = rng.permutation(n)
                row[pos[:above]] = 5 + rng.random(above)
                row[pos[above:above + ties]] = 1.0
            else:
                row[rng.permutation(n - ties)[:above]] = 5 + rng.random(above)
                row[n - ties:] = 1.0
        return x
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


def _assert_rows_match_jax(x: np.ndarray, k: int) -> None:
    got = tmask.threshold_topk_mask(torch.from_numpy(x), k).numpy()
    assert (got.sum(-1) == k).all()
    np.testing.assert_array_equal(
        got, np.asarray(jmask.threshold_topk_mask(jnp.asarray(x), k, axis=-1)))
    np.testing.assert_array_equal(got, _lax_topk_set(x, k))
    if x.shape[-1] % 128 == 0:  # the Pallas kernel takes lane-aligned rows only
        np.testing.assert_array_equal(
            got, np.asarray(topk_threshold_mask_tpu(jnp.asarray(x), k)))


@pytest.mark.parametrize("kind", KINDS + TIE_KINDS)
@pytest.mark.parametrize("n,k", [(256, 40), (300, 17), (128, 128), (1000, 400),
                                 (4096, 10), (129, 1)])
def test_threshold_mask_matches_jax(kind, n, k):
    x = _keys(kind, 4, n, k, seed=n * 7 + k)
    _assert_rows_match_jax(x, k)
    # selection's dispatch sends CPU tensors to the same plain version
    np.testing.assert_array_equal(tsel.topk_threshold_mask(torch.from_numpy(x), k).numpy(),
                                  tmask.threshold_topk_mask(torch.from_numpy(x), k).numpy())


@pytest.mark.parametrize("kind", KINDS + TIE_KINDS)
@pytest.mark.parametrize("rows,k", [(5, 400), (2, 10)])
def test_training_step_shapes_match_jax(kind, rows, k):
    """A B=1 slide step at NSCLC: 2C+1 = 5 selection rows at topj=400 and
    C = 2 pooling columns at topk=10, over the 4096 bucket."""
    _assert_rows_match_jax(_keys(kind, rows, 4096, k, seed=rows * 31 + k), k)


def test_column_mask_at_six_classes_matches_jax():
    """The column entry's layout at C = 6 (NSCLC's extended classes): a
    non-contiguous ``[B, N, C]`` view, each slide against JAX's
    ``masked_col_topk_mask``, with ties straddling and at the fill."""
    n, k = 1024, 400
    x = np.concatenate([_keys("tail_ties", 3, n, k, seed=1), _keys("exact_fill", 3, n, k, seed=2),
                        _keys("ties", 6, n, k, seed=3)])  # [12, N]: columns
    scores = torch.from_numpy(x).view(2, 6, n).transpose(1, 2)  # [2, N, 6], strided
    valid = torch.from_numpy(np.arange(n)[None] < np.array([[n], [700]]))
    got = tmask.masked_col_topk_mask(scores, valid, k).numpy()
    assert got.shape == (2, n, 6) and (got.sum(-2) == k).all()
    for b in range(2):
        want = jmask.masked_col_topk_mask(jnp.asarray(scores[b].numpy()),
                                          jnp.asarray(valid[b].numpy()), k)
        np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.mark.parametrize("rows,n,cluster,staged", [
    (40, 16384, 4, True), (16, 16384, 8, True), (5, 4096, 8, True), (2, 4096, 8, True),
    (40, 512, 1, True), (1, 1000, 1, True), (40, 1500, 2, True), (40, 65536, 4, True),
    (40, 131072, 8, True), (200, 32768, 2, True), (2, 393216, 8, True), (2, 400000, 8, False),
    (0, 64, 1, True)])
def test_cluster_plan(rows, n, cluster, staged):
    """The launch plan of the CUDA kernel: rows × cluster fills the H100's
    132 SMs where each CTA keeps at least 512 keys, slices of at most 16384
    keys where 8 CTAs allow, and streaming past 8 × 49152 keys."""
    p = topk_kernel.plan(rows, n)
    assert (p.cluster, p.staged) == (cluster, staged)
    assert p.slice % 4 == 0 and p.cluster * p.slice >= n > (p.cluster - 1) * p.slice
    assert not p.staged or p.slice <= topk_kernel.MAX_STAGED_KEYS


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
