"""Kernel K2's plain PyTorch version and the port's flash-attention entry
points against the JAX package's, on the CPU: causal and non-causal,
segment ids with rows that match no key, ``padding_mask``, lengths 200, 785
and 1024, f32 and bf16 (bf16 also over D 32, 64 and 128). JAX runs its
Pallas kernel in interpret mode for the lane-aligned lengths and its dense
reference for the others, as its own tests do. The kernel itself runs only on a GPU (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here its wrapper must refuse CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.ops import flash_attention as jfa
from moc_tpu_torch.ops import flash_attention as tfa
from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

# the tolerances of the JAX package's own flash tests
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MASK = np.float32(jfa.DEFAULT_MASK_VALUE)


def _inputs(seed, b=1, h=2, lq=200, lkv=None, d=64, dtype="float32"):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, lq, d), (b, h, lkv or lq, d), (b, h, lkv or lq, d)]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tt


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_mask_value_matches_jax():
    assert tfa.DEFAULT_MASK_VALUE == jfa.DEFAULT_MASK_VALUE


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [200, 785, 1024])
def test_with_lse_matches_jax(length, causal):
    (jq, jk, jv), (q, k, v) = _inputs(0, lq=length)
    want, want_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal)
    got, got_lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    _close(got, want)
    _close(got_lse, want_lse)
    _close(tfa.flash_attention(q, k, v, causal=causal),
           jfa.flash_attention(jq, jk, jv, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_cross_lengths_match_jax(causal):
    """Lq != Lkv, top-left causal alignment, an explicit ``sm_scale``."""
    (jq, jk, jv), (q, k, v) = _inputs(1, lq=256, lkv=512)
    want, want_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal, sm_scale=0.1)
    got, got_lse = tfa.flash_attention_with_lse(q, k, v, causal=causal, sm_scale=0.1)
    _close(got, want)
    _close(got_lse, want_lse)


@pytest.mark.parametrize("length", [200, 1024])
def test_rows_masked_everywhere_give_mean_v(length):
    """A query whose segment matches no key: every key is masked at
    DEFAULT_MASK_VALUE and still counts, so the row is mean(V) and its lse
    the mask value itself (``+ log L`` is lost at that magnitude in f32)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, b=2, lq=length)
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 3, size=(2, length)).astype(np.int32)
    q_seg = seg.copy()
    q_seg[:, :8] = 7  # no key is in segment 7
    want, want_lse = jfa.flash_attention_with_lse(
        jq, jk, jv, q_segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(seg))
    got, got_lse = tfa.flash_attention_with_lse(
        q, k, v, q_segment_ids=torch.from_numpy(q_seg), kv_segment_ids=torch.from_numpy(seg))
    _close(got, want)
    _close(got_lse, want_lse)
    np.testing.assert_allclose(_np(got[:, :, :8]), _np(v.mean(2, keepdim=True)).repeat(8, 2),
                               atol=1e-6)
    assert (got_lse[:, :, :8].numpy() == MASK).all()
    assert (got_lse[:, :, 8:].numpy() > -1e30).all()


def test_packed_segments_causal_match_jax():
    """Causal attention over packed sequences (segment ids non-decreasing)."""
    (jq, jk, jv), (q, k, v) = _inputs(4, lq=1024)
    seg = np.repeat(np.arange(4, dtype=np.int32), [100, 400, 24, 500])[None]
    want, want_lse = jfa.flash_attention_with_lse(
        jq, jk, jv, q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
        causal=True)
    got, got_lse = tfa.flash_attention_with_lse(
        q, k, v, q_segment_ids=torch.from_numpy(seg), kv_segment_ids=torch.from_numpy(seg),
        causal=True)
    _close(got, want)
    _close(got_lse, want_lse)


@pytest.mark.parametrize("length", [200, 785, 1024])
@pytest.mark.parametrize("with_mask", [False, True])
def test_padded_matches_jax_on_real_rows(length, with_mask):
    """``flash_attention_padded``: the JAX wrapper pads to a multiple of 128
    with a pad segment; the port masks by bounds. They agree on every query
    the padding mask leaves unmasked (on all rows without a mask)."""
    (jq, jk, jv), (q, k, v) = _inputs(5, b=2, lq=length)
    mask = None
    if with_mask:
        mask = np.zeros((2, length), bool)
        mask[0, length - 37:] = True
        mask[1, ::5] = True
    want = jfa.flash_attention_padded(jq, jk, jv,
                                      padding_mask=None if mask is None else jnp.asarray(mask))
    got = tfa.flash_attention_padded(q, k, v,
                                     padding_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == q.shape
    real = np.ones((2, length), bool) if mask is None else ~mask
    for b in range(2):
        _close(got[b][:, real[b]], np.asarray(want)[b][:, real[b]])


def _bf16_segments(length, causal):
    """Segment ids ``[1, L]``: packed sequences when causal (every row sees
    itself), else random ids with rows 0..7 in a segment no key has."""
    if causal:
        return np.repeat(np.arange(3, dtype=np.int32), [length // 4, length // 2,
                                                        length - 3 * (length // 4)])[None]
    q_seg = np.random.default_rng(11).integers(0, 3, size=(1, length)).astype(np.int32)
    kv_seg = q_seg.copy()
    q_seg[:, :8] = 7
    return q_seg, kv_seg


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [200, 785, 1024])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("segments", [False, True])
def test_bf16_matches_jax(length, causal, d, segments):
    """K2's plain version in bf16 against JAX over the grid the card holds
    the kernel to: D 32/64/128, the ragged 785 (JAX's dense reference), and
    segments with rows that match no key (non-causal) or packed sequences
    (causal)."""
    (jq, jk, jv), (q, k, v) = _inputs(6, lq=length, d=d, dtype="bfloat16")
    jseg, tseg = {}, {}
    if segments:
        seg = _bf16_segments(length, causal)
        q_seg, kv_seg = (seg, seg) if causal else seg
        jseg = dict(q_segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(kv_seg))
        tseg = dict(q_segment_ids=torch.from_numpy(q_seg),
                    kv_segment_ids=torch.from_numpy(kv_seg))
    want, want_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal, **jseg)
    got, got_lse = tfa.flash_attention_with_lse(q, k, v, causal=causal, **tseg)
    assert got.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    _close(got, want, "bfloat16")
    _close(got_lse, want_lse, "bfloat16")


@pytest.mark.parametrize("d", [64, 128])
def test_plain_version_matches_jax_reference(d):
    (jq, jk, jv), (q, k, v) = _inputs(7, b=2, lq=96, lkv=160, d=d)
    seg_q = np.random.default_rng(8).integers(0, 2, size=(2, 96)).astype(np.int32)
    seg_k = np.random.default_rng(9).integers(0, 2, size=(2, 160)).astype(np.int32)
    want, want_lse = jfa.mha_reference(jq, jk, jv, q_segment_ids=jnp.asarray(seg_q),
                                       kv_segment_ids=jnp.asarray(seg_k), causal=True)
    got, got_lse = tfa.mha_reference(q, k, v, q_segment_ids=torch.from_numpy(seg_q),
                                     kv_segment_ids=torch.from_numpy(seg_k), causal=True)
    _close(got, want)
    _close(got_lse, want_lse)


def test_contracts():
    _, (q, k, v) = _inputs(10, lq=64)
    seg = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="both or neither"):
        tfa.flash_attention(q, k, v, q_segment_ids=seg)
    with pytest.raises(ValueError, match="self-attention"):
        tfa.flash_attention_padded(q, k[:, :, :32], v[:, :, :32])
    # on the CPU the entry points take the plain versions, forward and
    # backward; the kernel's wrapper refuses CPU tensors outright
    q.requires_grad_(True)
    tfa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    before = flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_fwd_cuda(q.detach(), k, v)
    assert flash_fwd_cuda.launches == before
