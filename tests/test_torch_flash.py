"""Kernel K2's plain PyTorch version and the port's flash-attention entry
points against the JAX package's, on the CPU: causal and non-causal,
segment ids with rows that match no key, ``padding_mask``, lengths 200, 785
and 1024, f32 and bf16 (bf16 also over D 32, 64 and 128). JAX runs its
Pallas kernel in interpret mode for the lane-aligned lengths and its dense
reference for the others, as its own tests do. The kernel itself runs only
on a GPU (``tests/test_torch_cuda.py`` and ``chip_smoke.py``); here its
wrapper must refuse CPU tensors. Its f32 tier's arithmetic, three TF32
passes on the tensor cores, is emulated here in numpy and held to the JAX
package's f32 tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.ops import flash_attention as jfa
from moc_tpu_torch.ops import flash_attention as tfa
from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda
from tests.test_torch_flash_bwd import _tf32

# the tolerances of the JAX package's own flash tests
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MASK = np.float32(jfa.DEFAULT_MASK_VALUE)
# K2's f32 tier against its plain version, beside TOL: max |O - plain| at most
# 1e-5 of the largest |O|. In the emulation below three TF32 passes keep
# 3.2e-7 to 1.1e-6 of it (and 1.4e-6 of JAX's O and lse), where one pass is
# 3.0e-4 to 1.1e-3 off JAX's and misses TOL itself.
F32_FWD_MAX_REL = 1e-5
LOG2E = np.float32(1.4426950408889634)


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


def _rna(x):
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it."""
    return _tf32(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


def _rz(x):
    """f64 ``x`` rounded to f32 toward zero, as the tensor core rounds its sums."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x), np.nextafter(f, np.float32(0)), f)


def _tf32_product(a, b, passes, out):
    """``out + a @ b`` for ``a [H, R, K]``, ``b [H, K, N]`` as K2's f32 tier
    takes it on the tensor cores: operands split as hi = tf32(x), lo =
    tf32(x - hi); each 8-wide k-step an m16n8k8 mma per pass (lo.hi, hi.lo,
    hi.hi; hi.hi alone for one pass), its 8 products exact and its sum
    rounded toward zero; two k-steps a fresh accumulator, which an f32 add
    takes into ``out``."""
    ah, bh = _rna(a), _rna(b)
    steps = ((ah, bh),) if passes == 1 else ((_rna(a - ah), bh), (ah, _rna(b - bh)), (ah, bh))
    for k0 in range(0, a.shape[-1], 16):
        t = np.zeros(out.shape, np.float64)
        for ks in (slice(k0, k0 + 8), slice(k0 + 8, k0 + 16)):
            for x, y in steps:
                t = _rz(t + x[..., ks].astype(np.float64) @ y[..., ks, :].astype(np.float64))
        out = out + t.astype(np.float32)
    return out


def _tf32_forward(q, k, v, q_seg, kv_seg, causal, scale, passes):
    """K2's f32 tier on ``[H, L, D]`` f32 arrays of one batch row, as the
    kernel runs it: 64-row query tiles over 64-key tiles (causal tiles
    above the diagonal skipped), keys in passes of 64 at D = 64 (32 at
    D = 32, 16 at D = 128), the online softmax per pass with P = exp2((S -
    m) log2e), S and P.V by ``_tf32_product``; keys at or past Lkv at -inf,
    masked keys at the mask value. Returns ``(o [H, Lq, D], lse [H, Lq])``."""
    h, lq, d = q.shape
    lkv = k.shape[1]
    chunk = {32: 32, 64: 64, 128: 16}[d]
    pad = -lkv % 64
    k, v = (np.pad(x, ((0, 0), (0, pad), (0, 0))) for x in (k, v))
    o = np.zeros((h, lq, d), np.float32)
    lse = np.zeros((h, lq), np.float32)
    for q0 in range(0, lq, 64):
        rows = np.arange(q0, min(q0 + 64, lq))
        acc = np.zeros((h, len(rows), d), np.float32)
        m = np.full((h, len(rows)), -np.inf, np.float32)
        l = np.zeros((h, len(rows)), np.float32)
        for kc in range(0, min(lkv, q0 + 64) if causal else lkv, chunk):
            keys = np.arange(kc, kc + chunk)
            s = _tf32_product(q[:, rows], k[:, keys].transpose(0, 2, 1), passes,
                              np.zeros((h, len(rows), chunk), np.float32)) * np.float32(scale)
            hidden = np.zeros((len(rows), chunk), bool)
            if causal:
                hidden |= keys[None] > rows[:, None]
            if q_seg is not None:
                hidden |= kv_seg[np.minimum(keys, lkv - 1)][None] != q_seg[rows][:, None]
            s = np.where(hidden, MASK, s)
            s = np.where(keys >= lkv, -np.inf, s).astype(np.float32)
            mn = np.maximum(m, s.max(-1))
            with np.errstate(over="ignore"):  # MASK * log2e overflows to -inf: p = 0
                alpha = np.exp2((m - mn) * LOG2E)
                p = np.exp2((s - mn[..., None]) * LOG2E)
            l = alpha * l + p.sum(-1, dtype=np.float32)
            m = mn
            acc = _tf32_product(p, v[:, keys], passes, acc * alpha[..., None])
        o[:, rows] = acc * (np.float32(1) / l)[..., None]
        lse[:, rows] = m + np.log(l)
    return o, lse


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("mask", ["none", "causal", "segments"])
def test_three_tf32_passes_hold_the_f32_tolerance(d, mask):
    """K2's f32 tier in three TF32 passes, emulated on the CPU at B 2, H 2,
    L 256: within the JAX package's 2e-5 of its Pallas forward (interpret
    mode) on O and lse, and within ``F32_FWD_MAX_REL`` of the largest |O| of
    the plain version, the limit the kernel is held to on the card. One pass
    (hi.hi, about three decimal digits) misses 2e-5. Masks: none; causal;
    segments with 8 rows of each batch row that match no key (mean(V),
    lse = MASK)."""
    length, causal = 256, mask == "causal"
    (jq, jk, jv), (q, k, v) = _inputs(40 + d + len(mask), b=2, lq=length, d=d)
    jseg, tseg, segs = {}, {}, [(None, None)] * 2
    if mask == "segments":
        rng = np.random.default_rng(d)
        kv_seg = rng.integers(0, 3, size=(2, length)).astype(np.int32)
        q_seg = kv_seg.copy()
        q_seg[:, :8] = 7  # no key is in segment 7
        jseg = dict(q_segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(kv_seg))
        tseg = dict(q_segment_ids=torch.from_numpy(q_seg),
                    kv_segment_ids=torch.from_numpy(kv_seg))
        segs = list(zip(q_seg, kv_seg))
    want, want_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal, **jseg)
    plain, _ = tfa.mha_reference(q, k, v, causal=causal, **tseg)
    largest = plain.abs().max().item()
    errs = {}
    for passes in (3, 1):
        got = [_tf32_forward(*(x[b].numpy() for x in (q, k, v)), *segs[b], causal,
                             d ** -0.5, passes) for b in range(2)]
        o, lse = (np.stack(x) for x in zip(*got))
        errs[passes] = (np.abs(o - plain.numpy()).max() / largest,
                        max(np.abs(o - _np(want)).max(), np.abs(lse - _np(want_lse)).max()))
        if passes == 3:
            _close(o, want)
            _close(lse, want_lse)
            if mask == "segments":
                assert (lse[:, :, :8] == MASK).all()
    assert errs[3][0] <= F32_FWD_MAX_REL, errs
    assert errs[1][1] > TOL["float32"], errs
