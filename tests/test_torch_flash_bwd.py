"""The flash-attention backward: kernels K3/K4's plain PyTorch version
``flash_bwd_reference`` and the port's three autograd Functions against the
JAX package on the CPU. JAX runs its Pallas kernels (``_bwd``, and the
custom VJPs through ``jax.grad``) in interpret mode, as its own tests do:
causal and not, segment ids (with rows that match no key), packed causal
segments, ``flash_attention_padded`` with a padding mask, f32 and bf16.

Tolerance: the JAX package's own flash backward tolerance, rtol = atol =
5e-4, in f32; in bf16, 2e-2 of each gradient's largest |grad|, and for dq
a mean error of at most 1% of its mean |grad|. The kernels themselves
run only on a GPU (``tests/test_torch_cuda.py`` and ``chip_smoke.py``); the
f32 tier's three TF32 passes are emulated here, and held to 1e-5 of the
largest |grad| of the plain version as on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.ops import flash_attention as jfa
from moc_tpu_torch.ops import flash_attention as tfa
from moc_tpu_torch.ops.flash_kernel import flash_bwd_dkv_cuda, flash_bwd_dq_cuda

TOL = 5e-4


def _arrays(seed, b=2, h=2, lq=128, lkv=None, d=64):
    rng = np.random.default_rng(seed)
    lkv = lkv or lq
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, h, lq, d), (b, h, lkv, d), (b, h, lkv, d), (b, h, lq, d))]


def _segments(seed, b, lq, lkv, unmatched=0):
    rng = np.random.default_rng(seed)
    q_seg = rng.integers(0, 3, size=(b, lq)).astype(np.int32)
    kv_seg = rng.integers(0, 3, size=(b, lkv)).astype(np.int32)
    q_seg[:, :unmatched] = 7  # no key is in segment 7
    return q_seg, kv_seg


def _packed(b, length):
    cuts = [length // 5, length // 2, length - 10]
    return np.repeat(np.arange(4, dtype=np.int32),
                     np.diff([0, *cuts, length]))[None].repeat(b, 0)


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy() if isinstance(g, torch.Tensor) else g,
                                   np.asarray(w, np.float32), rtol=tol, atol=tol)


def _jax_grads(fn, q, k, v, do, dlse=None):
    def loss(q, k, v):
        out = fn(q, k, v)
        if isinstance(out, tuple):
            out, lse = out
            extra = 0.0 if dlse is None else jnp.sum(lse * jnp.asarray(dlse))
            return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do)) + extra
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))


def _torch_grads(fn, q, k, v, do, dlse=None):
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    if isinstance(out, tuple):
        out, lse = out
        extra = 0.0 if dlse is None else (lse * torch.from_numpy(dlse)).sum()
        total = (out.float() * torch.from_numpy(do)).sum() + extra
    else:
        total = (out.float() * torch.from_numpy(do)).sum()
    return torch.autograd.grad(total, leaves)


def _seg_kw(q_seg, kv_seg, causal, as_torch):
    conv = torch.from_numpy if as_torch else jnp.asarray
    if q_seg is None:
        return {"causal": causal}
    return {"q_segment_ids": conv(q_seg), "kv_segment_ids": conv(kv_seg), "causal": causal}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,segments", [(False, False), (True, False), (False, True),
                                             (True, True)])
def test_plain_backward_matches_jax_kernels(d, causal, segments):
    """``flash_bwd_reference`` against JAX's Pallas backward ``_bwd`` on the
    same q, k, v, o, lse and dO (JAX's forward's o and lse)."""
    q, k, v, do = _arrays(d + 10 * causal + segments, lq=256, d=d)
    q_seg = kv_seg = None
    if segments:
        q_seg, kv_seg = (_packed(2, 256),) * 2 if causal else _segments(d, 2, 256, 256, 8)
    jx = [jnp.asarray(t) for t in (q, k, v, do)]
    js = None if q_seg is None else (jnp.asarray(q_seg), jnp.asarray(kv_seg))
    scale = d ** -0.5
    o, lse = jfa._fwd(*jx[:3], *(js or (None, None)), scale, causal, 256, 256)
    want = jfa._bwd(*jx[:3], *(js or (None, None)), o, lse, jx[3], scale, causal, 256, 256)
    ts = (None, None) if q_seg is None else (torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    got = tfa.flash_bwd_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do), *ts, causal, scale)
    _close(got, want)


# (D, mask, L): every head dim under each mask at L 256, and the pretraining
# head dim at L 1024 (four key tiles of the JAX kernel's 256)
BF16_CASES = ([(d, mask, 256) for d in (32, 64, 128)
               for mask in ("none", "causal", "segments", "packed")]
              + [(64, "none", 1024), (64, "causal", 1024)])


@pytest.mark.parametrize("d,mask,length", BF16_CASES)
def test_plain_backward_matches_jax_kernels_bf16(d, mask, length):
    """bf16: ``flash_bwd_reference``, which K3 and K4 are held to on the
    card, against JAX's Pallas ``_bwd`` on the same q, k, v, dO and JAX's o
    and lse. Each gradient is within 2e-2 of its own largest |grad| (dS and P
    are rounded to bf16 in another summation order), and dq's mean error is
    at most 1% of its mean |grad|, which a wrong mask or a dropped key tile
    would exceed. Segments: 8 rows that match no key; packed: causal packed
    sequences."""
    causal = mask in ("causal", "packed")
    seed = 3 if (d, mask, length) == (64, "none", 256) else d + length + len(mask)
    q, k, v, do = _arrays(seed, lq=length, d=d)
    q_seg = kv_seg = None
    if mask == "segments":
        q_seg, kv_seg = _segments(d, 2, length, length, unmatched=8)
    elif mask == "packed":
        q_seg = kv_seg = _packed(2, length)
    scale = d ** -0.5
    jx = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do)]
    js = (None, None) if q_seg is None else (jnp.asarray(q_seg), jnp.asarray(kv_seg))
    o, lse = jfa._fwd(*jx[:3], *js, scale, causal, 256, 256)
    want = jfa._bwd(*jx[:3], *js, o, lse, jx[3], scale, causal, 256, 256)
    tt = [torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16() for t in (*jx, o)]
    ts = (None, None) if q_seg is None else (torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    got = tfa.flash_bwd_reference(tt[0], tt[1], tt[2], tt[4], torch.from_numpy(np.array(lse)),
                                  tt[3], *ts, causal, scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        err = np.abs(g - w).max()
        assert err <= 2e-2 * np.abs(w).max(), (name, err)
        if name == "dq":
            rel = np.abs(g - w).mean() / np.abs(w).mean()
            assert rel <= 1e-2, rel


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half a unit of the 13 dropped
    bits to the magnitude, then drop them."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _dropped(x):
    """x with its low 13 bits cleared: what the tensor core takes of an f32
    operand that was not rounded to TF32."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, passes, raw_hi=False):
    """``a @ b`` as the f32 tier of K3 and K4 takes it on the tensor cores:
    hi.hi + hi.lo + lo.hi summed in f32 (three passes), or hi.hi alone (one
    pass). Each operand is split as hi = tf32(x), lo = tf32(x - hi), or,
    with ``raw_hi``, as the kernels split their tiles in shared memory: x
    itself is hi, whose low 13 bits the tensor core drops, and lo =
    tf32(x - hi)."""
    ah, bh = (_dropped(a), _dropped(b)) if raw_hi else (_tf32(a), _tf32(b))
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_backward(q, k, v, o, lse, do, q_seg, kv_seg, causal, scale, passes,
                   raw_hi=False):
    """``flash_bwd_reference`` in f32 with its five products (s, dp, dq, dk,
    dv) taken by ``_tf32_matmul``."""
    def mm(a, b):
        return _tf32_matmul(a, b, passes, raw_hi)

    s = mm(q, k.transpose(-1, -2)) * scale
    mask = tfa._mask(q, k, q_seg, kv_seg, causal)
    if mask is not None:
        s = torch.where(mask, s, tfa.DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    delta = (o * do).sum(-1)
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), mm(p.transpose(-1, -2), do)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("mask", ["causal", "segments", "packed"])
def test_three_tf32_passes_hold_the_f32_tolerance(d, mask):
    """The f32 tier of K3 and K4 in three TF32 passes, emulated on the CPU at
    B 2, H 2, L 130: within the JAX package's 5e-4 of its Pallas backward
    (interpret mode), and within 1e-5 of the largest |grad| of
    ``flash_bwd_reference``, the limit the kernels are held to on the card.
    One pass (hi.hi, about three decimal digits) misses that limit. Masks:
    causal; segments with 8 rows that match no key; causal packed
    sequences."""
    length, causal = 130, mask != "segments"
    q, k, v, do = _arrays(80 + d + len(mask), lq=length, d=d)
    q_seg = kv_seg = None
    if mask == "segments":
        q_seg, kv_seg = _segments(d, 2, length, length, unmatched=8)
    elif mask == "packed":
        q_seg = kv_seg = _packed(2, length)
    scale = d ** -0.5
    jx = [jnp.asarray(t) for t in (q, k, v, do)]
    js = (None, None) if q_seg is None else (jnp.asarray(q_seg), jnp.asarray(kv_seg))
    o, lse = jfa._fwd(*jx[:3], *js, scale, causal, length, length)
    want = jfa._bwd(*jx[:3], *js, o, lse, jx[3], scale, causal, length, length)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    ts = (None, None) if q_seg is None else (torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    plain = tfa.flash_bwd_reference(tq, tk, tv, to, tlse, tdo, *ts, causal, scale)
    largest = max(g.abs().max().item() for g in plain)
    errs = {}
    for passes in (3, 1):
        got = _tf32_backward(tq, tk, tv, to, tlse, tdo, *ts, causal, scale, passes)
        errs[passes] = max((g - w).abs().max().item() for g, w in zip(got, plain)) / largest
        if passes == 3:
            _close(got, want)
    assert errs[3] <= 1e-5, errs
    assert errs[1] > 1e-5, errs


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("mask", ["causal", "segments", "packed"])
def test_three_tf32_passes_with_x_as_its_own_hi_hold_the_f32_tolerance(d, mask):
    """The split the kernels take of a tile in shared memory: x itself is
    hi (the tensor core drops its low 13 bits) and only lo = tf32(x - hi) is
    written. Emulated as above, every operand so split: within the JAX
    package's 5e-4 of its Pallas backward and within 1e-5 of the largest
    |grad| of ``flash_bwd_reference``; had the tensor core rounded the
    dropped bits instead, hi + lo would miss x by up to 2^-11 of it."""
    length, causal = 130, mask != "segments"
    q, k, v, do = _arrays(90 + d + len(mask), lq=length, d=d)
    q_seg = kv_seg = None
    if mask == "segments":
        q_seg, kv_seg = _segments(d + 1, 2, length, length, unmatched=8)
    elif mask == "packed":
        q_seg = kv_seg = _packed(2, length)
    scale = d ** -0.5
    jx = [jnp.asarray(t) for t in (q, k, v, do)]
    js = (None, None) if q_seg is None else (jnp.asarray(q_seg), jnp.asarray(kv_seg))
    o, lse = jfa._fwd(*jx[:3], *js, scale, causal, length, length)
    want = jfa._bwd(*jx[:3], *js, o, lse, jx[3], scale, causal, length, length)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    ts = (None, None) if q_seg is None else (torch.from_numpy(q_seg), torch.from_numpy(kv_seg))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    plain = tfa.flash_bwd_reference(tq, tk, tv, to, tlse, tdo, *ts, causal, scale)
    largest = max(g.abs().max().item() for g in plain)
    got = _tf32_backward(tq, tk, tv, to, tlse, tdo, *ts, causal, scale, 3, raw_hi=True)
    _close(got, want)
    err = max((g - w).abs().max().item() for g, w in zip(got, plain)) / largest
    assert err <= 1e-5, err
    # x's dropped bits taken as rounded: hi + lo no longer x
    rounded = [(_tf32(t) + _tf32(t - _dropped(t))) for t in (tq, tk)]
    assert max((r - t).abs().max().item() for r, t in zip(rounded, (tq, tk))) > 2 ** -13


@pytest.mark.parametrize("length", [128, 256])
def test_rows_that_match_no_key_match_the_jax_kernels(length):
    """A row whose segment matches no key: lse is the mask value, so the
    kernels recompute P = 1 for every key (L times the dense vjp). The port
    matches JAX's Pallas backward, through ``jax.grad``, on every row."""
    q, k, v, do = _arrays(20, lq=length)
    q_seg, kv_seg = _segments(21, 2, length, length, unmatched=8)
    want = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, **_seg_kw(q_seg, kv_seg, False, False)), q, k, v, do)
    got = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, **_seg_kw(q_seg, kv_seg, False, True)), q, k, v, do)
    _close(got, want)
    # the dense vjp differs on those rows: 1/L against 1 for P
    dense = _torch_grads(lambda q, k, v: tfa.mha_reference(
        q, k, v, **_seg_kw(q_seg, kv_seg, False, True))[0], q, k, v, do)
    assert not np.allclose(got[2].numpy(), dense[2].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("length", [128, 256])
def test_flash_attention_grads_match_jax(causal, segments, length):
    q, k, v, do = _arrays(30 + length + causal, lq=length)
    q_seg = kv_seg = None
    if segments:
        q_seg, kv_seg = (_packed(2, length),) * 2 if causal else _segments(31, 2, length, length)
    want = _jax_grads(lambda q, k, v: jfa.flash_attention(
        q, k, v, **_seg_kw(q_seg, kv_seg, causal, False)), q, k, v, do)
    got = _torch_grads(lambda q, k, v: tfa.flash_attention(
        q, k, v, **_seg_kw(q_seg, kv_seg, causal, True)), q, k, v, do)
    _close(got, want)


@pytest.mark.parametrize("lse_grad", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_grads_match_jax(lse_grad, causal):
    """``flash_attention_with_lse``: with ``lse_grad=True`` the lse carries a
    gradient (JAX's dense vjp of ``mha_reference``, no kernel); with False
    it is stop-gradient and the backward is the kernels'."""
    q, k, v, do = _arrays(40 + causal, lq=128)
    q_seg, kv_seg = _segments(41, 2, 128, 128) if not causal else (None, None)
    dlse = np.random.default_rng(42).normal(size=(2, 2, 128)).astype(np.float32)
    want = _jax_grads(lambda q, k, v: jfa.flash_attention_with_lse(
        q, k, v, lse_grad=lse_grad, **_seg_kw(q_seg, kv_seg, causal, False)), q, k, v, do, dlse)
    got = _torch_grads(lambda q, k, v: tfa.flash_attention_with_lse(
        q, k, v, lse_grad=lse_grad, **_seg_kw(q_seg, kv_seg, causal, True)), q, k, v, do, dlse)
    _close(got, want)


def test_with_lse_stop_gradient():
    q, k, v, _ = _arrays(50, lq=64)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out, lse = tfa.flash_attention_with_lse(*leaves, lse_grad=False)
    assert out.requires_grad and not lse.requires_grad
    out, lse = tfa.flash_attention_with_lse(*leaves)
    assert out.requires_grad and lse.requires_grad


@pytest.mark.parametrize("length", [200, 256])
def test_padded_grads_match_jax_on_real_rows(length):
    """``flash_attention_padded`` with a padding mask: JAX pads to a lane
    multiple with a pad segment, the port masks by bounds. The gradients of
    the real queries and keys agree (the cotangent of masked queries is 0)."""
    q, k, v, do = _arrays(60 + length, lq=length)
    mask = np.zeros((2, length), bool)
    mask[0, length - 37:] = True
    mask[1, ::5] = True
    do = do * ~mask[:, None, :, None]
    want = _jax_grads(lambda q, k, v: jfa.flash_attention_padded(
        q, k, v, padding_mask=jnp.asarray(mask)), q, k, v, do)
    got = _torch_grads(lambda q, k, v: tfa.flash_attention_padded(
        q, k, v, padding_mask=torch.from_numpy(mask)), q, k, v, do)
    for b in range(2):
        real = ~mask[b]
        _close([g[b][:, real] for g in got], [np.asarray(w)[b][:, real] for w in want])


def test_cpu_backward_launches_no_kernel():
    """On the CPU the Functions take the plain backward; the kernels'
    wrappers refuse CPU tensors outright."""
    q, k, v, do = (torch.from_numpy(t) for t in _arrays(70, lq=64))
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (tfa.flash_attention(*leaves) * do).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    o, lse = tfa.mha_reference(q, k, v)
    delta = (o * do).sum(-1)
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q, k, v, do, lse, delta)
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == before
