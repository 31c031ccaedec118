"""The port's LongNet dilated attention (``parallel.dilated``) against the
JAX package's on the CPU: ``dense_to_sparse`` / ``sparse_to_dense`` and the
pad-key counts bit for bit, ``dilated_attention`` forward and gradients
(q, k, v) with and without the pad correction, causal and not, with ratios
that pad the heads, on the flash route and the plain one, and each
branch's route (``lse_grad`` only where a pad correction consumes the lse
and the branch is not causal) as JAX takes it.

Inputs are numpy-seeded at small sizes (L ≤ 128); JAX sends these sparse
lengths to its dense reference, so parity is at tolerance: forwards within
1e-5 of the largest |value|, gradients within 1e-5 of the largest |grad|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.parallel import dilated as jdil
from moc_tpu_torch.parallel import dilated

H, DH = 4, 16
CASES = {  # name: (L, segment lengths, ratios)
    "aligned": (128, (32, 64, 128), (1, 2, 4)),
    "pad_correction": (120, (32, 64, 128), (1, 2, 3)),
    "head_pad": (96, (48, 96), (3, 6)),
}


def _qkv(seed, length, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, length, H, DH)).astype(dtype) for _ in range(3)]


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ratio", [1, 2, 3, 4])
def test_sparse_layout_bit_equal(ratio):
    x = _qkv(0, 30)[0]
    want = np.asarray(jdil.dense_to_sparse(jnp.asarray(x), ratio))
    got = dilated.dense_to_sparse(torch.from_numpy(x), ratio).numpy()
    assert np.array_equal(got, want)
    lse = np.random.default_rng(1).normal(size=(2, H, got.shape[1])).astype(np.float32)
    jd, jl = jdil.sparse_to_dense(jnp.asarray(want), jnp.asarray(lse), ratio)
    td, tl = dilated.sparse_to_dense(torch.from_numpy(got), torch.from_numpy(lse), ratio)
    assert np.array_equal(td.numpy(), np.asarray(jd)) and np.array_equal(tl.numpy(),
                                                                         np.asarray(jl))


def test_pad_key_counts_equal():
    for sl in (7, 32, 60):
        for dr in (1, 2, 3, 5):
            for pad in (0, 3, 6):
                for n_seg in (1, 3):
                    for h in (3, 4, 12):
                        args = (sl, dr, min(pad, sl - 1), n_seg, h)
                        assert np.array_equal(dilated._pad_key_counts(*args),
                                              jdil._pad_key_counts(*args)), args


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dilated_attention_matches_jax(case, causal, use_flash):
    """The port on either route against JAX's plain route, and, in the
    aligned non-causal case, against JAX's flash route (its Pallas backward
    in interpret mode takes ~15 s a case on the CPU, so only there)."""
    length, segs, ratios = CASES[case]
    q, k, v = _qkv(2, length)
    r = np.random.default_rng(3).normal(size=(2, length, H * DH)).astype(np.float32)
    jax_flash = use_flash and case == "aligned" and not causal
    jcfg = jdil.DilatedConfig(segment_lengths=segs, dilated_ratios=ratios, use_flash=jax_flash)
    tcfg = dilated.DilatedConfig(segment_lengths=segs, dilated_ratios=ratios,
                                 use_flash=use_flash)

    def jloss(q, k, v):
        out = jdil.dilated_attention(q, k, v, jcfg, causal=causal)
        return jnp.sum(out * r), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    tout = dilated.dilated_attention(tq, tk, tv, tcfg, causal=causal)
    torch.sum(tout * torch.from_numpy(r)).backward()
    assert tout.shape == (2, length, H * DH)
    assert _rel_err(tout.detach().numpy(), jout) <= 1e-5
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads)
    for t, g in zip((tq, tk, tv), jgrads):
        assert float(np.abs(t.grad.numpy() - np.asarray(g)).max()) <= 1e-5 * scale


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_branch_routes_as_jax(case, causal, monkeypatch):
    """``lse_grad`` is set exactly where JAX sets it: a pad correction on a
    non-causal branch; every other branch backs out through K3/K4."""
    length, segs, ratios = CASES[case]
    seen = []
    real = dilated.flash_attention_with_lse

    def spy(*args, lse_grad=True, **kw):
        seen.append(lse_grad)
        return real(*args, lse_grad=lse_grad, **kw)

    monkeypatch.setattr(dilated, "flash_attention_with_lse", spy)
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in _qkv(4, length))
    dilated.dilated_attention(q, k, v, dilated.DilatedConfig(segs, ratios), causal=causal)
    want = []
    for sl, dr in zip(segs, ratios):
        sl_local = min(sl, length)
        pad = (-length) % sl_local
        counts = jdil._pad_key_counts(sl_local, dr, pad, (length + pad) // sl_local, H)
        want.append(bool(counts.any()) and not causal)
    assert seen == want
    assert any(want) == (case == "pad_correction" and not causal)


def test_bf16_matches_f32_reference():
    """bf16 q, k, v: within 2e-2 of the f32 JAX result, mean |diff| ≤ 1%."""
    length, segs, ratios = CASES["aligned"]
    q, k, v = _qkv(5, length)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    want = np.asarray(jdil.dilated_attention(
        *(jnp.asarray(t.float().numpy()) for t in bf),
        jdil.DilatedConfig(segment_lengths=segs, dilated_ratios=ratios, use_flash=False)))
    got = dilated.dilated_attention(*bf, dilated.DilatedConfig(segs, ratios)).float().numpy()
    assert _rel_err(got, want) <= 2e-2
    assert np.abs(got - want).mean() / np.abs(want).mean() <= 1e-2


def test_cross_shard_segments_are_refused():
    q = torch.zeros(1, 32, H, DH)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        dilated.dilated_attention(q, q, q, dilated.DilatedConfig((16, 64), (1, 2)),
                                  axis_name="seq")
