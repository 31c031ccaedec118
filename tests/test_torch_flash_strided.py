"""q, k, v read by their strides, on the CPU, in bf16 and f32: the ``[B, H, L,
D]`` views of ``[B, L, H, D]`` projections through ``flash_attention`` and
``flash_attention_with_lse`` against the JAX package on the same numbers,
forward and (with gradients) backward, the tensor-map geometry K2 encodes
in both types (``tma_geometry``, and the strides K3 and K4 pass in bf16),
and the rule of which tensors ``_prepare`` copies for the forward and
``_kernel_bwd_inputs`` for K3 and K4. The kernels themselves run only on a
GPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.ops import flash_attention as jfa
from moc_tpu_torch.ops import flash_attention as tfa
from moc_tpu_torch.ops.flash_kernel import (KV_BOX_ROWS, Q_BOX_ROWS, _strides, kv_box_rows,
                                            tma_geometry, tma_readable)

# the tolerances of the JAX package's own flash tests: forward in bf16 and
# f32, and the f32 backward
TOL = 2e-2
TOL_F32, BWD_TOL_F32 = 2e-5, 5e-4
JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _views(seed, b, length, h, d, dtype=torch.bfloat16):
    """``[B, L, H, D]`` projections in ``dtype`` from numpy, as ``[B, H, L,
    D]`` views for the port and transposed copies for JAX."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, length, h, d)).astype(np.float32) for _ in range(3)]
    views = [torch.from_numpy(a).to(dtype).transpose(1, 2) for a in arrays]
    jax_in = [jnp.asarray(a.transpose(0, 2, 1, 3), dtype=JAX_DTYPES[dtype]) for a in arrays]
    return jax_in, views


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _views_match_jax(entry, length, causal, dtype, tol):
    (jq, jk, jv), (q, k, v) = _views(3, 2, length, 3, 64, dtype)
    assert not q.is_contiguous()
    if entry == "flash_attention":
        want = jfa.flash_attention(jq, jk, jv, causal=causal)
        got = tfa.flash_attention(q, k, v, causal=causal)
    else:
        want, want_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal)
        got, got_lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        assert got_lse.dtype == torch.float32
        _close(got_lse, want_lse, tol)
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [200, 256])
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_with_lse"])
def test_bf16_views_match_jax(entry, length, causal):
    _views_match_jax(entry, length, causal, torch.bfloat16, TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [200, 256])
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_with_lse"])
def test_f32_views_match_jax(entry, length, causal):
    """f32 views, which K2 reads by their strides on the card as it does
    bf16 ones, against the JAX package at its f32 tolerance."""
    _views_match_jax(entry, length, causal, torch.float32, TOL_F32)


def test_tma_geometry_of_contiguous_and_view_layouts():
    # contiguous [B, H, L, D]: rows of 128 bytes
    t = torch.zeros((2, 3, 785, 64), dtype=torch.bfloat16)
    g = tma_geometry(t, Q_BOX_ROWS)
    assert g == {"dims": (64, 785, 3, 2), "strides": (128, 785 * 128, 3 * 785 * 128),
                 "box": (64, 64, 1, 1), "swizzle": 128}
    # the [B, H, L, D] view of a [B, L, H, D] projection: no copy
    x = torch.zeros((2, 785, 12, 64), dtype=torch.bfloat16)
    g = tma_geometry(x.transpose(1, 2), KV_BOX_ROWS)
    assert g["dims"] == (64, 785, 12, 2)
    assert g["strides"] == (12 * 64 * 2, 64 * 2, 785 * 12 * 64 * 2)
    assert g["box"] == (64, 128, 1, 1)
    # heads of one third of a fused [B, L, 3·H·D] projection
    qkv = torch.zeros((2, 300, 3 * 4 * 32), dtype=torch.bfloat16)
    k = qkv.chunk(3, dim=-1)[1].reshape(2, 300, 4, 32).transpose(1, 2)
    g = tma_geometry(k, Q_BOX_ROWS)
    assert g["strides"] == (3 * 4 * 32 * 2, 32 * 2, 300 * 3 * 4 * 32 * 2)
    assert g["box"] == (32, 64, 1, 1) and g["swizzle"] == 64  # D = 32: 64-byte rows
    # D = 128: two boxes of 64 columns
    assert tma_geometry(torch.zeros((1, 1, 8, 128), dtype=torch.bfloat16),
                        Q_BOX_ROWS)["box"] == (64, 64, 1, 1)


def test_tma_geometry_steps_no_dimension_of_one():
    # a dimension of size 1 is never stepped: its stride is the extent inside it
    t = torch.zeros((1, 1, 100, 64), dtype=torch.bfloat16).as_strided(
        (1, 1, 100, 64), (7, 3, 64, 1))
    assert tma_geometry(t, Q_BOX_ROWS)["strides"] == (128, 100 * 128, 100 * 128)
    # no key (Lkv = 0): an empty tensor, whose strides are never stepped
    empty = torch.zeros((2, 3, 0, 64), dtype=torch.bfloat16)
    assert tma_geometry(empty, KV_BOX_ROWS)["strides"] == (128, 128, 3 * 128)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tma_geometry_of_f32_tensors(d):
    """f32: boxes of 32 columns (128 bytes), so D / 32 boxes a row, all with
    the 128-byte swizzle (D = 32 too); K and V tiles of 64 keys (32 at D =
    128); the byte strides of a view as of a bf16 one, at 4 bytes an element."""
    t = torch.zeros((2, 3, 785, d))
    g = tma_geometry(t, Q_BOX_ROWS)
    assert g == {"dims": (d, 785, 3, 2), "strides": (4 * d, 785 * 4 * d, 3 * 785 * 4 * d),
                 "box": (32, Q_BOX_ROWS, 1, 1), "swizzle": 128}
    rows = kv_box_rows(torch.float32, d)
    assert rows == (32 if d == 128 else 64) and kv_box_rows(torch.bfloat16, d) == KV_BOX_ROWS
    x = torch.zeros((2, 785, 12, d))
    g = tma_geometry(x.transpose(1, 2), rows)
    assert g["strides"] == (12 * d * 4, d * 4, 785 * 12 * d * 4)
    assert g["box"] == (32, rows, 1, 1) and g["swizzle"] == 128
    assert d // g["box"][0] == {32: 1, 64: 2, 128: 4}[d]
    assert tma_readable(x.transpose(1, 2))


def _odd_rows(dtype):
    """64 columns of rows 136 (bf16) or 264 (f32) bytes apart: not a
    multiple of 16 bytes, so TMA cannot read them by their strides."""
    return torch.zeros((1, 2, 10, 68 if dtype == torch.bfloat16 else 66), dtype=dtype)[..., :64]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_refusals_name_the_dtype(dtype):
    name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    odd_row = _odd_rows(dtype)
    with pytest.raises(ValueError, match=f"K2 reads {name} tensors by strides that are "
                                         "multiples of 16 bytes"):
        tma_geometry(odd_row, Q_BOX_ROWS)
    with pytest.raises(ValueError, match=f"K2 reads {name} tensors whose last dim is "
                                         "contiguous"):
        tma_geometry(torch.zeros((1, 2, 10, 128), dtype=dtype)[..., ::2], Q_BOX_ROWS)
    assert not tma_readable(odd_row)


@pytest.mark.parametrize("case", ["row_stride", "head_stride", "last_dim"])
def test_tma_geometry_refuses_unreadable_strides(case):
    if case == "row_stride":  # rows 136 bytes apart: not a multiple of 16
        t = torch.zeros((1, 2, 10, 68), dtype=torch.bfloat16)[..., :64]
    elif case == "head_stride":  # heads 72 bytes apart
        t = torch.zeros((1, 10, 2 * 36), dtype=torch.bfloat16).as_strided(
            (1, 2, 10, 32), (720, 36, 72, 1))
    else:  # every second element of a row
        t = torch.zeros((1, 2, 10, 128), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="K2 reads bf16 tensors"):
        tma_geometry(t, Q_BOX_ROWS)
    assert not tma_readable(t)


def test_prepare_keeps_bf16_views_without_grad_and_copies_otherwise():
    x = torch.randn((2, 40, 3, 64)).to(torch.bfloat16)
    view = x.transpose(1, 2)
    # bf16 without a gradient: handed on as it lies (K2 reads its strides)
    (q, k, v), *_ = tfa._prepare(view, view, view, None, None, None)
    assert all(t.data_ptr() == view.data_ptr() and t.stride() == view.stride()
               for t in (q, k, v))
    # with a gradient too: autograd saves the views, and K3 and K4 read them
    # (and dO) by their strides as K2 does
    leaf = view.detach().requires_grad_(True)
    (q, k, _), _, _, _, needs_grad = tfa._prepare(leaf, view, view, None, None, None)
    assert needs_grad and q.stride() == view.stride() and q.data_ptr() == view.data_ptr()
    assert k.data_ptr() == view.data_ptr() and not q.is_contiguous()
    # the same view under no_grad is not copied either
    with torch.no_grad():
        (q, _, _), *_ = tfa._prepare(leaf, view, view, None, None, None)
    assert q.data_ptr() == view.data_ptr()
    # f32: handed on as it lies too (K2 reads its strides), with a gradient
    # too, and K3 and K4 read it so in the backward (test_copy_policy_by_dtype)
    f32 = x.float().transpose(1, 2)
    (q, _, _), *_ = tfa._prepare(f32, f32, f32, None, None, None)
    assert q.data_ptr() == f32.data_ptr() and q.stride() == f32.stride()
    (q, _, _), _, _, _, needs_grad = tfa._prepare(f32.detach().requires_grad_(True), f32, f32,
                                                  None, None, None)
    assert needs_grad and q.stride() == f32.stride() and not q.is_contiguous()
    # bf16 whose strides the kernels cannot read: copied, with or without a gradient
    odd = torch.zeros((1, 2, 10, 68), dtype=torch.bfloat16)[..., :64]
    (q, _, _), *_ = tfa._prepare(odd, odd, odd, None, None, None)
    assert q.is_contiguous()
    (q, _, _), *_ = tfa._prepare(odd.requires_grad_(True), odd, odd, None, None, None)
    assert q.is_contiguous()


def test_k3_k4_strides_in_the_kernels_order_and_refusals_name_the_kernel():
    """The byte strides K3 and K4 hand their tensor maps: L, H and B of each
    tensor in turn (q, k, v, do, then the gradients), as ``tma_geometry``
    gives them; a stride TMA cannot take raises, naming the kernel."""
    x = torch.zeros((2, 40, 3, 64), dtype=torch.bfloat16)
    view, dense = x.transpose(1, 2), torch.zeros((2, 3, 40, 64), dtype=torch.bfloat16)
    got = list(_strides("K3", (view, dense, dense, view, dense)))
    want = [s for t in (view, dense, dense, view, dense)
            for s in tma_geometry(t, Q_BOX_ROWS)["strides"]]
    assert len(got) == 15 and got == want
    assert got[:3] == [3 * 64 * 2, 64 * 2, 40 * 3 * 64 * 2]
    assert len(_strides("K4", (view,) * 6)) == 18
    odd = torch.zeros((1, 2, 10, 68), dtype=torch.bfloat16)[..., :64]
    for name in ("K3", "K4"):
        with pytest.raises(ValueError, match=f"{name} reads bf16 tensors by strides"):
            _strides(name, (dense, odd))


def _grad_views(seed, b, length, h, d, dtype=torch.bfloat16):
    """``[B, L, H, D]`` leaves in ``dtype`` that need a gradient, their
    ``[B, H, L, D]`` views for the port, and the same numbers and a dO for
    JAX, from numpy."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, length, h, d)).astype(np.float32) for _ in range(4)]
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays[:3]]
    jax_in = [jnp.asarray(a.transpose(0, 2, 1, 3), dtype=JAX_DTYPES[dtype]) for a in arrays[:3]]
    do = arrays[3].transpose(0, 2, 1, 3)
    return leaves, jax_in, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_with_lse"])
def test_bf16_views_with_grad_match_jax(entry, causal):
    """bf16 views of ``[B, L, H, D]`` projections that need a gradient, on
    the CPU: ``flash_attention`` and ``flash_attention_with_lse(lse_grad=
    False)`` (the Functions whose backward is K3 + K4 on the card, the plain
    backward here) keep the views, and their gradients match the JAX
    package's flash backward (its Pallas kernels in interpret mode) on the
    same numbers: each within 2e-2 of its largest |grad|, with a mean error
    of at most 1% of its mean |grad|."""
    b, length, h, d = 2, 128, 2, 64
    leaves, (jq, jk, jv), do = _grad_views(11 + causal, b, length, h, d)
    views = [t.transpose(1, 2) for t in leaves]
    if entry == "flash_attention":
        def jfn(q, k, v):
            return jfa.flash_attention(q, k, v, causal=causal)
        out = tfa.flash_attention(*views, causal=causal)
    else:
        def jfn(q, k, v):
            return jfa.flash_attention_with_lse(q, k, v, causal=causal, lse_grad=False)[0]
        out, lse = tfa.flash_attention_with_lse(*views, causal=causal, lse_grad=False)
        assert not lse.requires_grad
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v).astype(jnp.float32)
                                            * jnp.asarray(do)), argnums=(0, 1, 2))(jq, jk, jv)
    saved = out.grad_fn.saved_tensors
    assert all(t.data_ptr() == w.data_ptr() and t.stride() == w.stride()
               for t, w in zip(saved[:3], views))
    grads = torch.autograd.grad((out.float() * torch.from_numpy(do)).sum(), leaves)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and g.shape == (b, length, h, d)
        g = g.float().transpose(1, 2).numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
        assert np.abs(g - w).mean() <= 1e-2 * np.abs(w).mean()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_copy_policy_by_dtype(dtype):
    """Which copies the forward and the backward make, the same in either
    type. The forward (``_prepare``) hands readable views to K2 as they lie
    and copies unreadable ones; K3 and K4 (``_kernel_bwd_inputs``) take q,
    k, v and dO as they lie and copy an unreadable dO, and contiguous
    tensors are not copied either."""
    x = torch.randn((2, 40, 3, 64)).to(dtype)
    view = x.transpose(1, 2)
    (q, k, v), *_ = tfa._prepare(view, view, view, None, None, None)
    assert all(t.data_ptr() == view.data_ptr() and t.stride() == view.stride()
               for t in (q, k, v))
    odd = _odd_rows(dtype)
    (q, _, _), *_ = tfa._prepare(odd, odd, odd, None, None, None)
    assert q.is_contiguous()
    do_view = torch.randn((2, 40, 3, 64)).to(dtype).transpose(1, 2)
    got = tfa._kernel_bwd_inputs(view, view, view, do_view)
    assert all(t is view for t in got[:3]) and got[3] is do_view
    # rows 136 (bf16) or 264 (f32) bytes apart, as _odd_rows
    odd_do = torch.zeros((2, 3, 40, 68 if dtype == torch.bfloat16 else 66), dtype=dtype)[..., :64]
    assert tfa._kernel_bwd_inputs(view, view, view, odd_do)[3].is_contiguous()
    dense = view.contiguous()
    assert all(t is dense for t in tfa._kernel_bwd_inputs(dense, dense, dense, dense))
    assert all(torch.equal(t, w) for t, w in zip(got, (view, view, view, do_view)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_with_lse"])
def test_f32_views_with_grad_match_jax(entry, causal):
    """f32 views of ``[B, L, H, D]`` projections that need a gradient, on
    the CPU: ``flash_attention`` and ``flash_attention_with_lse(lse_grad=
    False)`` keep the views (K2, K3 and K4 read them by strides on the
    card), and their gradients match the JAX package's flash backward (its
    Pallas kernels in interpret mode) on the same numbers within its f32
    backward tolerance."""
    b, length, h, d = 2, 128, 2, 64
    leaves, (jq, jk, jv), do = _grad_views(13 + causal, b, length, h, d, torch.float32)
    views = [t.transpose(1, 2) for t in leaves]
    if entry == "flash_attention":
        def jfn(q, k, v):
            return jfa.flash_attention(q, k, v, causal=causal)
        out = tfa.flash_attention(*views, causal=causal)
    else:
        def jfn(q, k, v):
            return jfa.flash_attention_with_lse(q, k, v, causal=causal, lse_grad=False)[0]
        out, lse = tfa.flash_attention_with_lse(*views, causal=causal, lse_grad=False)
        assert not lse.requires_grad
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * jnp.asarray(do)),
                    argnums=(0, 1, 2))(jq, jk, jv)
    saved = out.grad_fn.saved_tensors
    assert all(t.data_ptr() == w.data_ptr() and t.stride() == w.stride()
               for t, w in zip(saved[:3], views))
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), leaves)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float32 and g.shape == (b, length, h, d)
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w), rtol=BWD_TOL_F32,
                                   atol=BWD_TOL_F32)
