"""bf16 q, k, v read by their strides, on the CPU: the ``[B, H, L, D]`` views
of ``[B, L, H, D]`` projections through ``flash_attention`` and
``flash_attention_with_lse`` against the JAX package on the same numbers,
the tensor-map geometry K2's bf16 kernel encodes (``tma_geometry``), and
``_prepare``'s rule of which tensors it copies. The kernel itself runs only
on a GPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.ops import flash_attention as jfa
from moc_tpu_torch.ops import flash_attention as tfa
from moc_tpu_torch.ops.flash_kernel import (KV_BOX_ROWS, Q_BOX_ROWS, tma_geometry,
                                            tma_readable)

# the tolerance of the JAX package's own bf16 flash tests
TOL = 2e-2


def _views(seed, b, length, h, d):
    """bf16 ``[B, L, H, D]`` projections from numpy, as ``[B, H, L, D]``
    views for the port and transposed copies for JAX."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, length, h, d)).astype(np.float32) for _ in range(3)]
    views = [torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2) for a in arrays]
    jax_in = [jnp.asarray(a.transpose(0, 2, 1, 3), dtype=jnp.bfloat16) for a in arrays]
    return jax_in, views


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", [200, 256])
@pytest.mark.parametrize("entry", ["flash_attention", "flash_attention_with_lse"])
def test_bf16_views_match_jax(entry, length, causal):
    (jq, jk, jv), (q, k, v) = _views(3, 2, length, 3, 64)
    assert not q.is_contiguous()
    if entry == "flash_attention":
        want = jfa.flash_attention(jq, jk, jv, causal=causal)
        got = tfa.flash_attention(q, k, v, causal=causal)
    else:
        want, want_lse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal)
        got, got_lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        assert got_lse.dtype == torch.float32
        _close(got_lse, want_lse)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, want)


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
    # a gradient: copied (K3/K4 take contiguous tensors, autograd saves these)
    leaf = view.detach().requires_grad_(True)
    (q, _, _), _, _, _, needs_grad = tfa._prepare(leaf, view, view, None, None, None)
    assert needs_grad and q.is_contiguous() and q.data_ptr() != view.data_ptr()
    # the same view under no_grad is not copied
    with torch.no_grad():
        (q, _, _), *_ = tfa._prepare(leaf, view, view, None, None, None)
    assert q.data_ptr() == view.data_ptr()
    # f32: copied (f32 K2 takes contiguous tensors)
    f32 = x.float().transpose(1, 2)
    (q, _, _), *_ = tfa._prepare(f32, f32, f32, None, None, None)
    assert q.is_contiguous()
    # bf16 whose strides K2 cannot read: copied
    odd = torch.zeros((1, 2, 10, 68), dtype=torch.bfloat16)[..., :64]
    (q, _, _), *_ = tfa._prepare(odd, odd, odd, None, None, None)
    assert q.is_contiguous()
