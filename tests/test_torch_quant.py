"""The int8 serving tier's quantization on the CPU against the JAX package's
(``moc_tpu.ops.quant``): the codes and scales bit-equal on the native and
the numpy routes, zero rows included; the W8A8 product at the NSCLC (72)
and RCC (74) widths of the fused scoring product within the JAX package's
own tolerance; the storage tiers of ``pack_bags``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moc_tpu.data import batching as jbatching
from moc_tpu.data.bags import Bag as JBag
from moc_tpu.ops import quant as jquant
from moc_tpu_torch.data import batching, native
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.ops import quant


def _features(seed, shape=(3, 96, 64)):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32) * rng.uniform(
        1e-3, 1e3, size=shape[:-1] + (1,)).astype(np.float32)
    f[0, 5] = 0.0  # a pad row
    f[1, -10:] = 0.0  # a bag's padding
    f[-1, 7] = np.linspace(-1, 1, shape[-1], dtype=np.float32)  # ties on the grid's midpoints
    f[-1, 7, 0] = 1.0
    return f


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_quantize_rows_host_bit_equal_to_jax(route, monkeypatch):
    f = _features(0)
    if route == "numpy":
        monkeypatch.setattr(native, "quantize_rows_i8", lambda *a, **k: None)
    before = native.native_calls["quantize"]
    q, s = quant.quantize_rows_host(f)
    assert native.native_calls["quantize"] == before + (route == "native")
    jq, js = jquant.quantize_rows_host(f)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == f.shape[:-1]
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert s[0, 5] == 0.0 and (q[0, 5] == 0).all() and (s[1, -10:] == 0).all()


def test_quantize_rows_host_into_given_buffers():
    f = _features(1)
    out = (np.empty(f.shape, np.int8), np.empty(f.shape[:-1], np.float32))
    q, s = quant.quantize_rows_host(f, out=out)
    assert q is out[0] and s is out[1]
    jq, js = jquant.quantize_rows_host(f)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


def test_quantize_rows_device_matches_jax_device_and_host():
    f = _features(2)
    q, s = quant.quantize_rows_device(torch.from_numpy(f))
    jq, js = jquant.quantize_rows_device(jnp.asarray(f))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    hq, _ = quant.quantize_rows_host(f)
    np.testing.assert_array_equal(q.numpy(), hq)


def test_quantize_columns_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 74)).astype(np.float32)
    w[:, 3] = 0.0  # absmax 0: scale 1
    wq, s = quant.quantize_columns(torch.from_numpy(w))
    jwq, js = jquant.quantize_columns(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[3] == 1.0 and (wq[:, 3] == 0).all()


@pytest.mark.parametrize("cols", [72, 74])  # NSCLC 2 + 6 + 64, RCC 3 + 7 + 64
def test_int8_row_matmul_matches_jax(cols):
    """The W8A8 product of a batch ``[B, N, D]`` against JAX's per-slide
    product: int32 sums are exact, so only the f32 scaling could differ;
    within JAX's rtol = atol = 1e-6 (``tests/test_quant.py:84``)."""
    rng = np.random.default_rng(cols)
    f = _features(cols, (2, 160, 64))
    w = rng.normal(size=(64, cols)).astype(np.float32)
    q, s = quant.quantize_rows_host(f)
    got = quant.int8_row_matmul(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(w))
    assert got.shape == (2, 160, cols) and got.dtype == torch.float32
    want = np.stack([np.asarray(jquant.int8_row_matmul(jnp.asarray(q[i]), jnp.asarray(s[i]),
                                                       jnp.asarray(w))) for i in range(2)])
    err = float(np.abs(got.numpy() - want).max())
    print(f"int8_row_matmul [2, 160, 64] x [64, {cols}]: max |port - jax| = {err:.3e}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the product itself: int32, exact
    wq, _ = quant.quantize_columns(torch.from_numpy(w))
    acc = quant._int_product(torch.from_numpy(q[0]), wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), q[0].astype(np.int64) @ wq.numpy().astype(np.int64))


def test_dequantize_rows():
    f = _features(4)
    q, s = quant.quantize_rows_host(f)
    got = quant.dequantize_rows(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.dequantize_rows(q, s)))


def _bag_lists(seed, lengths=(50, 300, 1), d=64):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(n, d)).astype(np.float32) for n in lengths]
    return ([Bag(f"s{i}", f, label=i % 2) for i, f in enumerate(feats)],
            [JBag(slide_id=f"s{i}", features=f, label=i % 2) for i, f in enumerate(feats)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pack_bags_tiers_match_jax(dtype):
    """Each storage tier's batch against the JAX package's ``pack_bags`` at
    that dtype: features (and int8 scales) bit-equal, the bf16 cast round to
    nearest even as ``ml_dtypes``; the features hold the tier's bytes."""
    bags, jbags = _bag_lists(5)
    batch = batching.pack_bags(bags, device="cpu", dtype=dtype)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    jbatch = jbatching.pack_bags(jbags, dtype=jdtype, device_put=False)
    got = batch.features
    if dtype == "bfloat16":
        got = got.view(torch.int16).numpy()
        want = np.asarray(jbatch.features).view(np.int16)
        ref = np.stack([np.pad(b.features, ((0, 512 - b.n_patches), (0, 0))) for b in bags])
        np.testing.assert_array_equal(got, ref.astype(ml_dtypes.bfloat16).view(np.int16))
    else:
        got, want = got.numpy(), np.asarray(jbatch.features)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(batch.mask.numpy(), np.asarray(jbatch.mask))
    np.testing.assert_array_equal(batch.labels.numpy(), np.asarray(jbatch.labels))
    if dtype == "int8":
        np.testing.assert_array_equal(batch.scales.numpy(), np.asarray(jbatch.scales))
    else:
        assert batch.scales is None and jbatch.scales is None
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    assert batch.features.element_size() == itemsize
    if dtype == "int8":
        assert batch.scales.dtype == torch.float32 and batch.scales.shape == batch.mask.shape


def test_slice_batch_carries_the_scales():
    bags, _ = _bag_lists(6)
    batch = batching.pack_bags(bags, device="cpu", dtype="int8")
    part = batch.slice_batch(1, 2)
    assert part.batch_size == 2
    for a, b in ((part.features, batch.features[1:3]), (part.scales, batch.scales[1:3]),
                 (part.mask, batch.mask[1:3]), (part.labels, batch.labels[1:3])):
        assert torch.equal(a, b)
