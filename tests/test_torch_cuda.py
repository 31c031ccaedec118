"""Kernels K1 and K2 on the GPU against their plain PyTorch versions (K1 bit
for bit, K2 within the JAX package's flash tolerances), K2's wrapper
contract, and the extraction CLI on the GPU against the CPU.

Needs an NVIDIA GPU and nvcc: every test here carries the ``cuda`` marker and
skips without a card. This file imports no JAX, so the card's host runs it
without the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from moc_tpu_torch.ops import (NEG_INF, masked_col_topk_mask, threshold_topk_mask,
                               topk_threshold_mask, topk_kernel)
from moc_tpu_torch.ops.flash_attention import flash_attention_padded, mha_reference
from moc_tpu_torch.ops.flash_kernel import flash_fwd_cuda

K2_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1000, 4096, 16384, 131072])
@pytest.mark.parametrize("k", [1, 10, 400])
def test_k1_rows_bit_equal_to_plain(gen, n, k):
    x = torch.randn((5, n), generator=gen, device="cuda")
    x[1] = torch.round(x[1])  # ties
    x[2] = torch.tensor([-0.0, 0.0], device="cuda")[torch.randint(0, 2, (n,), generator=gen,
                                                                 device="cuda")]
    x[3, k // 2:] = NEG_INF  # fewer valid keys than k
    before = topk_kernel.topk_threshold_mask_cuda.launches
    got = topk_threshold_mask(x, k)
    torch.cuda.synchronize()
    assert topk_kernel.topk_threshold_mask_cuda.launches == before + 1
    assert torch.equal(got, threshold_topk_mask(x, k))
    assert bool((got.sum(-1) == k).all())


@pytest.mark.parametrize("n,k", [(777, 10), (16384, 10), (16384, 16384)])
def test_k1_columns_bit_equal_to_plain(gen, n, k):
    scores = torch.randn((3, n, 2), generator=gen, device="cuda")
    valid = torch.arange(n, device="cuda") < torch.tensor([[n], [n // 2], [3]], device="cuda")
    before = topk_kernel.col_topk_threshold_mask_cuda.launches
    got = masked_col_topk_mask(scores, valid, k)
    torch.cuda.synchronize()
    assert topk_kernel.col_topk_threshold_mask_cuda.launches == before + 1
    assert torch.equal(got.cpu(), masked_col_topk_mask(scores.cpu(), valid.cpu(), k))


def _k2_inputs(gen, length, d, dtype, segments, causal):
    q, k, v = (torch.randn((2, 3, length, d), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if not segments:
        return q, k, v, None, None
    if causal:  # packed sequences: every row sees at least itself
        seg = (torch.arange(length, device="cuda") >= length // 3).int()[None].repeat(2, 1)
        return q, k, v, seg, seg
    kv_seg = torch.randint(0, 3, (2, length), generator=gen, device="cuda", dtype=torch.int32)
    q_seg = kv_seg.clone()
    q_seg[0, :16] = 9  # rows that match no key
    return q, k, v, q_seg, kv_seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", [785, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("segments", [False, True])
def test_k2_matches_plain(gen, dtype, d, length, causal, segments):
    q, k, v, qs, ks = _k2_inputs(gen, length, d, dtype, segments, causal)
    before = flash_fwd_cuda.launches
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, qs, ks, causal=causal)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == before + 1
    ro, rlse = mha_reference(q, k, v, q_segment_ids=qs, kv_segment_ids=ks, causal=causal)
    tol = K2_TOL[dtype]
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rlse, rtol=tol, atol=tol)
    if segments and not causal:  # masked everywhere: mean(V), lse at the mask value
        torch.testing.assert_close(o[0, :, :16].float(),
                                   v[0].float().mean(1, keepdim=True).expand(-1, 16, -1),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain_at_extraction_shape(gen, dtype):
    """[64, 12, 785, 64]: the shape the CONCH trunk gives K2 at batch 64."""
    q, k, v = (torch.randn((64, 12, 785, 64), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v)
    ro, rlse = mha_reference(q, k, v)
    tol = K2_TOL[dtype]
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rlse, rtol=tol, atol=tol)


@pytest.mark.parametrize("lq,lkv", [(1, 1), (1, 300), (100, 37), (65, 1000), (300, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_k2_unequal_and_short_lengths(gen, lq, lkv, causal):
    """Lq != Lkv, partial tiles on both sides, top-left causal alignment."""
    q = torch.randn((2, 3, lq, 128), generator=gen, device="cuda")
    k, v = (torch.randn((2, 3, lkv, 128), generator=gen, device="cuda") for _ in range(2))
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, causal=causal, sm_scale=0.1)
    ro, rlse = mha_reference(q, k, v, causal=causal, sm_scale=0.1)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rlse, rtol=2e-5, atol=2e-5)


def test_k2_padding_mask_path(gen):
    q, k, v, _, _ = _k2_inputs(gen, 785, 64, torch.float32, False, False)
    mask = torch.rand((2, 785), generator=gen, device="cuda") < 0.2
    before = flash_fwd_cuda.launches
    o = flash_attention_padded(q, k, v, padding_mask=mask)
    torch.cuda.synchronize()
    assert flash_fwd_cuda.launches == before + 1
    seg = (~mask).int()
    ro, _ = mha_reference(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    torch.testing.assert_close(o, ro, rtol=2e-5, atol=2e-5)


def test_k2_wrapper_refuses(gen):
    q = torch.randn((1, 2, 128, 64), generator=gen, device="cuda")
    before = flash_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_fwd_cuda(q.cpu(), q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_fwd_cuda(q.half(), q.half(), q.half())
    q96 = torch.randn((1, 2, 128, 96), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_cuda(q96, q96, q96)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_cuda(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    g = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_fwd_cuda(g, q, q)
    assert flash_fwd_cuda.launches == before


def test_extraction_gpu_matches_cpu(gen, tmp_path):
    """Five 256 px patches through the extraction CLI at full CONCH width
    (flash trunk, batch 4 with a padded tail) on the GPU and on the CPU."""
    from moc_tpu_torch.cli import extract_features
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.zeroshot.convert import random_conch_state_dict

    torch.save(random_conch_state_dict(seed=0), tmp_path / "conch.bin")
    rng = np.random.default_rng(0)
    (tmp_path / "patches").mkdir()
    np.savez(tmp_path / "patches" / "s.npz",
             imgs=rng.integers(0, 256, (5, 256, 256, 3), np.uint8))
    feats = {}
    for device in ("cuda", "cpu"):
        before = flash_fwd_cuda.launches
        assert extract_features.main([
            "--patch_dir", str(tmp_path / "patches"), "--out_dir", str(tmp_path / device),
            "--checkpoint", str(tmp_path / "conch.bin"), "--flash", "--batch_size", "4",
            "--out_format", "pt", "--device", device]) == 0
        assert flash_fwd_cuda.launches - before == (24 if device == "cuda" else 0)
        feats[device] = read_bag_pt(str(tmp_path / device / "pt_files" / "s.pt")).features
    assert feats["cuda"].shape == (5, 512)
    np.testing.assert_allclose(np.linalg.norm(feats["cuda"], axis=1), 1.0, atol=1e-4)
    np.testing.assert_allclose(feats["cuda"], feats["cpu"], atol=1e-4)
