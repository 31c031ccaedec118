"""Kernels K1-K4 on the GPU against their plain PyTorch versions (K1 bit
for bit, K2-K4 within the JAX package's flash tolerances), the wrappers'
contracts, the flash-attention gradients against autograd of the dense
reference, and the extraction and pretraining CLIs, a MOC training epoch and
the fused episode sweep on the GPU against the CPU.

The serving tiers (dense, bf16 scoring, bf16 and int8 storage) on the card
against the CPU, with ``torch._int_mm`` against the CPU's int32 product.
K2 at MUSK-large's vision and padded text shapes; MUSK, the ResNet-50 trunk
and the extraction CLI's other backbones (and ``--wsi_dir``) on the card
against the CPU.

Needs an NVIDIA GPU and nvcc: every test here carries the ``cuda`` marker and
skips without a card. This file imports no JAX, so the card's host runs it
without the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from moc_tpu_torch.ops import (FOREGROUND_POOLINGS, NEG_INF, POOLING_REGISTRY,
                               masked_col_topk_mask, masked_logits, masked_row_margin,
                               select_and_gather, threshold_topk_mask, topk_kernel,
                               topk_threshold_mask, union_selection, union_selection_threshold)
from moc_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_padded,
                                               flash_attention_with_lse, flash_bwd_reference,
                                               mha_reference)
from moc_tpu_torch.ops.flash_kernel import flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda
from moc_tpu_torch.ops.masking import softmax

K2_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# f32 K2 against its plain version, beside K2_TOL: max |O - plain| at most
# 1e-5 of the largest |O|. The kernel takes every product in three TF32
# passes (an emulation on the CPU keeps 3.2e-7 to 1.1e-6 of it); one pass
# would miss K2_TOL itself.
F32_FWD_MAX_REL = 1e-5
# K3/K4: the JAX package's flash backward tolerance in f32; in bf16, a share
# of the largest gradient (dS and P are rounded to bf16 before the products)
BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
# f32 K3/K4 against their plain version, beside BWD_TOL: max |kernel - plain|
# at most 1e-5 of the largest |grad| of the three. The kernels take every
# product in three TF32 passes, each within a few units in 2^-22 of f32; one
# pass would miss this limit.
F32_BWD_MAX_REL = 1e-5
# bf16 K2, K3 and K4, beside the limits above: the summed |kernel - plain| at most
# 1% of the summed |plain|, so that a wrong mask or a dropped tile, which may
# stay under a limit on the largest element, fails
BF16_MEAN_REL = 1e-2

pytestmark = pytest.mark.cuda


def _assert_mean_close(got, want, dtype):
    if dtype == torch.bfloat16:
        diff = sum((g.float() - w.float()).abs().sum().item() for g, w in zip(got, want))
        ref = sum(w.float().abs().sum().item() for w in want)
        assert diff <= BF16_MEAN_REL * ref, diff / ref


def _assert_k2_close(o, lse, ro, rlse, dtype):
    """K2 against its plain version: within K2_TOL (O, and lse unless None),
    in f32 within F32_FWD_MAX_REL of the largest |O|, in bf16 to
    BF16_MEAN_REL."""
    tol = K2_TOL[dtype]
    assert o.dtype == dtype and (lse is None or lse.dtype == torch.float32)
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    if lse is not None:
        torch.testing.assert_close(lse, rlse, rtol=tol, atol=tol)
    if dtype == torch.float32:
        err, largest = (o - ro).abs().max().item(), ro.abs().max().item()
        assert err <= F32_FWD_MAX_REL * largest, (err, largest)
    _assert_mean_close([o], [ro], dtype)


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


def _tie_rows(gen, rows, n, k, kind):
    """k // 3 keys above v_k = 1.0, the rest of the k members ties at it at
    random places: as many ties as the fill ("exact": no ranking) or more
    ("straddle": ties in every CTA of a cluster, ranked across them); or
    all-equal rows ("equal")."""
    if kind == "equal":
        return torch.full((rows, n), 0.5, device="cuda")
    x = torch.randn((rows, n), generator=gen, device="cuda") - 10
    above = k // 3
    ties = k - above if kind == "exact" else min(n - above, 2 * (k - above) + 1)
    pos = torch.argsort(torch.rand((rows, n), generator=gen, device="cuda"), dim=-1)
    x.scatter_(-1, pos[:, :above], 5.0)
    x.scatter_(-1, pos[:, above:above + ties], 1.0)
    return x


# N = 400000 is past what a cluster of 8 stages: its slices stream
@pytest.mark.parametrize("n", [1000, 1500, 4096, 16384, 65536, 131072, 400000])
@pytest.mark.parametrize("rows", [1, 2, 5, 40])
@pytest.mark.parametrize("kind", ["straddle", "exact", "equal"])
def test_k1_cluster_rows_bit_equal_to_plain(gen, n, rows, kind):
    """Every cluster size the launcher picks (1, 2, 4, 8) and the streaming
    path, with ties ranked across the CTAs of a row or at the fill."""
    k = min(400, n)
    x = _tie_rows(gen, rows, n, k, kind)
    before = topk_kernel.topk_threshold_mask_cuda.launches
    got = topk_kernel.topk_threshold_mask_cuda(x, k)
    torch.cuda.synchronize()
    assert topk_kernel.topk_threshold_mask_cuda.launches == before + 1
    assert torch.equal(got, threshold_topk_mask(x, k))
    assert bool((got.sum(-1) == k).all())


@pytest.mark.parametrize("rows,n", [(5, 4096), (40, 16384), (2, 131072)])
def test_k1_ties_at_cta_boundaries(gen, rows, n):
    """Ties at v_k on both sides of every slice boundary of the cluster, with
    the fill ending inside a CTA after the first."""
    p = topk_kernel.plan(rows, n, torch.cuda.get_device_properties(0).multi_processor_count)
    assert p.cluster > 1
    x = torch.randn((rows, n), generator=gen, device="cuda") - 10
    edges = torch.arange(1, p.cluster, device="cuda") * p.slice
    ties = (edges[:, None] + torch.arange(-3, 3, device="cuda")).flatten()
    x[:, ties] = 1.0
    x[:, :7] = 5.0  # above v_k
    fill = len(ties) // 2 + 1  # ends inside the second CTA or a later one
    k = 7 + fill
    got = topk_kernel.topk_threshold_mask_cuda(x, k)
    want = threshold_topk_mask(x, k)
    assert torch.equal(got, want) and bool((got.sum(-1) == k).all())
    assert bool(got[:, ties[fill - 1]].all()) and not bool(got[:, ties[fill]].any())


@pytest.mark.parametrize("n", [777, 4096, 16384])
@pytest.mark.parametrize("layout", ["strided", "contiguous", "sliced"])
def test_k1_columns_in_place_at_six_classes(gen, n, layout):
    """The column entry reads [B, N, C=6] by stride (a transposed view, a
    contiguous tensor, every other row of a larger one) and writes a
    contiguous mask; one launch a call."""
    k = min(400, n // 2)
    x = _tie_rows(gen, 12, 2 * n, k, "straddle")
    if layout == "sliced":
        scores = x.view(2, 6, 2 * n).transpose(1, 2)[:, ::2]
    else:
        scores = x[:, :n].reshape(2, 6, n).transpose(1, 2)
        if layout == "contiguous":
            scores = scores.contiguous()
    before = topk_kernel.col_topk_threshold_mask_cuda.launches
    got = topk_kernel.col_topk_threshold_mask_cuda(scores, k)
    torch.cuda.synchronize()
    assert topk_kernel.col_topk_threshold_mask_cuda.launches == before + 1
    assert got.shape == (2, n, 6) and got.is_contiguous()
    assert torch.equal(got, threshold_topk_mask(scores, k, axis=-2))
    assert bool((got.sum(-2) == k).all())


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
@pytest.mark.parametrize("d", [32, 64, 128])
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
    _assert_k2_close(o, lse, ro, rlse, dtype)
    tol = K2_TOL[dtype]
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
    _assert_k2_close(o, lse, ro, rlse, dtype)


# (129, 785): a 16-row fragment of the last query tile holds one row; (785,
# 129): the causal diagonal crosses the last key tile inside a query tile
LENGTHS = [(1, 1), (1, 300), (100, 37), (65, 1000), (300, 64), (129, 785), (785, 129)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("lq,lkv", LENGTHS)
@pytest.mark.parametrize("causal", [False, True])
def test_k2_unequal_and_short_lengths(gen, dtype, d, lq, lkv, causal):
    """Lq != Lkv, partial tiles on both sides, top-left causal alignment."""
    q = torch.randn((2, 3, lq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((2, 3, lkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, causal=causal, sm_scale=0.1)
    ro, rlse = mha_reference(q, k, v, causal=causal, sm_scale=0.1)
    _assert_k2_close(o, lse, ro, rlse, dtype)


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
    _assert_k2_close(o, None, ro, None, torch.float32)


def test_forward_leaves_tf32_flags_alone(gen):
    """K2 in f32 on the card leaves the process-global TF32 flags as it
    found them, under each of their four settings, and its O and lse do not
    depend on them: the kernel splits its operands for the TF32 passes
    itself."""
    q, k, v, qs, ks = _k2_inputs(gen, 785, 64, torch.float32, True, False)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    outs = []
    try:
        for matmul in (False, True):
            for cudnn in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = matmul
                torch.backends.cudnn.allow_tf32 = cudnn
                before = flash_fwd_cuda.launches
                with torch.no_grad():
                    outs.append(flash_fwd_cuda(q, k, v, qs, ks))
                torch.cuda.synchronize()
                assert flash_fwd_cuda.launches == before + 1
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == (matmul, cudnn)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


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


def _bwd_case(gen, lq, lkv, d, dtype, segments, causal, b=2, h=3):
    """Inputs of K3/K4: q, k, v, the forward's o and lse from K2, a random do."""
    q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, h, lkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    qs = ks = None
    if segments and causal:  # packed sequences: every row sees at least itself
        qs = ks = (torch.arange(lq, device="cuda") >= lq // 3).int()[None].repeat(b, 1)
    elif segments:
        ks = torch.randint(0, 3, (b, lkv), generator=gen, device="cuda", dtype=torch.int32)
        qs = torch.randint(0, 3, (b, lq), generator=gen, device="cuda", dtype=torch.int32)
        qs[0, :16] = 9  # rows that match no key
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, qs, ks, causal=causal)
    do = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, o, lse, do, qs, ks


def _assert_bwd_close(got, want, dtype, dq_mean=False, f32_max_rel=False):
    # bf16: within 2e-2 of the largest |grad| of the three (dq alone is
    # rounding noise when every row has one key: dP - delta is 0 there), and
    # with dq_mean, where dq is not noise, dq alone to BF16_MEAN_REL; f32 with
    # f32_max_rel (against the plain version): also within F32_BWD_MAX_REL of
    # the largest |grad| of the three
    largest = max(w.float().abs().max().item() for w in want)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=BWD_TOL[dtype], atol=BWD_TOL[dtype],
                                       msg=name)
            if f32_max_rel:
                err = (g - w).abs().max().item()
                assert err <= F32_BWD_MAX_REL * largest, (name, err, largest)
        else:
            err = (g.float() - w.float()).abs().max().item()
            assert err <= BWD_TOL[dtype] * largest, (name, err)
    _assert_mean_close(got, want, dtype)
    if dq_mean:
        _assert_mean_close(got[:1], want[:1], dtype)


def _k3_k4(q, k, v, o, lse, do, qs, ks, causal):
    delta = (o.float() * do.float()).sum(-1)
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, qs, ks, causal=causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, qs, ks, causal=causal)
    torch.cuda.synchronize()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("length", [1, 63, 512, 785, 1024])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("segments", [False, True])
def test_k3_k4_match_plain(gen, dtype, d, length, causal, segments):
    q, k, v, o, lse, do, qs, ks = _bwd_case(gen, length, length, d, dtype, segments, causal)
    got = _k3_k4(q, k, v, o, lse, do, qs, ks, causal)
    want = flash_bwd_reference(q, k, v, o, lse, do, qs, ks, causal)
    _assert_bwd_close(got, want, dtype, dq_mean=length > 1, f32_max_rel=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lkv", [(1, 300), (100, 37), (65, 1000), (300, 64), (129, 785),
                                    (785, 129)])
@pytest.mark.parametrize("causal", [False, True])
def test_k3_k4_unequal_lengths(gen, dtype, lq, lkv, causal):
    """Lq != Lkv, partial tiles on both sides, top-left causal alignment
    (keys past every query get zero gradients)."""
    q, k, v, o, lse, do, qs, ks = _bwd_case(gen, lq, lkv, 128, dtype, False, causal)
    got = _k3_k4(q, k, v, o, lse, do, None, None, causal)
    _assert_bwd_close(got, flash_bwd_reference(q, k, v, o, lse, do, None, None, causal),
                      dtype, f32_max_rel=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k4_match_plain_at_pretrain_shape(gen, dtype):
    """[32, 12, 512, 64]: the shape the BEiT-3-base encoder gives K3 and K4
    at batch 32 and sequence 512."""
    q, k, v, o, lse, do, _, _ = _bwd_case(gen, 512, 512, 64, dtype, False, False, b=32, h=12)
    got = _k3_k4(q, k, v, o, lse, do, None, None, False)
    _assert_bwd_close(got, flash_bwd_reference(q, k, v, o, lse, do), dtype, dq_mean=True,
                      f32_max_rel=True)


def test_k3_bf16_packed_causal_d128(gen):
    """K3 alone in bf16 at D = 128 and L 785 (a ragged last tile), causal
    with packed sequences cut inside tiles, so that diagonal tiles mix the
    causal and the segment mask; one launch per call."""
    length, d = 785, 128
    q, k, v, do = (torch.randn((2, 3, length, d), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    cuts = torch.tensor([100, 261, 500, 700], device="cuda")
    seg = (torch.arange(length, device="cuda")[:, None] >= cuts).sum(1).int()[None].repeat(2, 1)
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, seg, seg, causal=True)
    delta = (o.float() * do.float()).sum(-1)
    for _ in range(2):
        before = flash_bwd_dq_cuda.launches
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, seg, seg, causal=True)
        torch.cuda.synchronize()
        assert flash_bwd_dq_cuda.launches == before + 1
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, seg, True)[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    err = (dq.float() - want.float()).abs().max().item()
    assert err <= BWD_TOL[torch.bfloat16] * want.float().abs().max().item(), err
    _assert_mean_close([dq], [want], torch.bfloat16)


def test_k3_k4_f32_packed_causal_d128(gen):
    """The f32 counterpart of the case above, for K3 and K4: D = 128 (keys
    and queries taken in passes of 32 and 16), L 785, causal with packed
    sequences cut inside tiles; within 5e-4 and within 1e-5 of the largest
    |grad| of the plain version, one launch of each per call."""
    length, d = 785, 128
    q, k, v, do = (torch.randn((2, 3, length, d), generator=gen, device="cuda")
                   for _ in range(4))
    cuts = torch.tensor([100, 261, 500, 700], device="cuda")
    seg = (torch.arange(length, device="cuda")[:, None] >= cuts).sum(1).int()[None].repeat(2, 1)
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, seg, seg, causal=True)
    for _ in range(2):
        got = _k3_k4(q, k, v, o, lse, do, seg, seg, True)
    want = flash_bwd_reference(q, k, v, o, lse, do, seg, seg, True)
    _assert_bwd_close(got, want, torch.float32, f32_max_rel=True)


def test_backward_leaves_tf32_flags_alone(gen):
    """A backward through ``flash_attention`` on the card leaves the
    process-global TF32 flags as it found them, under each of their four
    settings, and its f32 gradients do not depend on them: the kernels split
    their operands for the TF32 passes themselves."""
    q, k, v, _, _, do, _, _ = _bwd_case(gen, 300, 300, 64, torch.float32, False, True)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    grads = []
    try:
        for matmul in (False, True):
            for cudnn in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = matmul
                torch.backends.cudnn.allow_tf32 = cudnn
                before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
                grads.append(_grads(lambda q, k, v: flash_attention(q, k, v, causal=True),
                                    q, k, v, do))
                torch.cuda.synchronize()
                assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == (
                    before[0] + 1, before[1] + 1)
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == (matmul, cudnn)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


def _grads(fn, q, k, v, do, dlse=None):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves)
    if isinstance(out, tuple):
        out, lse = out
        loss = (out * do).sum() + (0 if dlse is None else (lse * dlse).sum())
    else:
        loss = (out * do).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("entry,causal", [(e, c) for e in ("flash_attention", "with_lse_sg",
                                                            "with_lse") for c in (False, True)]
                         + [("padded", False)])  # flash_attention_padded is non-causal
def test_gradients_match_autograd_of_reference(gen, causal, entry):
    """The autograd Functions against autograd of ``mha_reference`` on the
    card, on rows that match a key: the cotangent of rows that match none is
    zero, so the TPU kernels' P = 1 on those rows (L times the dense vjp)
    does not enter."""
    length, d = 300, 64
    q, k, v, _, _, do, qs, ks = _bwd_case(gen, length, length, d, torch.float32,
                                          not causal, causal)
    if entry == "padded":
        mask = torch.rand((2, length), generator=gen, device="cuda") < 0.2
        qs = ks = (~mask).int()
    dlse = None
    if qs is not None:
        matched = (qs[:, :, None] == ks[:, None, :]).any(-1)  # [B, Lq]
        do = do * matched[:, None, :, None]
    kw = dict(q_segment_ids=qs, kv_segment_ids=ks, causal=causal)
    fns = {"flash_attention": lambda q, k, v: flash_attention(q, k, v, **kw),
           "with_lse_sg": lambda q, k, v: flash_attention_with_lse(q, k, v, lse_grad=False,
                                                                   **kw),
           "with_lse": lambda q, k, v: flash_attention_with_lse(q, k, v, **kw),
           "padded": lambda q, k, v: flash_attention_padded(q, k, v, padding_mask=mask)}
    if entry == "with_lse":
        dlse = torch.randn((2, 3, length), generator=gen, device="cuda")
        if qs is not None:
            dlse = dlse * matched[:, None, :]
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    got = _grads(fns[entry], q, k, v, do, dlse)
    torch.cuda.synchronize()
    launched = 0 if entry == "with_lse" else 1  # lse_grad=True runs the dense vjp, as JAX
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == (before[0] + launched,
                                                                       before[1] + launched)
    want = _grads(lambda q, k, v: mha_reference(q, k, v, **kw), q, k, v, do, dlse)
    _assert_bwd_close(got, want, torch.float32)


def test_k3_k4_wrappers_refuse(gen):
    q, k, v, o, lse, do, _, _ = _bwd_case(gen, 128, 128, 64, torch.float32, False, False)
    delta = (o * do).sum(-1)
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    for fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(q.cpu(), k.cpu(), v.cpu(), do.cpu(), lse.cpu(), delta.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            fn(q, k, v, do.transpose(2, 3).contiguous().transpose(2, 3), lse, delta)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, do, lse.double(), delta)
        with pytest.raises(ValueError, match="delta"):
            fn(q, k, v, do, lse, delta[:, :, :64])
        with pytest.raises(ValueError, match="one dtype"):
            fn(q, k, v, do.bfloat16(), lse, delta)
        with pytest.raises(ValueError, match="both or neither"):
            fn(q, k, v, do, lse, delta, torch.zeros((2, 128), device="cuda"))
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == before


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


def test_pretrain_gpu_matches_cpu(gen):
    """Masked-token pretraining (2 layers, width 256, 8 heads of 32) from one
    state dict and one ``data_fn`` on the GPU and on the CPU. The first
    step's gradients agree within 1e-4 of each parameter's largest |grad|
    (the key biases' gradient is 0 but for rounding); over three steps the
    losses agree within 1e-4 and the parameters within 3·lr, since Adam
    moves a weight whose gradient is below the devices' rounding noise by up
    to lr a step. The card's step launches K2, K3 and K4 once per layer each."""
    from moc_tpu_torch.cli import pretrain
    from moc_tpu_torch.train.pretrain import (MaskedTokenModel, batch_to, make_pretrain_state,
                                              masked_token_loss, run_pretrain)

    args = pretrain.get_args(["--batch", "4", "--seq_len", "128", "--layers", "2",
                              "--embed_dim", "256", "--ffn_dim", "1024", "--heads", "8"])
    cfg = pretrain.build_config(args)
    data_fn = pretrain.make_data_fn(args)
    state = MaskedTokenModel(cfg).init_parameters(torch.Generator().manual_seed(0)).state_dict()
    grads = {}
    for device in ("cuda", "cpu"):
        model, _ = make_pretrain_state(cfg, device=device, state_dict=state)
        total, _, _ = masked_token_loss(cfg, model, *batch_to(torch.device(device), *data_fn(0)))
        total.backward()
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    for name, g in grads["cpu"].items():
        if not name.endswith("k_proj.bias"):
            assert float((grads["cuda"][name] - g).abs().max()) <= 1e-4 * float(g.abs().max())
    runs = {}
    for device in ("cuda", "cpu"):
        before = [fn.launches for fn in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)]
        model, _, losses = run_pretrain(cfg, data_fn, total_steps=3, device=device,
                                        state_dict=state)
        launched = [fn.launches - b for fn, b in zip(
            (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda), before)]
        assert launched == ([6, 6, 6] if device == "cuda" else [0, 0, 0])
        runs[device] = losses, {k: v.cpu() for k, v in model.state_dict().items()}
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=0, atol=1e-4)
    for name, t in runs["cuda"][1].items():
        torch.testing.assert_close(t, runs["cpu"][1][name], rtol=0,
                                   atol=3 * cfg.learning_rate, msg=name)


def _training_batch(device):
    """Four synthetic slides of 1500-4000 patches at D=512 (two a class),
    the oracle weights, and the full-width ``MOCConfig`` (topj 400, topk 10)."""
    from moc_tpu_torch.data.bags import Bag
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, sample_bag, zero_shot_weights
    from moc_tpu_torch.moc import MOCConfig

    syn = SyntheticWSIConfig(min_patches=1500, max_patches=4000, seed=3)
    rng = np.random.default_rng(3)
    bags = [Bag(slide_id=str(i), features=sample_bag(syn, i % 2, rng)[0], label=i % 2)
            for i in range(4)]
    w, w_ext = (torch.from_numpy(x).to(device) for x in zero_shot_weights(syn))
    return pack_bags(bags, device=device), w, w_ext, MOCConfig(n_classes=2, n_ext_classes=6)


def test_moc_training_epoch_gpu_matches_cpu(gen):
    """One epoch of per-slide Adam steps (8 visits of 4 slides in the 4096
    bucket, gather route) on the card and on the CPU, from one SENet and one
    set of keep masks: K1 launched twice a step on the card (selection rows
    and pooling columns), never on the CPU; first-step gradients within 1e-5
    of each parameter's largest |grad|, losses within 1e-5, parameters
    within Adam's bound of lr a step."""
    import torch.nn.functional as F

    from moc_tpu_torch.moc import init_senet, make_optimizer, moc_slide_logits, train_epoch

    order = [0, 1, 2, 3, 0, 1, 2, 3]
    runs = {}
    for device in ("cuda", "cpu"):
        batch, w, w_ext, cfg = _training_batch(device)
        keep = (torch.rand((len(order), batch.padded_len),
                           generator=torch.Generator().manual_seed(5)) < 0.5).to(device)
        senet = init_senet(0, cfg, device)
        logits = moc_slide_logits(senet, batch.features[:1], batch.mask[:1], w, w_ext, cfg,
                                  keep[:1])
        F.cross_entropy(logits, batch.labels[:1].long()).backward()
        grads = {n: p.grad.cpu() for n, p in senet.named_parameters()}
        senet = init_senet(0, cfg, device)
        before = (topk_kernel.topk_threshold_mask_cuda.launches,
                  topk_kernel.col_topk_threshold_mask_cuda.launches)
        losses = train_epoch(senet, make_optimizer(senet.parameters(), cfg), batch, order, keep,
                             w, w_ext, cfg).cpu()
        launched = (topk_kernel.topk_threshold_mask_cuda.launches - before[0],
                    topk_kernel.col_topk_threshold_mask_cuda.launches - before[1])
        assert launched == ((len(order), len(order)) if device == "cuda" else (0, 0))
        runs[device] = grads, losses, {k: v.cpu() for k, v in senet.state_dict().items()}
    (gg, lg, pg), (gc, lc, pc) = runs["cuda"], runs["cpu"]
    for name, g in gc.items():
        assert float((gg[name] - g).abs().max()) <= 1e-5 * float(g.abs().max()), name
    np.testing.assert_allclose(lg.numpy(), lc.numpy(), rtol=0, atol=1e-5)
    for name, t in pg.items():
        torch.testing.assert_close(t, pc[name], rtol=0, atol=len(order) * cfg.learning_rate,
                                   msg=name)


def test_moc_masked_route_gradients_through_k1_on_the_card(gen):
    """The masked route scores the SENet's first layer in the same matmul as
    the selection keys, so K1 takes keys that require grad (both entries, no
    copy); its pooling gate passes the gradient through ``where``. Its pooled
    logits and SENet gradients equal the gather route's within 1e-5."""
    import dataclasses

    import torch.nn.functional as F

    from moc_tpu_torch.moc import init_senet, moc_slide_logits

    batch, w, w_ext, cfg = _training_batch("cuda")
    keep = torch.rand((1, batch.padded_len), generator=gen, device="cuda") < 0.5
    out = {}
    for impl in ("masked", "gather"):
        senet = init_senet(0, cfg, "cuda")
        before = (topk_kernel.topk_threshold_mask_cuda.launches,
                  topk_kernel.col_topk_threshold_mask_cuda.launches)
        logits = moc_slide_logits(senet, batch.features[1:2], batch.mask[1:2], w, w_ext,
                                  dataclasses.replace(cfg, exact_impl=impl), keep)
        assert (topk_kernel.topk_threshold_mask_cuda.launches - before[0],
                topk_kernel.col_topk_threshold_mask_cuda.launches - before[1]) == (1, 1)
        F.cross_entropy(logits, batch.labels[1:2].long()).backward()
        out[impl] = logits.detach(), {n: p.grad for n, p in senet.named_parameters()}
    torch.testing.assert_close(out["masked"][0], out["gather"][0], rtol=1e-5, atol=1e-5)
    for name, g in out["gather"][1].items():
        assert float((out["masked"][1][name] - g).abs().max()) <= 1e-5 * float(g.abs().max())
    keys = torch.randn((5, 4096), generator=gen, device="cuda").requires_grad_(True) * 1.0
    assert torch.equal(topk_threshold_mask(keys, 400), threshold_topk_mask(keys.detach(), 400))
    cols = torch.randn((1, 2, 2432), generator=gen, device="cuda").requires_grad_(True)
    cols = (cols * 1.0).transpose(1, 2)
    assert torch.equal(masked_col_topk_mask(cols, torch.ones((1, 2432), dtype=torch.bool,
                                                             device="cuda"), 10),
                       threshold_topk_mask(cols.detach(), 10, axis=-2))


def _small_sweep(device, root, fixed_masks=True):
    """The fused sweep of both folds of shot 2 over a small, weak synthetic
    corpus (D=64, bags of 60-480 patches, test AUC below 1; topj 24, 3
    epochs, seeds 0 and 3) on
    ``device``, every episode starting from ``init_senet(seed)`` and keeping
    the patches of one set of masks drawn on the CPU (with ``fixed_masks``)
    or of its own generator's on the device."""
    from moc_tpu_torch.data import BagLoader, SlideTable, read_split_csv
    from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, make_synthetic_corpus
    from moc_tpu_torch.moc import MOCConfig, init_senet, pool_episode_splits, run_sweep_pooled

    corpus = make_synthetic_corpus(root, SyntheticWSIConfig(
        slides_per_class=10, min_patches=60, max_patches=480, dim=64, seed=7, signal=0.2,
        tumor_frac=0.1), shots=(2,))
    table = SlideTable.from_csv(corpus["csv_path"], corpus["label_dict"])
    splits = [read_split_csv(corpus["split_paths"][(2, f)]) for f in (0, 1)]
    pooled = pool_episode_splits(BagLoader(table, corpus["data_dir"]), splits)
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, topj=24, feature_dim=64, num_epochs=3)
    masks = torch.rand((2, 3, 4, pooled.pool_feats.shape[1]),
                       generator=torch.Generator().manual_seed(0)) < 0.5
    seeds = (0, 3)
    return run_sweep_pooled(pooled, corpus["weights"], corpus["weights_ext"], cfg,
                            repeat_num=4, seeds=seeds, with_zs=True, device=device,
                            keep_fn=(lambda e, epoch, v, n: masks[e, epoch, :v, :n])
                            if fixed_masks else None,
                            init_states=[init_senet(s, cfg).state_dict() for s in seeds]), cfg


def test_sweep_gpu_matches_cpu(gen, tmp_path):
    """The small two-fold sweep on the card and on the CPU from one set of
    SENets and keep masks: the same best epochs; best val AUC, test AUC and
    accuracy, the zero-shot floor and every step's loss within 1e-5; best
    parameters within Adam's bound (lr a step); K1 launched on the card (2
    a batched step, 12 steps, and the evaluation's), never on the CPU."""
    runs = {}
    for device in ("cuda", "cpu"):
        before = (topk_kernel.topk_threshold_mask_cuda.launches,
                  topk_kernel.col_topk_threshold_mask_cuda.launches)
        result, cfg = _small_sweep(device, str(tmp_path / device))
        torch.cuda.synchronize()
        launched = (topk_kernel.topk_threshold_mask_cuda.launches - before[0],
                    topk_kernel.col_topk_threshold_mask_cuda.launches - before[1])
        # rows: 12 steps + the eval pack; columns: 12 steps, 3 zero-shot splits, the trajectory
        assert launched == ((13, 16) if device == "cuda" else (0, 0)), launched
        runs[device] = result
    got, want = runs["cuda"], runs["cpu"]
    assert torch.equal(got.best_epoch.cpu(), want.best_epoch)
    for name in ("best_val_auc", "test_auc_at_best", "test_acc_at_best", "zs", "losses"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name), rtol=0,
                                   atol=1e-5, msg=name)
    for name, t in got.best_params.items():
        torch.testing.assert_close(t.cpu(), want.best_params[name], rtol=0,
                                   atol=12 * cfg.learning_rate, msg=name)


def test_sweep_waits_for_nothing_from_its_first_step_to_its_evaluation(gen, tmp_path,
                                                                       monkeypatch):
    """From the first batched step to the end of the evaluation the sweep
    makes no host synchronisation (no ``.item()``, ``nonzero`` or boolean
    indexing): under ``set_sync_debug_mode("error")``, switched on by the
    first step, any such call raises."""
    from moc_tpu_torch.moc import sweep

    inner, steps = sweep.sweep_step, []

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        steps.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(sweep, "sweep_step", strict)
    try:
        result, _ = _small_sweep("cuda", str(tmp_path), fixed_masks=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(steps) == 12
    assert bool(torch.isfinite(result.losses).all()) and result.best_epoch.shape == (2,)


# the ranking keys of the five foreground pooling families: K1's column
# entry sees [B, N, 1] for delta_diff's margin and [B, N, C] for the rest
FOREGROUND_KEYS = {
    "topj": lambda x: x,
    "delta_softmax": lambda x: softmax(x, dim=-1),
    "delta_diff": lambda x: masked_row_margin(x)[..., None],
    "topj_delta_softmax": lambda x: softmax(x, dim=-1) * x,
    "topj_delta_diff": lambda x: x * masked_row_margin(x)[..., None],
}


def _pooling_logits(gen, c, ties=False):
    """Logits ``[4, 4096, c]`` on the card, with 4096, 3000, 7 and 0 valid
    rows; padded rows hold NaN."""
    x = torch.randn((4, 4096, c), generator=gen, device="cuda")
    if ties:
        x = torch.round(x)
    valid = torch.arange(4096, device="cuda") < torch.tensor([[4096], [3000], [7], [0]],
                                                              device="cuda")
    return torch.where(valid[..., None], x, float("nan")), valid


@pytest.mark.parametrize("name", sorted(FOREGROUND_KEYS))
def test_foreground_family_k1_masks_bit_equal_to_plain(gen, name):
    """Each foreground family's membership mask from K1 on the card is
    bit-equal to the plain version on the same keys, and the family launches
    K1 once on its mask route."""
    logits, valid = _pooling_logits(gen, 2)
    keys = FOREGROUND_KEYS[name](logits)
    assert keys.shape[-1] == (1 if name == "delta_diff" else 2)
    got = masked_col_topk_mask(keys, valid, 10)
    want = threshold_topk_mask(masked_logits(keys, valid).cpu(), 10, axis=-2)
    assert torch.equal(got.cpu(), want)
    before = topk_kernel.col_topk_threshold_mask_cuda.launches
    POOLING_REGISTRY[name](logits, valid, 10)
    torch.cuda.synchronize()
    assert topk_kernel.col_topk_threshold_mask_cuda.launches == before + 1


@pytest.mark.parametrize("return_indices", [False, True])
@pytest.mark.parametrize("name", sorted(POOLING_REGISTRY))
def test_pooling_families_on_the_card_match_the_cpu(gen, name, return_indices):
    """All ten families on the card against the CPU on the card's own
    logits: pooled values within 1e-6, indices equal, bottom-k families with
    ``detection`` both ways; K1 only on the foreground mask route."""
    fg = name in FOREGROUND_POOLINGS
    logits, valid = _pooling_logits(gen, 2 if fg else 6)
    for kw in ([{}] if fg else [{"n_fg": 2, "detection": False}, {"n_fg": 2, "detection": True}]):
        before = topk_kernel.col_topk_threshold_mask_cuda.launches
        got = POOLING_REGISTRY[name](logits, valid, 10, return_indices=return_indices, **kw)
        torch.cuda.synchronize()
        launched = topk_kernel.col_topk_threshold_mask_cuda.launches - before
        assert launched == (1 if fg and not return_indices else 0)
        want = POOLING_REGISTRY[name](logits.cpu(), valid.cpu(), 10,
                                      return_indices=return_indices, **kw)
        if return_indices:
            assert torch.equal(got[1].cpu(), want[1])
            got, want = got[0], want[0]
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
        assert (got[3] == NEG_INF).all()


def _selection_inputs(gen, kind):
    """``(logits [8, N, 2], logits_ext [8, N, 6], valid [8, N])`` on the
    card: random, tie-heavy (integers, signed zeros among them), or all
    ±0.0 with mixed signs, where the sort path and the threshold path part."""
    n = 16 if kind == "signed_zeros" else 4096
    ext = torch.randn((8, n, 6), generator=gen, device="cuda")
    if kind == "ties":
        ext = torch.round(ext)
    elif kind == "signed_zeros":
        ext = torch.where(ext < 0, -0.0, 0.0)
    valid = torch.arange(n, device="cuda") < torch.randint(1, n + 1, (8, 1), generator=gen,
                                                           device="cuda")
    valid[0] = True
    if kind == "signed_zeros":  # every row valid, so that the paths part
        valid[:] = True
    return ext[..., :2].contiguous(), ext, valid


@pytest.mark.parametrize("kind", ["random", "ties", "signed_zeros"])
def test_sort_path_on_the_card_bit_equal_to_the_cpu(gen, kind):
    """``union_selection`` and ``select_and_gather(method="sort")`` on the
    card against the CPU on the same logits, bit for bit; with signed zeros
    the two exact paths part on the card as on the CPU."""
    args = _selection_inputs(gen, kind)
    cpu = tuple(a.cpu() for a in args)
    topj = 3 if kind == "signed_zeros" else 400
    assert torch.equal(union_selection(*args, topj, 2).cpu(), union_selection(*cpu, topj, 2))
    got = select_and_gather(*args, topj, 2, 2432, method="sort")
    for g, w in zip(got, select_and_gather(*cpu, topj, 2, 2432, method="sort")):
        assert torch.equal(g.cpu(), w)
    if kind == "signed_zeros":
        sort, thr = union_selection(*args, topj, 2), union_selection_threshold(*args, topj, 2)
        assert torch.equal(thr.cpu(), union_selection_threshold(*cpu, topj, 2))
        assert bool((sort != thr).any())


def test_sort_path_and_pooling_families_wait_for_nothing(gen):
    """No host synchronisation on the sort path or in any family (the
    sweep's evaluation runs them under ``set_sync_debug_mode("error")``)."""
    args = _selection_inputs(gen, "random")
    logits, valid = _pooling_logits(gen, 6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        union_selection(*args, 400, 2)
        select_and_gather(*args, 400, 2, 2432, method="sort")
        for name, fn in POOLING_REGISTRY.items():
            fg = name in FOREGROUND_POOLINGS
            x, kw = (logits[..., :2], {}) if fg else (logits, {"n_fg": 2, "detection": True})
            fn(x, valid, 10, return_indices=True, **kw)
            fn(x, valid, 10, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# MI-Zero's top-j pooling (run_mizero): [16, 4096, 2] patch logits, 1500-4000
# valid rows a slide
MIZERO_TOPJ = (1, 5, 10, 50, 100)


@pytest.mark.parametrize("k", MIZERO_TOPJ)
def test_k1_masks_at_mizero_shapes_bit_equal_to_plain(gen, k):
    counts = torch.randint(1500, 4001, (16,), generator=gen, device="cuda")
    valid = torch.arange(4096, device="cuda") < counts[:, None]
    keys = torch.randn(16, 4096, 2, generator=gen, device="cuda")
    before = topk_kernel.col_topk_threshold_mask_cuda.launches
    got = masked_col_topk_mask(keys, valid, k)
    assert topk_kernel.col_topk_threshold_mask_cuda.launches == before + 1
    assert torch.equal(got, threshold_topk_mask(masked_logits(keys, valid), k, axis=-2))
    assert torch.equal(got.cpu(), masked_col_topk_mask(keys.cpu(), valid.cpu(), k))
    assert (got & valid[..., None]).sum(-2).eq(k).all()


def test_text_tower_and_weights_on_the_card_match_the_cpu(gen, tmp_path):
    """A CONCH-width text tower (768 wide, 12 heads; 2 layers) from a release
    checkpoint on the GPU and on the CPU: ``encode_text`` on pad-heavy ids and
    the nsclc banks' ``W`` within 1e-5, with TF32 off at every text forward
    on the card, though turned on before."""
    from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT, NSCLC
    from moc_tpu_torch.zeroshot import (ConchTokenizer, build_zero_shot_classifier, load_conch,
                                        load_prompt_bank)
    from moc_tpu_torch.zeroshot.classifier import make_encode_text_fn
    from moc_tpu_torch.zeroshot.convert import random_conch_state_dict
    from moc_tpu_torch.zeroshot.text_tower import TextConfig
    from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

    vision = VisionConfig(image_size=32, patch_size=16, width=64, layers=1, heads=1,
                          embed_dim_contrast=32, embed_dim_caption=64, n_queries_caption=4)
    torch.save(random_conch_state_dict(vision, seed=4, text=TextConfig(layers=2)),
               tmp_path / "conch.bin")
    card = load_conch(str(tmp_path / "conch.bin"), image_size=32, device="cuda")
    cpu = load_conch(str(tmp_path / "conch.bin"), image_size=32, device="cpu")
    flags = []
    card.text.register_forward_pre_hook(lambda *_: flags.append(
        torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32))
    ids = torch.zeros((4, 128), dtype=torch.int64)
    for i, n in enumerate((0, 1, 40, 127)):
        ids[i, :n] = torch.randint(1, 32007, (n,))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    tokenizer = ConchTokenizer()
    try:
        got = make_encode_text_fn(card)(ids.numpy())
        want = make_encode_text_fn(cpu)(ids.numpy())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        for f, labels in ((NSCLC.prompt_file, NSCLC.label_dict),
                          (NSCLC.prompt_file_ext, NSCLC.label_dict_ext)):
            bank = load_prompt_bank(f"{DEFAULT_PROMPT_ROOT}/{f}", labels)
            w = build_zero_shot_classifier(make_encode_text_fn(card, "cuda"), tokenizer, bank)
            w_cpu = build_zero_shot_classifier(make_encode_text_fn(cpu, "cpu"), tokenizer, bank)
            assert w.shape == (512, len(labels))
            np.testing.assert_allclose(w, w_cpu, rtol=0, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert len(flags) == 1 + 8 and not any(flags)


def test_run_mizero_on_the_card_matches_the_cpu(gen):
    """16 slides, two batches: pooled logits within 1e-6, predictions and
    metrics equal, K1 launched once a j a batch."""
    from moc_tpu_torch.data import Bag, pack_bags
    from moc_tpu_torch.zeroshot import run_mizero

    rng = np.random.default_rng(1)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0)
    bags = []
    for i in range(16):
        n = int(rng.integers(1500, 4001))
        f = rng.normal(size=(n, 64)).astype(np.float32)
        f[: n // 4] += 0.3 * w[:, i % 3]
        bags.append(Bag(slide_id=f"s{i}", features=f, label=i % 3))
    out = {}
    for device in ("cuda", "cpu"):
        batches = [pack_bags(bags[i: i + 8], n_pad=4096, device=device) for i in (0, 8)]
        before = topk_kernel.col_topk_threshold_mask_cuda.launches
        out[device] = run_mizero(batches, w, topj=MIZERO_TOPJ)
        launched = topk_kernel.col_topk_threshold_mask_cuda.launches - before
        assert launched == (2 * len(MIZERO_TOPJ) if device == "cuda" else 0)
    (res, dump), (res_cpu, dump_cpu) = out["cuda"], out["cpu"]
    for j in MIZERO_TOPJ:
        np.testing.assert_allclose(dump["logits"][j], dump_cpu["logits"][j], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(dump["preds"][j], dump_cpu["preds"][j])
    assert res == res_cpu


# ------------------------------------------------------------------ serving tiers

@pytest.mark.parametrize("m,k,n", [(64, 512, 72), (16384, 512, 74), (5, 64, 8), (17, 60, 3),
                                   (1000, 520, 1)])
def test_int_mm_on_the_card_equals_the_cpu_int32_product(gen, m, k, n):
    """The int8 tier's product (``ops.quant._int_product``, ``torch._int_mm``
    with zero padding to its shape rules) on the card against the CPU's int32
    product, exactly: at the NSCLC (72) and RCC (74) widths of the fused
    scoring product, below ``_int_mm``'s m > 16, and with k and n off a
    multiple of 8."""
    from moc_tpu_torch.ops import quant

    cpu = torch.Generator().manual_seed(m + k + n)
    q = torch.randint(-127, 128, (m, k), generator=cpu, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=cpu, dtype=torch.int8)
    got = quant._int_product(q.cuda(), wq.cuda())
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), q.to(torch.int32) @ wq.to(torch.int32))
    rows = torch.rand(m, generator=cpu)
    w = torch.randn((k, n), generator=cpu)
    got = quant.int8_row_matmul(q.cuda(), rows.cuda(), w.cuda()).cpu()
    assert torch.equal(got, quant.int8_row_matmul(q, rows, w))


def _tier_batches(device):
    from moc_tpu_torch.data import Bag
    from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, sample_bag, zero_shot_weights

    syn = SyntheticWSIConfig(min_patches=1500, max_patches=4000, seed=4)
    rng = np.random.default_rng(4)
    bags = [Bag(slide_id=str(i), features=sample_bag(syn, i % 2, rng)[0], label=i % 2)
            for i in range(4)]
    w, w_ext = (torch.from_numpy(x).to(device) for x in zero_shot_weights(syn))
    return bags, w, w_ext


TIER_CASES = {"dense": ("float32", dict(dense=True)),
              "score_bf16": ("float32", dict(score_dtype="bfloat16")),
              "storage_bf16": ("bfloat16", {}), "storage_int8": ("int8", {}),
              "dense_int8": ("int8", dict(dense=True))}


@pytest.mark.parametrize("tier", sorted(TIER_CASES))
def test_tier_forward_on_the_card_matches_the_cpu(gen, tier):
    """Each tier's ``eval_batch`` on the card against the CPU from the same
    bags (each side packs its own batch, through the native packer): pooled
    logits within rtol 1e-4 / atol 1e-5, K1 launched once on the rows (none
    in the dense tier) and once on the columns; the batch carries the tier's
    dtype and only its bytes."""
    from moc_tpu_torch.data import native
    from moc_tpu_torch.data.batching import STORAGE_DTYPES, pack_bags
    from moc_tpu_torch.moc import MOCConfig, eval_batch, init_senet

    storage, kw = TIER_CASES[tier]
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, **kw)
    out = {}
    for device in ("cuda", "cpu"):
        bags, w, w_ext = _tier_batches(device)
        before = native.native_calls["pack"]
        batch = pack_bags(bags, device=device, dtype=storage)
        assert native.native_calls["pack"] == before + 1
        assert batch.features.dtype == STORAGE_DTYPES[storage]
        assert (batch.scales is not None) == (storage == "int8")
        rows0 = topk_kernel.topk_threshold_mask_cuda.launches
        cols0 = topk_kernel.col_topk_threshold_mask_cuda.launches
        out[device] = eval_batch(init_senet(0, cfg, device), batch, w, w_ext, cfg).cpu()
        torch.cuda.synchronize()
        launched = (topk_kernel.topk_threshold_mask_cuda.launches - rows0,
                    topk_kernel.col_topk_threshold_mask_cuda.launches - cols0)
        want = ((0 if cfg.dense else 1, 1) if device == "cuda" else (0, 0))
        assert launched == want, (device, launched)
    assert torch.isfinite(out["cuda"]).all()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tier", sorted(TIER_CASES))
def test_tiers_leave_tf32_flags_as_their_precision_says(gen, tier):
    """Under each of the four TF32 settings: the bf16-scoring and int8 tiers
    leave the process-global flags as they found them, the f32-scoring
    tiers leave them off (the exact tier's ``_full_f32``); every setting
    gives the same logits."""
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.moc import MOCConfig, eval_batch, init_senet

    storage, kw = TIER_CASES[tier]
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, **kw)
    bags, w, w_ext = _tier_batches("cuda")
    batch = pack_bags(bags, device="cuda", dtype=storage)
    senet = init_senet(0, cfg, "cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    keeps = cfg.score_dtype == "bfloat16" or storage == "int8"
    outs = []
    try:
        for matmul in (False, True):
            for cudnn in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = matmul
                torch.backends.cudnn.allow_tf32 = cudnn
                outs.append(eval_batch(senet, batch, w, w_ext, cfg))
                torch.cuda.synchronize()
                assert (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == ((matmul, cudnn) if keeps
                                                             else (False, False))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    for other in outs[1:]:
        assert torch.equal(outs[0], other)


def _musk_text_segments():
    """Segment ids of the vendored nsclc banks (176 prompts) under MUSK's
    hash tokenizer at length 100: 1 on tokens, 0 on padding."""
    import os

    from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT, NSCLC
    from moc_tpu_torch.zeroshot import load_prompt_bank
    from moc_tpu_torch.zeroshot.musk_tokenizer import MuskTokenizer

    texts = []
    for name, labels in ((NSCLC.prompt_file, NSCLC.label_dict),
                         (NSCLC.prompt_file_ext, NSCLC.label_dict_ext)):
        bank = load_prompt_bank(os.path.join(DEFAULT_PROMPT_ROOT, name), labels)
        texts += [t for c in range(bank.n_classes) for alias in bank.texts_for_class(c)
                  for t in alias]
    _, pad = MuskTokenizer(max_len=100)(texts)
    return torch.from_numpy(~pad).int().cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stream", ["vision", "text"])
def test_k2_matches_plain_at_musk_shapes(gen, dtype, stream):
    """MUSK-large's streams: vision [64, 16, 577, 64]; text [176, 16, 100,
    64] with the prompts' padding as segment ids (a padded query sees only
    padding)."""
    seg = _musk_text_segments() if stream == "text" else None
    shape = (64, 16, 577, 64) if seg is None else (seg.shape[0], 16, 100, 64)
    assert seg is None or seg.shape[0] == 176
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    with torch.no_grad():
        o, lse = flash_fwd_cuda(q, k, v, seg, seg)
    ro, rlse = mha_reference(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
    _assert_k2_close(o, lse, ro, rlse, dtype)


def _small_musk():
    from moc_tpu_torch.models.musk import MuskConfig
    from moc_tpu_torch.nn.encoder import EncoderConfig
    from moc_tpu_torch.zeroshot.convert_musk import random_musk_state_dict

    cfg = MuskConfig(image_size=64, patch_size=16, vocab_size=300, embed_dim=128, out_dim=64,
                     encoder=EncoderConfig(embed_dim=128, ffn_dim=512, layers=3, heads=2,
                                           multiway=True))
    return random_musk_state_dict(cfg, seed=0)


def test_musk_gpu_matches_cpu(gen, tmp_path):
    """A small release-layout MUSK (3 multiway layers, 64 px) from one file
    on the card and on the CPU: vision, padded text and mixed calls within
    1e-4, K2 launched once a layer a call."""
    from moc_tpu_torch.zeroshot.convert_musk import load_musk
    from moc_tpu_torch.zeroshot.musk_tokenizer import MuskTokenizer

    torch.save({"model": _small_musk()}, tmp_path / "musk.pth")
    models = {dev: load_musk(str(tmp_path / "musk.pth"), image_size=64, device=dev)
              for dev in ("cuda", "cpu")}
    images = torch.randn((4, 64, 64, 3), generator=gen, device="cuda")
    ids, pad = (torch.from_numpy(a) for a in MuskTokenizer(max_len=20, vocab_size=300)(
        ["squamous cell carcinoma", "a photomicrograph of lung adenocarcinoma tissue", ""]))
    outs = {}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dev, model in models.items():
            before = flash_fwd_cuda.launches
            with torch.inference_mode():
                vis, txt, _ = model(images.to(dev), ids.long().to(dev), pad.to(dev))
                mixed, _ = model.beit3(textual_tokens=ids[:2].long().to(dev),
                                       visual_tokens=images[:2].to(dev),
                                       text_padding_mask=pad[:2].to(dev))
            torch.cuda.synchronize()
            assert flash_fwd_cuda.launches - before == (9 if dev == "cuda" else 0)
            outs[dev] = [t.cpu() for t in (vis, txt, mixed)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    real = ~torch.cat([torch.zeros(2, 17, dtype=torch.bool), pad[:2]], dim=1)
    for i, (got, want) in enumerate(zip(outs["cuda"], outs["cpu"])):
        if i == 2:
            got, want = got[real], want[real]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_resnet_gpu_matches_cpu(gen, tmp_path):
    """The ResNet-50 trunk from one torchvision-layout file at 64 px on the
    card (TF32 off) and on the CPU, within 1e-4."""
    from moc_tpu_torch.models.convert_resnet import load_resnet50, random_resnet50_state_dict

    torch.save(random_resnet50_state_dict(seed=0), tmp_path / "resnet50.pth")
    images = torch.randn((4, 64, 64, 3), generator=gen, device="cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            got, want = (load_resnet50(str(tmp_path / "resnet50.pth"), device=dev)(
                images.to(dev)).cpu() for dev in ("cuda", "cpu"))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert got.shape == (4, 1024)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backbone", ["musk", "resnet50", "debug", "wsi"])
def test_extraction_backbones_gpu_match_cpu(gen, tmp_path, backbone):
    """Five 80 px patches through the extraction CLI (batch 4, a padded tail)
    with each backbone on the card and on the CPU; ``wsi`` reads them at
    coordinates of a PNG slide through ``--wsi_dir`` (ResNet-50)."""
    from PIL import Image

    from moc_tpu_torch.cli import extract_features
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.models.convert_resnet import random_resnet50_state_dict

    rng = np.random.default_rng(0)
    (tmp_path / "patches").mkdir()
    if backbone == "wsi":
        Image.fromarray(rng.integers(0, 256, (200, 240, 3), np.uint8)).save(tmp_path / "s.png")
        np.savez(tmp_path / "patches" / "s.npz",
                 coords=np.asarray([[0, 0], [80, 40], [160, 120], [200, 180], [10, 150]]))
    else:
        np.savez(tmp_path / "patches" / "s.npz",
                 imgs=rng.integers(0, 256, (5, 80, 80, 3), np.uint8))
    torch.save({"model": _small_musk()}, tmp_path / "musk.pth")
    torch.save(random_resnet50_state_dict(seed=1), tmp_path / "resnet50.pth")
    extra = {"musk": ["--backbone", "musk", "--checkpoint", str(tmp_path / "musk.pth"),
                      "--image_size", "64"],
             "resnet50": ["--backbone", "resnet50", "--checkpoint",
                          str(tmp_path / "resnet50.pth"), "--image_size", "64"],
             "debug": ["--backbone", "debug"],
             "wsi": ["--backbone", "resnet50", "--checkpoint", str(tmp_path / "resnet50.pth"),
                     "--image_size", "64", "--wsi_dir", str(tmp_path), "--wsi_ext", ".png",
                     "--patch_size", "80"]}[backbone]
    feats = {}
    for device in ("cuda", "cpu"):
        before = flash_fwd_cuda.launches
        assert extract_features.main([
            "--patch_dir", str(tmp_path / "patches"), "--out_dir", str(tmp_path / device),
            "--batch_size", "4", "--out_format", "pt", "--device", device, *extra]) == 0
        want = 6 if backbone == "musk" and device == "cuda" else 0  # 3 layers x 2 batches
        assert flash_fwd_cuda.launches - before == want
        feats[device] = read_bag_pt(str(tmp_path / device / "pt_files" / "s.pt")).features
    assert feats["cuda"].shape == (5, {"musk": 64, "debug": 512}.get(backbone, 1024))
    np.testing.assert_allclose(feats["cuda"], feats["cpu"], atol=1e-4)


# ------------------------------------------------------------------ MIL heads

MIL_HEADS = ["clam_sb", "clam_mb", "abmil", "mil", "transmil", "chief", "titan"]


def _mil_batch(n_pad=1024, counts=(1024, 700, 5), dim=512, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(len(counts), n_pad, dim)).astype(np.float32)
    valid = np.zeros((len(counts), n_pad), bool)
    for b, n in enumerate(counts):
        valid[b, :n] = True
    feats[~valid] = 0.0
    return torch.from_numpy(feats), torch.from_numpy(valid), torch.tensor([1, 0, 1])


@pytest.mark.parametrize("model_type", MIL_HEADS)
def test_mil_head_forward_and_grads_on_the_card_match_the_cpu(gen, model_type):
    """Each head's training forward (logits, instance loss) and its first
    step's gradients on the card within 1e-5 of the CPU (TF32 off for the
    call, the flags as found after it)."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.mil import MilTrainConfig, build_model, slide_losses

    cfg = MilTrainConfig(model_type=model_type, n_classes=3 if model_type == "clam_mb" else 2)
    feats, valid, labels = _mil_batch()
    labels = labels % cfg.n_classes
    out = {}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for dev in ("cuda", "cpu"):
        model, forward, init_fn = build_model(cfg)
        state = {k: v.to(dev).requires_grad_() for k, v in init_fn().items()}
        with full_f32():
            loss = slide_losses(cfg, forward, state, feats.to(dev), valid.to(dev),
                                labels.to(dev))
            grads = torch.autograd.grad(loss.sum(), list(state.values()))
        out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads])
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-5)
    scale = max(float(g.abs().max()) for g in out["cpu"][1])
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("model_type", ["clam_sb", "transmil"])
def test_mil_train_fold_epoch_on_the_card_matches_the_cpu(gen, tmp_path, model_type):
    """One ``train_fold`` epoch (dropout off, one initial state) on the card
    and on the CPU: the per-step losses within 1e-5, the val AUC equal."""
    from moc_tpu_torch.data import BagLoader, SlideTable, prefetch_to_device
    from moc_tpu_torch.data.bags import write_bag_pt
    from moc_tpu_torch.train.mil import MilTrainConfig, build_model, train_fold

    rng = np.random.default_rng(1)
    rows = []
    for i in range(10):
        n = int(rng.integers(300, 900))
        write_bag_pt(str(tmp_path / "pt_files" / f"s{i}.pt"),
                     (rng.normal(size=(n, 512)) + 0.3 * (i % 2)).astype(np.float32))
        rows.append({"slide_id": f"s{i}", "label": str(i % 2)})
    table = SlideTable.from_rows(rows, {"0": 0, "1": 1})
    parts = {"train": [f"s{i}" for i in range(6)], "val": ["s6", "s7"], "test": ["s8", "s9"]}
    cfg = MilTrainConfig(model_type=model_type, max_epochs=1, steps_per_epoch=6, lr=1e-4)
    init = build_model(cfg)[2]()
    res = {}
    for dev in ("cuda", "cpu"):
        loaders = {k: (lambda ids=ids, dev=dev: prefetch_to_device(
            BagLoader(table.subset_by_slide_ids(ids), str(tmp_path)).stream_batches(
                batch_size=1, pin_memory=dev == "cuda"), dev)) for k, ids in parts.items()}
        res[dev] = train_fold(loaders, cfg, init_params=init, dropout=False, device=dev)
    np.testing.assert_allclose(res["cuda"].step_losses, res["cpu"].step_losses, rtol=1e-5,
                               atol=1e-5)
    assert res["cuda"].epoch_val_auc == res["cpu"].epoch_val_auc


def test_mil_fused_on_the_card_matches_the_cpu(gen):
    """Two folds of ``run_mil_folds_fused`` (TransMIL, stacked parameters,
    grouped convolutions folded per fold) on the card and on the CPU."""
    from moc_tpu_torch.moc.sweep import StackedEpisode
    from moc_tpu_torch.train.mil import MilTrainConfig
    from moc_tpu_torch.train.mil_fused import run_mil_folds_fused

    rng = np.random.default_rng(2)

    def split(rows):
        feats = rng.normal(size=(2, rows, 512, 512)).astype(np.float32)
        mask = np.ones((2, rows, 512), bool)
        mask[:, :, 400:] = False
        labels = np.tile(np.arange(rows) % 2, (2, 1)).astype(np.int32)
        feats[..., 0] += labels[..., None]
        return feats, mask, labels

    ep = StackedEpisode(*split(4), *split(4), *split(4))
    cfg = MilTrainConfig(model_type="transmil", max_epochs=2, steps_per_epoch=4)
    res = {dev: run_mil_folds_fused(ep, cfg, device=dev, dropout=False) for dev in ("cuda", "cpu")}
    torch.testing.assert_close(res["cuda"].losses.cpu(), res["cpu"].losses, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(res["cuda"].val_auc.cpu(), res["cpu"].val_auc)


# ----------------------------------------- ViLa, the adapters, LoRA and accum

def _rel_max(got, want) -> float:
    return float((got.cpu() - want.cpu()).abs().max() / want.cpu().abs().max().clamp(min=1e-30))


ADAPTERS = ("clip", "tip", "moe", "amu", "zero_shot")


def _adapter(name: str, d: int, c: int, g: torch.Generator):
    from moc_tpu_torch.models import adapters as ad

    cfg = ad.AdapterConfig(c_in=d, n_classes=c, topj=10)
    return {"clip": lambda: ad.ClipAdapter(cfg, g), "tip": lambda: ad.TipAdapter(cfg, generator=g),
            "moe": lambda: ad.MoEClipAdapter(cfg, 4, True, True, generator=g),
            "amu": lambda: ad.AMUAdapter(cfg, c_in_aux=d, aux_ratio=0.2,
                                         uncertainty_type="entropy", generator=g),
            "zero_shot": lambda: None}[name]()


@pytest.mark.parametrize("name", ADAPTERS)
def test_adapter_on_the_card_matches_the_cpu_through_k1(gen, name):
    """Each adapter's pooled output and gradients on the card within 1e-5 of
    the CPU, K1's column entry launched once a ``topj_pooling`` (twice for
    AMU) in the forward; the backward launches nothing."""
    from moc_tpu_torch.models import adapters as ad
    from moc_tpu_torch.models.layers import full_f32

    n, d, c = 4096, 128, 2
    cpu = torch.Generator().manual_seed(1)
    feats = torch.randn(n, d, generator=cpu)
    valid = torch.arange(n) < 3000
    clf = torch.nn.functional.normalize(torch.randn(d, c, generator=cpu), dim=0)
    module = _adapter(name, d, c, torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        m = None if module is None else __import__("copy").deepcopy(module).to(dev)
        x = feats.to(dev).detach().clone().requires_grad_()
        before = topk_kernel.col_topk_threshold_mask_cuda.launches
        with full_f32():
            if name == "zero_shot":
                y = ad.zero_shot_pooled(x, valid.to(dev), clf.to(dev))
            elif name == "amu":
                y = m(x, valid.to(dev), x * 0.5, clf.to(dev))
            else:
                y = m(x, valid.to(dev), clf.to(dev))
            ys = y if isinstance(y, tuple) else (y,)
            fwd = topk_kernel.col_topk_threshold_mask_cuda.launches - before
            sum((t * (i + 1)).sum() for i, t in enumerate(ys)).backward()
        assert topk_kernel.col_topk_threshold_mask_cuda.launches - before == fwd
        params = [] if m is None else [p.grad for p in m.parameters()]
        out[dev] = ([t.detach().cpu() for t in ys], [x.grad.cpu()] + [g.cpu() for g in params],
                    fwd)
    assert out["cuda"][2] == (2 if name == "amu" else 1) and out["cpu"][2] == 0
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert _rel_max(got, want) <= 1e-5
    scale = max(float(g.abs().max()) for g in out["cpu"][1])
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert float((got - want).abs().max()) <= 1e-5 * scale


def _lora_classifier(attn_impl: str, experts: int = 1, layers: int = 2, image: int = 64):
    from moc_tpu_torch.models.lora import PatchClassifier, init_patch_classifier

    m = PatchClassifier(image, 16, 128, layers, 2, 2, lora_rank=4, lora_experts=experts,
                        attn_impl=attn_impl)
    init_patch_classifier(m, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # B and the router start at zero: draw them so LoRA matters
        for n, p in m.named_parameters():
            if n.rsplit(".", 1)[-1].startswith(("lora_b", "lora_moe_b", "lora_router")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return m


def test_lora_flash_trunk_trains_through_k2_k3_k4(gen):
    """The LoRA trunk with ``attn_impl="flash"`` against the dense trunk on
    the card, one state: logits within 1e-5 of the largest |logit| and every
    trainable gradient within 1e-5 of the largest |grad| (the f32 K2-K4
    limits), with K2, K3 and K4 each launched once a layer."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.models.lora import lora_optimizer

    images = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(2)).cuda()
    out = {}
    for impl in ("dense", "flash"):
        m = _lora_classifier(impl).cuda()
        lora_optimizer(m, 1e-3, ("head",))
        counts = [f.launches for f in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)]
        with full_f32():
            y = m(images)
            (y * torch.tensor([1.0, -2.0], device="cuda")).sum().backward()
        counts = [f.launches - c for f, c in zip((flash_fwd_cuda, flash_bwd_dq_cuda,
                                                   flash_bwd_dkv_cuda), counts)]
        out[impl] = (y.detach(), [p.grad for p in m.parameters() if p.requires_grad], counts)
    assert out["dense"][2] == [0, 0, 0] and out["flash"][2] == [2, 2, 2]
    assert _rel_max(out["flash"][0], out["dense"][0]) <= F32_FWD_MAX_REL
    scale = max(float(g.abs().max()) for g in out["dense"][1])
    for got, want in zip(out["flash"][1], out["dense"][1]):
        assert float((got - want).abs().max()) <= F32_BWD_MAX_REL * scale


def test_lora_flash_trunk_in_bf16_trains_through_the_bf16_kernels(gen):
    """Both trunks cast to bf16 from one state: the flash trunk's forward and
    backward launch K2, K3 and K4 once a layer each, and its logits and
    trainable gradients are held against the bf16 dense trunk's at the bf16
    K2-K4 limits (largest |diff| within 2e-2 of the largest value, mean
    |diff| within 1% of the mean)."""
    from moc_tpu_torch.models.lora import lora_optimizer

    images = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    out = {}
    for impl in ("dense", "flash"):
        m = _lora_classifier(impl).to("cuda", torch.bfloat16)
        lora_optimizer(m, 1e-3, ("head",))
        counts = [f.launches for f in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)]
        y = m(images.to("cuda", torch.bfloat16))
        (y.float() * torch.tensor([1.0, -2.0], device="cuda")).sum().backward()
        counts = [f.launches - c for f, c in zip((flash_fwd_cuda, flash_bwd_dq_cuda,
                                                   flash_bwd_dkv_cuda), counts)]
        grads = torch.cat([p.grad.float().flatten() for p in m.parameters() if p.requires_grad])
        out[impl] = (y.detach().float(), grads, counts)
    assert out["dense"][2] == [0, 0, 0] and out["flash"][2] == [2, 2, 2]
    for i, tol in ((0, K2_TOL[torch.bfloat16]), (1, BWD_TOL[torch.bfloat16])):
        got, want = out["flash"][i], out["dense"][i]
        assert bool(torch.isfinite(got).all())
        assert _rel_max(got, want) <= tol
        assert float((got - want).abs().mean()) <= BF16_MEAN_REL * float(want.abs().mean())


@pytest.mark.parametrize("experts", [1, 3])
def test_lora_step_on_the_card_matches_the_cpu(gen, experts):
    """One slide's streamed loss (queue pooling, router balance loss) and
    its gradients on the card within 1e-5 of the CPU; at init the router's
    top-1 is expert 0 on both."""
    from moc_tpu_torch.cli.lora_finetune import make_encode
    from moc_tpu_torch.models.layers import full_f32, softmax_cross_entropy
    from moc_tpu_torch.models.lora import lora_optimizer
    from moc_tpu_torch.train.lora_finetune import LoraFinetuneConfig, streamed_slide_logits

    cfg = LoraFinetuneConfig(queue_size=4, minibatch=4, balance_coef=0.01 if experts > 1 else 0)
    images = torch.rand((8, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    valid = torch.arange(8) < 7
    base = _lora_classifier("dense", experts)
    out = {}
    for dev in ("cpu", "cuda"):
        m = __import__("copy").deepcopy(base).to(dev)
        lora_optimizer(m, 1e-3, ("head",))
        with full_f32():
            res = streamed_slide_logits(make_encode(m, cfg.balance_coef), images.to(dev),
                                        valid.to(dev), cfg, with_aux=cfg.balance_coef > 0)
            logits, bal = res if cfg.balance_coef > 0 else (res, 0.0)
            loss = softmax_cross_entropy(logits[None], torch.tensor([1], device=dev))[0] \
                + cfg.balance_coef * bal
            loss.backward()
        out[dev] = (loss.detach().cpu(), [p.grad.cpu() for p in m.parameters() if p.requires_grad])
    assert abs(float(out["cuda"][0] - out["cpu"][0])) <= 1e-5 * max(1.0, abs(float(out["cpu"][0])))
    scale = max(float(g.abs().max()) for g in out["cpu"][1])
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        assert float((got - want).abs().max()) <= 1e-5 * scale
    if experts > 1:
        from moc_tpu_torch.models.lora import PatchClassifier, init_patch_classifier

        m = init_patch_classifier(PatchClassifier(64, 16, 128, 2, 2, 2, 4, experts),
                                  torch.Generator().manual_seed(0)).cuda()
        gates: list = []
        with torch.no_grad():
            m(images[:4].cuda(), gates)
        assert all(bool((torch.argmax(g, -1) == 0).all()) for g in gates)


def test_vila_on_the_card_matches_the_cpu(gen):
    """ViLa's first-step loss and gradients on the card against the CPU (a
    narrow text tower, dual-scale bags with padding): in float64 within 1e-9
    of the largest |grad|; in float32 no farther from the float64 reference
    than 4x the CPU's float32, or within 1e-5."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.models.vila import PromptConstants, PromptTensors, ViLaMIL, VilaConfig
    from moc_tpu_torch.train.vila import vila_loss
    from moc_tpu_torch.data.vila_data import DualScaleBag
    from moc_tpu_torch.zeroshot.text_tower import TextConfig

    text = TextConfig(width=128, heads=2, layers=2, output_dim=64)
    cfg = VilaConfig(n_classes=2, input_size=64, text=text)
    rng = np.random.default_rng(0)
    prompts = PromptConstants(rng.normal(size=(4, 1, 128)).astype(np.float32) * 0.02,
                              rng.normal(size=(4, 111, 128)).astype(np.float32) * 0.02,
                              np.array([20, 25, 21, 30]))
    bag = DualScaleBag(torch.randn(512, 64), torch.arange(512) < 400, torch.randn(256, 64),
                       torch.arange(256) < 256, torch.tensor(1))
    base = ViLaMIL(cfg, torch.Generator().manual_seed(0))
    out = {}
    for dtype in (torch.float64, torch.float32):
        for dev in ("cpu", "cuda"):
            m = __import__("copy").deepcopy(base).to(device=dev, dtype=dtype)
            pt = PromptTensors.of(prompts, dev)
            pt.token_prefix, pt.token_suffix = (pt.token_prefix.to(dtype),
                                                pt.token_suffix.to(dtype))
            b = bag.to(dev)
            b.feats_s, b.feats_l = b.feats_s.to(dtype), b.feats_l.to(dtype)
            with full_f32():
                loss = vila_loss(m, b, pt)
                loss.backward()
            out[dev, dtype] = (loss.detach().cpu().double(),
                               [p.grad.cpu().double() for p in m.parameters()])
    ref = out["cpu", torch.float64]
    scale = max(float(g.abs().max()) for g in ref[1])

    def err(run):
        return max(float((a - b).abs().max()) for a, b in zip(run[1], ref[1]))

    # float64: the same code on both devices agrees far past f32's rounding
    assert abs(float(out["cuda", torch.float64][0] - ref[0])) <= 1e-9 * max(1.0, abs(float(ref[0])))
    assert err(out["cuda", torch.float64]) <= 1e-9 * scale
    # float32: the card no farther from the float64 reference than 4x the
    # CPU's float32 (sums of cancelling terms keep ~1e-4 of rounding on either)
    assert err(out["cuda", torch.float32]) <= max(1e-5 * scale, 4 * err(out["cpu", torch.float32]))


@pytest.mark.parametrize("remat", [True, False])
def test_streaming_attention_pool_on_the_card_matches_the_cpu(gen, remat):
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.accum import chunk_bag, streaming_attention_pool

    cpu = torch.Generator().manual_seed(0)
    x = torch.randn(5000, 64, generator=cpu)
    valid = torch.arange(5000) < 4321
    w0, v0 = torch.randn(64, 32, generator=cpu) * 0.2, torch.randn(32, generator=cpu)
    out = {}
    for dev in ("cpu", "cuda"):
        w = w0.to(dev).detach().clone().requires_grad_()
        v = v0.to(dev).detach().clone().requires_grad_()
        with full_f32():
            pooled, lse = streaming_attention_pool(lambda t: torch.tanh(t @ w), lambda h: h @ v,
                                                   *chunk_bag(x.to(dev), valid.to(dev), 512),
                                                   remat=remat)
            (pooled.sum() + lse).backward()
        out[dev] = [t.detach().cpu() for t in (pooled, lse, w.grad, v.grad)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert _rel_max(got, want) <= 1e-5


# ---------------------------------------- the encoder stack's model half (MoE,
# dilated attention, xPos, the relative bias, remat, the bf16-parameter recipe,
# MUSK's contrastive step, the decoder, the captioner and RetNet)

def _card_and_cpu(model, forward):
    """``forward(model, device) -> (out, loss)`` on copies of ``model`` on the
    card and the CPU, TF32 off: (out, grads) of each."""
    import copy

    from moc_tpu_torch.models.layers import full_f32

    runs = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        with full_f32():
            out, loss = forward(m, dev)
            loss.backward()
        runs[dev] = (out.detach().float().cpu(),
                     {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None})
    return runs["cuda"], runs["cpu"]


def _hold(card, cpu, skip=("k_proj.bias",)):
    """Outputs within 1e-5 of the largest |out|, gradients within 1e-5 of the
    largest |grad| (a key bias's, rounding noise under a softmax, left out)."""
    assert _rel_max(card[0], cpu[0]) <= 1e-5
    names = [n for n in cpu[1] if not n.endswith(skip)]
    scale = max(float(cpu[1][n].abs().max()) for n in names)
    for n in names:
        assert float((card[1][n] - cpu[1][n]).abs().max()) <= 1e-5 * scale, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["aligned", "pad_correction"])
def test_dilated_flash_route_matches_plain_route(gen, dtype, case):
    """``dilated_attention`` on K2-K4 against ``use_flash=False`` in f32 on
    the same inputs: f32 within 1e-5 of the largest |out| and |grad|, bf16
    within 2e-2 and a 1% mean; K2 once a branch, K3/K4 once a branch
    without a pad correction."""
    import dataclasses

    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.parallel.dilated import DilatedConfig, dilated_attention

    length, ratios = (1024, (1, 2, 4)) if case == "aligned" else (1000, (1, 2, 6))
    cfg = DilatedConfig((256, 512, 1024), ratios)
    q, k, v = (torch.randn((2, length, 12, 64), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    do = torch.randn((2, length, 768), generator=gen, device="cuda")
    runs = {}
    for flash in (True, False):
        leaves = [(t if flash else t.float()).detach().clone().requires_grad_(True)
                  for t in (q, k, v)]
        counts = [f.launches for f in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)]
        with full_f32():
            out = dilated_attention(*leaves, dataclasses.replace(cfg, use_flash=flash))
            out.backward(do)
        counts = [f.launches - c for f, c in zip((flash_fwd_cuda, flash_bwd_dq_cuda,
                                                   flash_bwd_dkv_cuda), counts)]
        runs[flash] = (out.detach(), [t.grad.float() for t in leaves], counts)
    bwd = 3 if case == "aligned" else 0
    assert runs[True][2] == [3, bwd, bwd] and runs[False][2] == [0, 0, 0]
    lim = (F32_FWD_MAX_REL, F32_BWD_MAX_REL) if dtype == torch.float32 else (2e-2, 2e-2)
    assert _rel_max(runs[True][0], runs[False][0]) <= lim[0]
    scale = max(float(g.abs().max()) for g in runs[False][1])
    for got, want in zip(runs[True][1], runs[False][1]):
        assert float((got - want).abs().max()) <= lim[1] * scale
    _assert_mean_close(runs[True][1], runs[False][1], dtype)


@pytest.mark.parametrize("variant", ["xpos", "rel_pos", "remat", "moe", "dilated"])
def test_encoder_option_on_the_card_matches_the_cpu(gen, variant):
    """A 2-layer encoder with each option, the card against the CPU from one
    state dict: forward and gradients within 1e-5 of the largest."""
    import dataclasses

    from moc_tpu_torch.nn.encoder import Encoder, EncoderConfig, init_like_flax
    from moc_tpu_torch.parallel.dilated import DilatedConfig
    from moc_tpu_torch.parallel.moe import MoEConfig

    kw = {"xpos": dict(xpos=True), "rel_pos": dict(rel_pos_buckets=32, max_rel_pos=64),
          "remat": dict(remat=True), "moe": dict(moe_freq=2, moe=MoEConfig(n_experts=4)),
          "dilated": dict(dilated=DilatedConfig((64, 128, 256), (1, 2, 4)))}[variant]
    cfg = dataclasses.replace(EncoderConfig(embed_dim=128, ffn_dim=256, layers=2, heads=2), **kw)
    model = init_like_flax(Encoder(cfg), torch.Generator().manual_seed(1))
    x = torch.randn((2, 256, 128), generator=torch.Generator().manual_seed(2))
    mask = None
    if variant in ("rel_pos", "moe"):
        mask = torch.zeros((2, 256), dtype=torch.bool)
        mask[1, 200:] = True
    keep = 1.0 if mask is None else (~mask)[..., None].float()

    def forward(m, dev):
        out, aux = m(x.to(dev), None if mask is None else mask.to(dev))
        out = out * (keep if isinstance(keep, float) else keep.to(dev))
        return out, out.square().mean() + aux

    _hold(*_card_and_cpu(model, forward))


@pytest.mark.parametrize("tier", ["f32", "bf16_compute"])
def test_bf16_parameter_step_on_the_card_matches_the_cpu(gen, tier):
    """Two steps of the bf16-parameter recipe with MoE from one state on the
    card and the CPU: losses within 1e-4 (f32 compute) or 5e-3 (bf16), the
    storage copy its master rounded to nearest, bit for bit."""
    from moc_tpu_torch.cli import pretrain
    from moc_tpu_torch.train.pretrain import MaskedTokenModel, run_pretrain

    argv = ["--batch", "2", "--seq_len", "128", "--layers", "2", "--embed_dim", "128",
            "--ffn_dim", "256", "--heads", "2", "--vocab", "256", "--moe_experts", "4",
            "--param_dtype", "bfloat16"]
    if tier == "bf16_compute":
        argv += ["--compute_dtype", "bfloat16"]
    args = pretrain.get_args(argv)
    cfg = pretrain.build_config(args)
    state = MaskedTokenModel(cfg).init_parameters(torch.Generator().manual_seed(0)).state_dict()
    losses = {}
    for dev in ("cuda", "cpu"):
        model, opt, losses[dev] = run_pretrain(cfg, pretrain.make_data_fn(args), total_steps=2,
                                               device=dev, state_dict=state)
        masters = opt.master_state_dict(model)
        for name, p in model.state_dict().items():
            assert torch.equal(p, masters[name].to(p.dtype)), name
    tol = 1e-4 if tier == "f32" else 5e-3
    assert max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"])) <= tol


def test_musk_contrastive_step_on_the_card_matches_the_cpu(gen):
    """A 2-layer MUSK of width 128: the contrastive loss and its gradients on
    the card against the CPU (padded texts as segments into K2-K4), and one
    ``make_musk_contrastive_step`` launching K2, K3 and K4 once a layer and
    tower."""
    from moc_tpu_torch.models.musk import MUSK, MuskConfig
    from moc_tpu_torch.nn.encoder import EncoderConfig
    from moc_tpu_torch.train.pretrain import clip_contrastive_loss, make_musk_contrastive_step

    cfg = MuskConfig(image_size=32, patch_size=16, vocab_size=120, embed_dim=128, out_dim=64,
                     encoder=EncoderConfig(embed_dim=128, ffn_dim=256, layers=2, heads=2,
                                           multiway=True))
    torch.manual_seed(0)
    model = MUSK(cfg)
    g = torch.Generator().manual_seed(3)
    images = torch.randn((4, 32, 32, 3), generator=g)
    ids = torch.randint(0, 120, (4, 12), generator=g)
    pad = torch.zeros((4, 12), dtype=torch.bool)
    pad[1, 7:] = pad[3, 4:] = True

    def forward(m, dev):
        v, t, s = m(images.to(dev), ids.to(dev), text_padding_mask=pad.to(dev))
        return torch.cat([v, t]), clip_contrastive_loss(v, t, s)

    _hold(*_card_and_cpu(model, forward), skip=("k_proj.A.bias", "k_proj.B.bias"))
    card = model.cuda()
    step = make_musk_contrastive_step(card, torch.optim.Adam(card.parameters(), lr=1e-4))
    counts = [f.launches for f in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)]
    loss = step(images.cuda(), ids.cuda(), pad.cuda())
    counts = [f.launches - c for f, c in zip((flash_fwd_cuda, flash_bwd_dq_cuda,
                                               flash_bwd_dkv_cuda), counts)]
    assert counts == [4, 4, 4] and bool(torch.isfinite(loss))


def test_captioner_and_retnet_on_the_card_match_the_cpu(gen):
    """A 2-layer captioner: greedy and beam ids equal on the card and the CPU,
    teacher-forced logits within 1e-5 of the largest, no K2-K4 launch;
    RetNet's parallel form on the card against the CPU within 1e-5 and its
    chunkwise form against the recurrent within the JAX package's 2e-3."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.nn.encoder import init_like_flax
    from moc_tpu_torch.nn.retnet import RetNetConfig, RetNetDecoder
    from moc_tpu_torch.zeroshot.captioner import CaptionerConfig, CoCaCaptioner, generate_caption

    cap = init_like_flax(CoCaCaptioner(CaptionerConfig(vocab_size=300, width=64, layers=2,
                                                       heads=4, eot_id=299)),
                         torch.Generator().manual_seed(4))
    caption = torch.randn((3, 16, 64), generator=torch.Generator().manual_seed(5))
    counts = [f.launches for f in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)]
    ids = {}
    with full_f32():
        for dev in ("cuda", "cpu"):
            cap.to(dev)
            ids[dev] = [generate_caption(cap, caption.to(dev), seq_len=12, mode=m).cpu()
                        for m in ("greedy", "beam")]
            with torch.no_grad():
                ids[dev].append(cap(ids[dev][0].to(dev), caption.to(dev)).cpu())
    assert [f.launches for f in (flash_fwd_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)] == counts
    assert torch.equal(ids["cuda"][0], ids["cpu"][0]) and torch.equal(ids["cuda"][1],
                                                                      ids["cpu"][1])
    assert _rel_max(ids["cuda"][2], ids["cpu"][2]) <= 1e-5
    ret = init_like_flax(RetNetDecoder(RetNetConfig(embed_dim=64, value_dim=128, heads=4,
                                                    ffn_dim=128, layers=2)),
                         torch.Generator().manual_seed(6))
    x = torch.randn((2, 128, 64), generator=torch.Generator().manual_seed(7))
    with torch.no_grad(), full_f32():
        want = ret(x)[0]
        ret.cuda()
        par, rec, chunk = (ret(x.cuda(), mode=m, chunk_size=32)[0].cpu()
                           for m in ("parallel", "recurrent", "chunkwise"))
    assert _rel_max(par, want) <= 1e-5 and _rel_max(chunk, rec) <= 2e-3
