"""Kernel K1 on the GPU against its plain PyTorch version, bit for bit.

Needs an NVIDIA GPU and nvcc: every test here carries the ``cuda`` marker and
skips without a card. This file imports no JAX, so the card's host runs it
without the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from moc_tpu_torch.ops import (NEG_INF, masked_col_topk_mask, threshold_topk_mask,
                               topk_threshold_mask, topk_kernel)

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
