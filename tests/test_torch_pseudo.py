"""Pseudo-slide assembly in the port against the JAX package: the same
seeded ``numpy`` generator gives bit-equal visit orders and bags in every
mode."""

import numpy as np
import pytest

from moc_tpu.data import pseudo as jpseudo
from moc_tpu_torch.data import pseudo

D = 16


def _slides(seed: int, lib):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(5):
        pools = {"normal": rng.standard_normal((int(rng.integers(3, 40)), D)).astype(np.float32)}
        pools["tumor" if i % 2 else "luad"] = rng.standard_normal(
            (int(rng.integers(2, 600)), D)).astype(np.float32)
        out.append(lib.PatchPools(pools=pools, label=i % 2))
    return out


@pytest.mark.parametrize("n,sec", [(1, 0), (7, 1), (12, 3)])
def test_prisec_order_bit_equal(n, sec):
    got = pseudo.prisec_order(n, sec, np.random.default_rng(n))
    np.testing.assert_array_equal(got, jpseudo.prisec_order(n, sec, np.random.default_rng(n)))
    assert got.shape == (n * (sec + 1),)


@pytest.mark.parametrize("bag_size,fg_range", [(512, (120, 350)), (64, (10, 200)), (1, (0, 5))])
def test_mixed_self_and_fixed_bags_bit_equal(bag_size, fg_range):
    rng = np.random.default_rng(3)
    fg, nm = rng.standard_normal((30, D)), rng.standard_normal((700, D))
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        got = pseudo.assemble_mixed_bag(fg, nm, a, bag_size=bag_size, fg_range=fg_range)
        want = jpseudo.assemble_mixed_bag(fg, nm, b, bag_size=bag_size, fg_range=fg_range)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32 and got.shape == (bag_size, D)
    s, js = _slides(1, pseudo)[1], _slides(1, jpseudo)[1]
    np.testing.assert_array_equal(pseudo.assemble_self_bag(s, a, bag_size),
                                  jpseudo.assemble_self_bag(js, b, bag_size))
    for prop in (0.9, 0.3):
        np.testing.assert_array_equal(
            pseudo.assemble_fixed_ratio_bag(fg, nm, bag_size=bag_size, fg_proportion=prop),
            jpseudo.assemble_fixed_ratio_bag(fg, nm, bag_size=bag_size, fg_proportion=prop))


@pytest.mark.parametrize("mode", ["mixed", "self", "fixed"])
@pytest.mark.parametrize("keys", [None, {0: "luad", 1: "tumor"}])
def test_pseudo_epoch_bit_equal(mode, keys):
    got = list(pseudo.pseudo_epoch(_slides(2, pseudo), np.random.default_rng(5), mode=mode,
                                   bag_size=128, num_secondary=2, fg_key_for=keys))
    want = list(jpseudo.pseudo_epoch(_slides(2, jpseudo), np.random.default_rng(5), mode=mode,
                                     bag_size=128, num_secondary=2, fg_key_for=keys))
    assert len(got) == len(want) == 15
    for (bag, label), (jbag, jlabel) in zip(got, want):
        assert label == jlabel
        np.testing.assert_array_equal(bag, jbag)


def test_pseudo_epoch_errors_match():
    slides = [pseudo.PatchPools(pools={"normal": np.zeros((4, D))}, label=0)]
    with pytest.raises(ValueError, match="no non-'normal' pool"):
        list(pseudo.pseudo_epoch(slides, np.random.default_rng(0)))
    slides = [pseudo.PatchPools(pools={"normal": np.zeros((4, D)), "t": np.ones((4, D))},
                                label=0)]
    with pytest.raises(ValueError, match="bogus"):
        list(pseudo.pseudo_epoch(slides, np.random.default_rng(0), mode="bogus"))
