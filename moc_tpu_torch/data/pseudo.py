"""Pseudo-slide assembly: fixed-size bags drawn from labelled patch pools
(PyTorch port of ``moc_tpu/data/pseudo.py``; numpy on the host).

CLAM-style "PriSec" pseudo slides: a random number of foreground patches
mixed with normal-tissue patches on each visit (foreground count uniform in
[120, 350)), a self-merge variant that samples from the slide's own pools,
and a fixed-proportion variant; and a primary + secondary visit order
(every slide once in sequence, then ``num_secondary`` random permutations,
interleaved). The draws use numpy's ``Generator`` in the JAX package's
order, so the bags are bit-equal for the same seed. A bag is a fixed-shape
``[bag_size, D]`` float32 array: batched, it feeds the padded-bag models
with an all-True mask.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class PatchPools:
    """Per-slide labelled patch-feature pools: class name → ``[n, D]``."""

    pools: Mapping[str, np.ndarray]
    label: int


def prisec_order(n_slides: int, num_secondary: int,
                 rng: np.random.Generator) -> np.ndarray:
    """One epoch's visit order (ref ``PriSecSampler``): column-interleave the
    sequential pass with ``num_secondary`` random permutations."""
    cols = [np.arange(n_slides)]
    for _ in range(num_secondary):
        cols.append(rng.permutation(n_slides))
    return np.stack(cols, axis=1).reshape(-1)


def assemble_mixed_bag(
    fg_pool: np.ndarray,
    normal_pool: np.ndarray,
    rng: np.random.Generator,
    *,
    bag_size: int = 512,
    fg_range: tuple[int, int] = (120, 350),
) -> np.ndarray:
    """Random fg/normal mixture (ref ``collate_fn_PriSec_train_mutual_rand_
    merge`` / ``collate_fn_batch_patches``): fg count ~ U[lo, hi)."""
    lo = min(fg_range[0], max(bag_size - 1, 1))
    hi = min(fg_range[1], bag_size)
    fg_num = int(rng.integers(lo, max(hi, lo + 1)))
    normal_num = bag_size - fg_num
    fg_idx = rng.choice(len(fg_pool), fg_num, replace=len(fg_pool) < fg_num)
    nm_idx = rng.choice(len(normal_pool), normal_num,
                        replace=len(normal_pool) < normal_num)
    return np.concatenate([fg_pool[fg_idx], normal_pool[nm_idx]]).astype(np.float32)


def assemble_self_bag(pools: PatchPools, rng: np.random.Generator,
                      bag_size: int = 512) -> np.ndarray:
    """Sample ``bag_size`` patches from the union of the slide's own pools
    (ref ``collate_fn_PriSec_train_self_merge``)."""
    allp = np.concatenate(list(pools.pools.values()))
    idx = rng.choice(len(allp), bag_size, replace=len(allp) < bag_size)
    return allp[idx].astype(np.float32)


def assemble_fixed_ratio_bag(
    fg_pool: np.ndarray,
    normal_pool: np.ndarray,
    *,
    bag_size: int = 512,
    fg_proportion: float = 0.9,
) -> np.ndarray:
    """Deterministic head-of-pool mixture (ref ``collate_fn_preload_batch``)."""
    fg_num = int(bag_size * fg_proportion)
    return np.concatenate(
        [fg_pool[:fg_num], normal_pool[: bag_size - fg_num]]
    ).astype(np.float32)


def pseudo_epoch(
    slides: Sequence[PatchPools],
    rng: np.random.Generator,
    *,
    mode: str = "mixed",  # mixed | self | fixed
    bag_size: int = 512,
    num_secondary: int = 1,
    fg_key_for: Mapping[int, str] | None = None,
    normal_key: str = "normal",
):
    """Yield ``(bag [bag_size, D], label)`` for one pseudo-slide epoch."""
    order = prisec_order(len(slides), num_secondary, rng)
    for i in order:
        s = slides[int(i)]
        if mode == "self":
            yield assemble_self_bag(s, rng, bag_size), s.label
            continue
        fg_key = (fg_key_for or {}).get(s.label)
        if fg_key is None:  # default: the pool named by anything non-normal
            fg_key = next((k for k in s.pools if k != normal_key), None)
            if fg_key is None:
                raise ValueError(
                    f"no non-{normal_key!r} pool for label {s.label} "
                    f"(pools: {sorted(s.pools)})")
        if mode == "mixed":
            yield assemble_mixed_bag(s.pools[fg_key], s.pools[normal_key], rng,
                                     bag_size=bag_size), s.label
        elif mode == "fixed":
            yield assemble_fixed_ratio_bag(s.pools[fg_key], s.pools[normal_key],
                                           bag_size=bag_size), s.label
        else:
            raise ValueError(mode)
