"""Deterministic synthetic WSI bags and oracle weights (PyTorch-free numpy
copy of the generators in ``moc_tpu/data/synthetic.py``).

Each class has a unit "concept" direction; tumor patches of a class-c slide
lean toward concept c, background patches toward shared normal-tissue
concepts. The numpy ``default_rng`` calls are the JAX package's own, so both
packages make identical bags and weights from one seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticWSIConfig:
    n_classes: int = 2
    n_bg_concepts: int = 4  # normal-tissue concepts shared across classes
    dim: int = 512
    slides_per_class: int = 12
    min_patches: int = 600
    max_patches: int = 3000
    tumor_frac: float = 0.25  # fraction of patches carrying class signal
    signal: float = 1.2  # concept strength relative to unit noise
    seed: int = 0


def concept_directions(cfg: SyntheticWSIConfig) -> tuple[np.ndarray, np.ndarray]:
    """Orthonormal class + background concept directions ``[D, C]``, ``[D, B]``."""
    rng = np.random.default_rng(cfg.seed + 1)
    total = cfg.n_classes + cfg.n_bg_concepts
    mat = rng.normal(size=(cfg.dim, total))
    q, _ = np.linalg.qr(mat)
    return q[:, : cfg.n_classes].astype(np.float32), q[:, cfg.n_classes :].astype(np.float32)


def zero_shot_weights(cfg: SyntheticWSIConfig) -> tuple[np.ndarray, np.ndarray]:
    """Oracle classifier weights aligned with the generative concepts:
    ``(W [D, C], W_ext [D, C + n_bg])``, the synthetic analogue of the
    CONCH-derived weight matrices (tumor bank, extended bank)."""
    cls_dirs, bg_dirs = concept_directions(cfg)
    w = cls_dirs / np.linalg.norm(cls_dirs, axis=0, keepdims=True)
    w_ext = np.concatenate([w, bg_dirs], axis=1)
    return w.astype(np.float32), w_ext.astype(np.float32)


def sample_bag(cfg: SyntheticWSIConfig, label: int, rng: np.random.Generator):
    """One slide: ``(features [N, D], coords [N, 2])`` with class-c signal."""
    cls_dirs, bg_dirs = concept_directions(cfg)
    n = int(rng.integers(cfg.min_patches, cfg.max_patches + 1))
    noise = rng.normal(size=(n, cfg.dim)).astype(np.float32)
    is_tumor = rng.random(n) < cfg.tumor_frac
    bg_pick = rng.integers(0, cfg.n_bg_concepts, size=n)
    concept = np.where(
        is_tumor[:, None], cls_dirs[:, label][None, :], bg_dirs[:, bg_pick].T
    ).astype(np.float32)
    feats = noise + cfg.signal * concept * float(np.sqrt(cfg.dim))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)  # CONCH-style unit embeds
    side = int(np.ceil(np.sqrt(n)))
    grid = np.stack(np.unravel_index(np.arange(n), (side, side)), axis=1)
    coords = (grid * 256).astype(np.int32)
    return feats, coords
