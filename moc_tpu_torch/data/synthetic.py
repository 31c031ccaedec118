"""Deterministic synthetic WSI corpora, bags and oracle weights (numpy copy
of the generators in ``moc_tpu/data/synthetic.py``).

Each class has a unit "concept" direction; tumor patches of a class-c slide
lean toward concept c, background patches toward shared normal-tissue
concepts. The numpy ``default_rng`` calls are the JAX package's own, so both
packages make identical bags, weights and splits from one seed.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from moc_tpu_torch.data.bags import write_bag_pt
from moc_tpu_torch.data.splits import generate_fewshot_splits, write_split_csv
from moc_tpu_torch.data.table import SlideTable


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


def corpus_split_path(root: str, shot: int, fold: int) -> str:
    return os.path.join(root, "splits", f"{shot}shots", f"splits_{fold}.csv")


def make_synthetic_corpus(root: str, cfg: SyntheticWSIConfig = SyntheticWSIConfig(), *,
                          shots: tuple[int, ...] = (1, 2), n_folds: int = 2,
                          val_per_class: int = 2, test_per_class: int = 4) -> dict:
    """Write a corpus under ``root`` and return its paths and oracle weights:

      root/dataset.csv                          case_id, slide_id, label
      root/features/pt_files/<slide>.pt         f32 features [N, D]
      root/splits/<shot>shots/splits_<fold>.csv column-style splits

    The bags are the arrays the JAX package writes to its ``h5_files``."""
    rng = np.random.default_rng(cfg.seed)
    data_dir = os.path.join(root, "features")
    rows = []
    for c in range(cfg.n_classes):
        for i in range(cfg.slides_per_class):
            slide_id = f"slide_c{c}_{i:03d}"
            feats, _ = sample_bag(cfg, c, rng)
            write_bag_pt(os.path.join(data_dir, "pt_files", f"{slide_id}.pt"), feats)
            rows.append((f"case_c{c}_{i:03d}", slide_id, str(c)))
    csv_path = os.path.join(root, "dataset.csv")
    with open(csv_path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["case_id", "slide_id", "label"])
        out.writerows(rows)

    label_dict = {str(c): c for c in range(cfg.n_classes)}
    table = SlideTable.from_csv(csv_path, label_dict)
    split_paths: dict[tuple[int, int], str] = {}
    for shot in shots:
        splits = generate_fewshot_splits(table, shot=shot, n_splits=n_folds,
                                         val_num=[val_per_class] * cfg.n_classes,
                                         test_num=[test_per_class] * cfg.n_classes,
                                         seed=cfg.seed + shot)
        for fold, split in enumerate(splits):
            path = corpus_split_path(root, shot, fold)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_split_csv(path, split)
            split_paths[(shot, fold)] = path

    w, w_ext = zero_shot_weights(cfg)
    return {"csv_path": csv_path, "data_dir": data_dir, "label_dict": label_dict,
            "split_paths": split_paths, "weights": w, "weights_ext": w_ext, "config": cfg}
