"""Dataset presets (copied from ``moc_tpu/config.py``): class layouts and
where a dataset's table, bags and few-shot splits lie under ``--data_root``.

Only the ``--data_root`` copies are read; the JAX package's fallback to its
vendored tables and splits is not ported (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class DatasetPreset:
    """Per-dataset class layout: tumor classes and the extended bank
    (tumor + normal-tissue classes), and the dataset's file layout."""

    name: str
    label_dict: Mapping[str, int]
    label_dict_ext: Mapping[str, int]
    n_classes: int
    csv_name: str
    feature_dir: str  # under data_root
    splits_subdir: str  # under data_root/splits

    @property
    def n_ext_classes(self) -> int:
        return len(set(self.label_dict_ext.values()))

    def repeat_num(self, shot: int) -> int:
        """Train visits an epoch: shot × C."""
        return shot * self.n_classes

    def csv_path(self, data_root: str) -> str:
        return os.path.join(data_root, "dataset_csv", self.csv_name)

    def data_dir(self, data_root: str) -> str:
        return os.path.join(data_root, self.feature_dir)

    def split_csv(self, data_root: str, shot: int, fold: int) -> str:
        return os.path.join(data_root, "splits", self.splits_subdir, f"{shot}shots",
                            f"splits_{fold}.csv")


NSCLC = DatasetPreset(
    name="nsclc",
    label_dict={"LUAD": 0, "LUSC": 1},
    label_dict_ext={"LUAD": 0, "LUSC": 1, "Stroma": 2, "Inflammation": 3,
                    "Vascular": 4, "Necrosis": 5},
    n_classes=2,
    csv_name="nsclc.csv",
    feature_dir="data/nsclc/merge_features_conch",
    splits_subdir="nsclc_fewshot",
)

RCC = DatasetPreset(
    name="rcc",
    label_dict={"KICH": 0, "KIRC": 1, "KIRP": 2},
    label_dict_ext={"KICH": 0, "KIRC": 1, "KIRP": 2, "Stroma": 3,
                    "Inflammation": 4, "Vascular": 5, "Necrosis": 6},
    n_classes=3,
    csv_name="rcc.csv",
    feature_dir="data/rcc/merge_features_conch",
    splits_subdir="rcc_fewshot",
)

PRESETS = {"nsclc": NSCLC, "rcc": RCC}
