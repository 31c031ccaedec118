"""Dataset presets the serving path needs (copied from ``moc_tpu/config.py``,
class counts and label dictionaries only)."""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class DatasetPreset:
    """Per-dataset class layout: tumor classes and the extended bank
    (tumor + normal-tissue classes)."""

    name: str
    label_dict: Mapping[str, int]
    label_dict_ext: Mapping[str, int]
    n_classes: int

    @property
    def n_ext_classes(self) -> int:
        return len(set(self.label_dict_ext.values()))


NSCLC = DatasetPreset(
    name="nsclc",
    label_dict={"LUAD": 0, "LUSC": 1},
    label_dict_ext={"LUAD": 0, "LUSC": 1, "Stroma": 2, "Inflammation": 3,
                    "Vascular": 4, "Necrosis": 5},
    n_classes=2,
)

RCC = DatasetPreset(
    name="rcc",
    label_dict={"KICH": 0, "KIRC": 1, "KIRP": 2},
    label_dict_ext={"KICH": 0, "KIRC": 1, "KIRP": 2, "Stroma": 3,
                    "Inflammation": 4, "Vascular": 5, "Necrosis": 6},
    n_classes=3,
)

PRESETS = {"nsclc": NSCLC, "rcc": RCC}
