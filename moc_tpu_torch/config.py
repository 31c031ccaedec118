"""Dataset presets (copied from ``moc_tpu/config.py``): class layouts, prompt
banks, and where a dataset's table, bags and few-shot splits lie under
``--data_root``.

The port carries its own copy of the vendored data assets (prompt banks,
dataset tables, few-shot splits; ``moc_tpu_torch/assets/ATTRIBUTION.md``).
A preset's table and splits fall back to them when the ``--data_root`` copy
is absent, and ``DEFAULT_PROMPT_ROOT`` is the default prompt directory, so
a fresh clone plus bags and a checkpoint path is a runnable command.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
DEFAULT_PROMPT_ROOT = os.path.join(ASSETS_DIR, "prompts")


def _with_vendored_fallback(primary: str, vendored: str) -> str:
    """``primary`` when it exists, else ``vendored`` when that exists, else
    ``primary`` (so a missing file is reported under the user's path)."""
    return primary if os.path.exists(primary) else (
        vendored if os.path.exists(vendored) else primary)


@dataclasses.dataclass(frozen=True)
class DatasetPreset:
    """Per-dataset class layout: tumor classes and the extended bank
    (tumor + normal-tissue classes), their prompt banks, and the dataset's
    file layout."""

    name: str
    label_dict: Mapping[str, int]
    label_dict_ext: Mapping[str, int]
    n_classes: int
    csv_name: str
    feature_dir: str  # under data_root
    splits_subdir: str  # under data_root/splits
    prompt_file: str  # under prompt_root
    prompt_file_ext: str

    @property
    def n_ext_classes(self) -> int:
        return len(set(self.label_dict_ext.values()))

    def repeat_num(self, shot: int) -> int:
        """Train visits an epoch: shot × C."""
        return shot * self.n_classes

    def csv_path(self, data_root: str) -> str:
        return _with_vendored_fallback(
            os.path.join(data_root, "dataset_csv", self.csv_name),
            os.path.join(ASSETS_DIR, "dataset_csv", self.csv_name))

    def data_dir(self, data_root: str) -> str:
        return os.path.join(data_root, self.feature_dir)

    def split_csv(self, data_root: str, shot: int, fold: int) -> str:
        rel = os.path.join(self.splits_subdir, f"{shot}shots", f"splits_{fold}.csv")
        return _with_vendored_fallback(os.path.join(data_root, "splits", rel),
                                       os.path.join(ASSETS_DIR, "splits", rel))


NORMAL_TISSUE = {"Stroma", "Inflammation", "Vascular", "Necrosis"}

NSCLC = DatasetPreset(
    name="nsclc",
    label_dict={"LUAD": 0, "LUSC": 1},
    label_dict_ext={"LUAD": 0, "LUSC": 1, "Stroma": 2, "Inflammation": 3,
                    "Vascular": 4, "Necrosis": 5},
    n_classes=2,
    csv_name="nsclc.csv",
    feature_dir="data/nsclc/merge_features_conch",
    splits_subdir="nsclc_fewshot",
    prompt_file="nsclc_prompts_all_per_class_worse.json",
    prompt_file_ext="nsclc_prompts_w4normal.json",
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
    prompt_file="rcc_prompts_all_per_class.json",
    prompt_file_ext="rcc_prompts_w4normal.json",
)

_EBRAINS12_CLASSES = (
    "Adamantinomatous craniopharyngioma",
    "Anaplastic oligodendroglioma, IDH-mutant and 1p/19q codeleted",
    "Atypical meningioma",
    "Diffuse astrocytoma, IDH-mutant",
    "Ganglioglioma",
    "Glioblastoma, IDH-wildtype",
    "Haemangioblastoma",
    "Meningothelial meningioma",
    "Oligodendroglioma, IDH-mutant and 1p/19q codeleted",
    "Pilocytic astrocytoma",
    "Pituitary adenoma",
    "Schwannoma",
)

_EBRAINS30_CLASSES = (
    "Adamantinomatous craniopharyngioma",
    "Anaplastic astrocytoma, IDH-mutant",
    "Anaplastic astrocytoma, IDH-wildtype",
    "Anaplastic ependymoma",
    "Anaplastic meningioma",
    "Anaplastic oligodendroglioma, IDH-mutant and 1p/19q codeleted",
    "Angiomatous meningioma",
    "Atypical meningioma",
    "Diffuse astrocytoma, IDH-mutant",
    "Diffuse large B-cell lymphoma of the CNS",
    "Ependymoma",
    "Fibrous meningioma",
    "Ganglioglioma",
    "Glioblastoma, IDH-mutant",
    "Glioblastoma, IDH-wildtype",
    "Gliosarcoma",
    "Haemangioblastoma",
    "Haemangioma",
    "Haemangiopericytoma",
    "Langerhans cell histiocytosis",
    "Lipoma",
    "Medulloblastoma, non-WNT/non-SHH",
    "Meningothelial meningioma",
    "Metastatic tumours",
    "Oligodendroglioma, IDH-mutant and 1p/19q codeleted",
    "Pilocytic astrocytoma",
    "Pituitary adenoma",
    "Schwannoma",
    "Secretory meningioma",
    "Transitional meningioma",
)


def _ebrains_preset(name: str, classes: tuple[str, ...]) -> DatasetPreset:
    """An EBRAINS brain-tumour preset: the tumour classes in table order,
    then the four normal-tissue classes in sorted order in the extended bank;
    the banks are the vendored ``{name}_prompts.json`` and
    ``{name}_prompts_ext.json``."""
    label_dict = {c: i for i, c in enumerate(classes)}
    ext = dict(label_dict)
    for j, tissue in enumerate(sorted(NORMAL_TISSUE)):
        ext[tissue] = len(classes) + j
    return DatasetPreset(
        name=name,
        label_dict=label_dict,
        label_dict_ext=ext,
        n_classes=len(classes),
        csv_name=f"{name}.csv",
        feature_dir=f"data/{name}/merge_features_conch",
        splits_subdir=f"{name}_fewshot",
        prompt_file=f"{name}_prompts.json",
        prompt_file_ext=f"{name}_prompts_ext.json",
    )


EBRAINS12 = _ebrains_preset("ebrains12", _EBRAINS12_CLASSES)
EBRAINS30 = _ebrains_preset("ebrains30", _EBRAINS30_CLASSES)

PRESETS = {"nsclc": NSCLC, "rcc": RCC, "ebrains12": EBRAINS12, "ebrains30": EBRAINS30}
