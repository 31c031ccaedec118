"""Prompt banks (a copy of ``moc_tpu/zeroshot/prompts.py``; plain Python).

Schema of a bank file (the vendored ``assets/prompts/*.json``):

    {"0": {"classnames": {"<label>": ["alias 1", ...], ...},
           "templates":  ["a photomicrograph showing CLASSNAME.", ...]}}

``label_map`` orders labels into class indices; templates hold the literal
``CLASSNAME`` placeholder. A bank expands to, per class, the cross product
of aliases × templates.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class PromptBank:
    """Ordered per-class alias lists + shared templates."""

    classnames: tuple[tuple[str, ...], ...]  # [C][n_aliases]
    templates: tuple[str, ...]
    labels: tuple[str, ...]  # label string per class index

    @property
    def n_classes(self) -> int:
        return len(self.classnames)

    def texts_for_class(self, c: int) -> list[list[str]]:
        """Per alias of class ``c``, the templates with ``CLASSNAME`` filled."""
        return [[t.replace("CLASSNAME", alias) for t in self.templates]
                for alias in self.classnames[c]]


def _labels_in_order(label_map: Mapping[str, int]) -> tuple[str, ...]:
    idx_to_label = {v: k for k, v in label_map.items()}
    return tuple(idx_to_label[i] for i in range(len(idx_to_label)))


def load_prompt_bank(path: str, label_map: Mapping[str, int], key: str = "0") -> PromptBank:
    """Load a prompt JSON, ordering classes by ``label_map`` index."""
    with open(path) as f:
        bank = json.load(f)[key]
    labels = _labels_in_order(label_map)
    return PromptBank(classnames=tuple(tuple(bank["classnames"][lab]) for lab in labels),
                      templates=tuple(bank["templates"]), labels=labels)


def make_prompt_bank(classnames: Mapping[str, Sequence[str]], templates: Sequence[str],
                     label_map: Mapping[str, int]) -> PromptBank:
    labels = _labels_in_order(label_map)
    return PromptBank(classnames=tuple(tuple(classnames[lab]) for lab in labels),
                      templates=tuple(templates), labels=labels)


def save_prompt_bank(path: str, bank: PromptBank, key: str = "0") -> None:
    payload = {key: {"classnames": {lab: list(names)
                                    for lab, names in zip(bank.labels, bank.classnames)},
                     "templates": list(bank.templates)}}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
