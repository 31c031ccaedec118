"""Slide tables: dataset CSV parsing and label mapping (port of
``moc_tpu/data/table.py`` on the ``csv`` module instead of pandas).

A table is pure metadata, ``(case_id, slide_id, label)`` rows with integer
labels; bag tensors come from ``moc_tpu_torch.data.loader``.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SlideTable:
    """``(case_id, slide_id, label)`` rows. ``label_dict`` maps the CSV's label
    strings to class indices; ``num_classes`` counts the distinct indices
    (several strings may share one)."""

    case_ids: tuple[str, ...]
    slide_ids_: tuple[str, ...]
    labels_: tuple[int, ...]
    label_dict: Mapping[str, int]
    num_classes: int

    @classmethod
    def from_csv(cls, csv_path: str, label_dict: Mapping[str, int]) -> "SlideTable":
        """Read a dataset CSV with columns ``slide_id``, ``label`` and
        optionally ``case_id`` (default: the slide id). Every field stays a
        string, so zero-padded slide ids survive; a label missing from
        ``label_dict`` raises KeyError."""
        with open(csv_path, newline="") as f:
            return cls.from_rows(list(csv.DictReader(f)), label_dict)

    @classmethod
    def from_rows(cls, rows: Sequence[Mapping[str, str]],
                  label_dict: Mapping[str, int]) -> "SlideTable":
        """A table from CSV records (``csv.DictReader`` rows, every field a
        string) with ``slide_id``, ``label`` and optionally ``case_id``: what
        the JAX package's ``SlideTable.from_frame`` keeps of a frame without
        its filter, ignore and shuffle options. A label missing from
        ``label_dict`` raises KeyError."""
        rows = list(rows)
        return cls(case_ids=tuple(r.get("case_id", r["slide_id"]) for r in rows),
                   slide_ids_=tuple(r["slide_id"] for r in rows),
                   labels_=tuple(int(label_dict[r["label"]]) for r in rows),
                   label_dict=dict(label_dict),
                   num_classes=len(set(label_dict.values())))

    def __len__(self) -> int:
        return len(self.slide_ids_)

    @property
    def slide_ids(self) -> np.ndarray:
        return np.array(self.slide_ids_, dtype=object)

    @property
    def labels(self) -> np.ndarray:
        return np.array(self.labels_, dtype=np.int64)

    def class_indices(self, cls_idx: int) -> np.ndarray:
        """Row indices of the slides of class ``cls_idx``."""
        return np.where(self.labels == cls_idx)[0]

    def label_of(self, slide_id: str) -> int:
        cache = self.__dict__.get("_label_cache")
        if cache is None:  # built once: a scan per call would make read_all quadratic
            cache = dict(zip(self.slide_ids_, self.labels_))
            self.__dict__["_label_cache"] = cache
        return cache[slide_id]

    def subset_by_slide_ids(self, slide_ids: Sequence[str]) -> "SlideTable":
        """The rows whose slide id is in ``slide_ids``, in table order."""
        keep = set(slide_ids)
        rows = [i for i, s in enumerate(self.slide_ids_) if s in keep]
        return SlideTable(tuple(self.case_ids[i] for i in rows),
                          tuple(self.slide_ids_[i] for i in rows),
                          tuple(self.labels_[i] for i in rows), self.label_dict,
                          self.num_classes)
