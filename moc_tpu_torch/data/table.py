"""Slide tables: dataset CSV parsing, label mapping and patient grouping
(port of ``moc_tpu/data/table.py`` on the ``csv`` module instead of pandas).

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
    def from_csv(cls, csv_path: str, label_dict: Mapping[str, int], *,
                 label_col: str = "label", ignore: Sequence[str] = (),
                 filter_dict: Mapping[str, Sequence[str]] | None = None,
                 shuffle: bool = False, seed: int = 7) -> "SlideTable":
        """Read a dataset CSV with columns ``slide_id``, ``label_col`` and
        optionally ``case_id`` (default: the slide id). Every field stays a
        string, so zero-padded slide ids survive; a label missing from
        ``label_dict`` raises KeyError. The options are ``from_rows``'."""
        with open(csv_path, newline="") as f:
            return cls.from_rows(list(csv.DictReader(f)), label_dict, label_col=label_col,
                                 ignore=ignore, filter_dict=filter_dict, shuffle=shuffle,
                                 seed=seed)

    @classmethod
    def from_rows(cls, rows: Sequence[Mapping[str, str]], label_dict: Mapping[str, int], *,
                  label_col: str = "label", ignore: Sequence[str] = (),
                  filter_dict: Mapping[str, Sequence[str]] | None = None,
                  shuffle: bool = False, seed: int = 7) -> "SlideTable":
        """A table from CSV records (``csv.DictReader`` rows, every field a
        string), in the JAX package's ``SlideTable.from_frame`` order: keep
        the rows whose ``filter_dict`` columns hold one of the listed values,
        take the labels from ``label_col``, drop the labels in ``ignore``,
        map the rest through ``label_dict`` (a missing one raises KeyError),
        and with ``shuffle`` permute the rows as pandas' ``sample(frac=1,
        random_state=seed)`` does."""
        rows = list(rows)
        for key, vals in (filter_dict or {}).items():
            keep = set(vals)
            rows = [r for r in rows if r[key] in keep]
        ignored = set(ignore)
        rows = [r for r in rows if r[label_col] not in ignored]
        if shuffle:
            order = np.random.RandomState(seed).choice(len(rows), size=len(rows), replace=False)
            rows = [rows[i] for i in order]
        return cls(case_ids=tuple(r.get("case_id", r["slide_id"]) for r in rows),
                   slide_ids_=tuple(r["slide_id"] for r in rows),
                   labels_=tuple(int(label_dict[r[label_col]]) for r in rows),
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
        return self.subset_by_rows(rows)

    def subset_by_rows(self, rows: Sequence[int]) -> "SlideTable":
        """The rows ``rows``, in that order."""
        return SlideTable(tuple(self.case_ids[i] for i in rows),
                          tuple(self.slide_ids_[i] for i in rows),
                          tuple(self.labels_[i] for i in rows), self.label_dict,
                          self.num_classes)

    def patient_table(self, voting: str = "max") -> dict[str, np.ndarray]:
        """Unique patients, sorted by case id, with a voted label (``max``:
        the MIL convention; ``maj``: the mode, ties to the lower label) as
        ``{"case_id": [P], "label": [P]}``, the columns of the JAX package's
        frame."""
        groups: dict[str, list[int]] = {}
        for case, label in zip(self.case_ids, self.labels_):
            groups.setdefault(case, []).append(label)
        cases = sorted(groups)
        labels = []
        for case in cases:
            vals = np.asarray(groups[case])
            if voting == "max":
                labels.append(int(vals.max()))
            elif voting == "maj":
                uniq, counts = np.unique(vals, return_counts=True)
                labels.append(int(uniq[np.argmax(counts)]))
            else:
                raise ValueError(f"unknown patient voting {voting!r}")
        return {"case_id": np.array(cases, dtype=object), "label": np.array(labels, np.int64)}

    def summary(self) -> str:
        """``slides=N classes=C`` and one line a class present."""
        uniq, counts = np.unique(self.labels, return_counts=True)
        return "\n".join([f"slides={len(self)} classes={self.num_classes}"]
                         + [f"  class {c}: {n} slides" for c, n in zip(uniq, counts)])
