"""Split files and seeded split generation, full and few-shot (port of
``moc_tpu/data/splits.py`` on the ``csv`` module instead of pandas).

A ``Split`` holds slide-id lists; the consumer resolves them against a
``SlideTable``. The generator makes the same numpy ``default_rng`` calls as
the JAX package, so both write the same splits from one seed.
"""

from __future__ import annotations

import csv
import dataclasses
import itertools
from typing import Sequence

import numpy as np

from moc_tpu_torch.data.table import SlideTable

_KEYS = ("train", "val", "test")
_BOOL_WORDS = {"True", "False", "TRUE", "FALSE", "true", "false"}


@dataclasses.dataclass(frozen=True)
class Split:
    train: tuple[str, ...]
    val: tuple[str, ...]
    test: tuple[str, ...]

    def check_disjoint(self) -> None:
        """No slide in two parts; raises ValueError otherwise."""
        for a, b in itertools.combinations(_KEYS, 2):
            if set(getattr(self, a)) & set(getattr(self, b)):
                raise ValueError(f"{a}/{b} overlap")


def read_split_csv(path: str) -> Split:
    """Read either split style:

    * column style: columns ``train``/``val``/``test`` of slide ids, ragged
      (empty cells past each column's end);
    * boolean style: the first column holds the slide ids, and boolean
      ``train``/``val``/``test`` columns mark each slide's part.
    """
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    col = {name: i for i, name in enumerate(header)}
    if set(_KEYS) <= set(col) and rows and all(r[col["train"]] in _BOOL_WORDS for r in rows):
        return Split(*(tuple(r[0] for r in rows if r[col[k]].lower() == "true") for k in _KEYS))
    return Split(*(tuple(r[col[k]] for r in rows if k in col and col[k] < len(r)
                         and r[col[k]] != "") for k in _KEYS))


def write_split_csv(path: str, split: Split, boolean_style: bool = False) -> None:
    """Write ``split`` in the column style or, with ``boolean_style``, one row
    a slide (train, then val, then test) with ``True``/``False`` flags under
    an empty index header; either byte for byte as the JAX package's pandas
    writer lays it out."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        if boolean_style:
            out.writerow(("", *_KEYS))
            out.writerows((sid, *(str(k == part) for k in _KEYS))
                          for part in _KEYS for sid in getattr(split, part))
            return
        out.writerow(_KEYS)
        out.writerows(itertools.zip_longest(*(getattr(split, k) for k in _KEYS), fillvalue=""))


def _stratified_pick(rng: np.random.Generator, pool: np.ndarray, count: int) -> np.ndarray:
    if count > len(pool):
        raise ValueError(f"cannot sample {count} from pool of {len(pool)}")
    return rng.choice(pool, size=count, replace=False)


def _generate(table: SlideTable, *, n_splits: int, val_num: Sequence[int],
              test_num: Sequence[int], seed: int, label_frac: float, shot: int | None,
              patient_strat: bool = False, patient_voting: str = "max") -> list[Split]:
    """Per class, ``val_num[c]`` val and ``test_num[c]`` test units, then
    ``shot`` train units (or the first ``label_frac`` of the rest), from one
    ``default_rng(seed)`` over ``n_splits`` folds. With ``patient_strat`` the
    units are PATIENTS (voted labels), each bringing all its slides."""
    ids = table.slide_ids
    if patient_strat:
        patients = table.patient_table(patient_voting)
        case_ids, unit_labels = patients["case_id"], patients["label"]
        case_col = table.case_ids

        def expand(unit_rows):
            cases = {case_ids[i] for i in unit_rows}
            return [i for i, c in enumerate(case_col) if c in cases]
    else:
        unit_labels = table.labels

        def expand(unit_rows):
            return list(unit_rows)

    class_pools = [np.where(unit_labels == c)[0] for c in range(table.num_classes)]
    rng = np.random.default_rng(seed)
    splits = []
    for _ in range(n_splits):
        rows: dict[str, list[int]] = {k: [] for k in _KEYS}
        for c, pool in enumerate(class_pools):
            val_rows = _stratified_pick(rng, pool, val_num[c])
            remaining = np.setdiff1d(pool, val_rows)
            test_rows = _stratified_pick(rng, remaining, test_num[c])
            remaining = np.setdiff1d(remaining, test_rows)
            if shot is not None:
                train_rows = _stratified_pick(rng, remaining, shot)
            elif label_frac >= 1.0:
                train_rows = remaining
            else:
                train_rows = remaining[:int(np.ceil(len(remaining) * label_frac))]
            rows["val"].extend(expand(val_rows.tolist()))
            rows["test"].extend(expand(test_rows.tolist()))
            rows["train"].extend(expand(np.asarray(train_rows).tolist()))
        splits.append(Split(*(tuple(ids[i] for i in rows[k]) for k in _KEYS)))
    return splits


def generate_splits(table: SlideTable, *, n_splits: int = 5, val_num: Sequence[int],
                    test_num: Sequence[int], seed: int = 7, label_frac: float = 1.0,
                    patient_strat: bool = False) -> list[Split]:
    """Fully supervised stratified splits (the reference's ``generate_split``):
    every remaining unit of a class trains, or the first ``label_frac``."""
    return _generate(table, n_splits=n_splits, val_num=val_num, test_num=test_num, seed=seed,
                     label_frac=label_frac, shot=None, patient_strat=patient_strat)


def generate_fewshot_splits(table: SlideTable, *, shot: int, n_splits: int = 5,
                            val_num: Sequence[int], test_num: Sequence[int],
                            seed: int = 7, patient_strat: bool = False) -> list[Split]:
    """Few-shot splits (the reference's ``generate_split_few``): per class,
    ``val_num[c]`` val and ``test_num[c]`` test slides, then ``shot`` train
    slides from what remains, drawn from one ``default_rng(seed)``."""
    return _generate(table, n_splits=n_splits, val_num=val_num, test_num=test_num, seed=seed,
                     label_frac=1.0, shot=shot, patient_strat=patient_strat)
