"""Split files and seeded few-shot split generation (port of
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


def write_split_csv(path: str, split: Split) -> None:
    """Write ``split`` in the column style, laid out as the JAX package's
    pandas writer lays it out."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(_KEYS)
        out.writerows(itertools.zip_longest(*(getattr(split, k) for k in _KEYS), fillvalue=""))


def _stratified_pick(rng: np.random.Generator, pool: np.ndarray, count: int) -> np.ndarray:
    if count > len(pool):
        raise ValueError(f"cannot sample {count} from pool of {len(pool)}")
    return rng.choice(pool, size=count, replace=False)


def generate_fewshot_splits(table: SlideTable, *, shot: int, n_splits: int = 5,
                            val_num: Sequence[int], test_num: Sequence[int],
                            seed: int = 7) -> list[Split]:
    """Few-shot splits: per class, ``val_num[c]`` val and ``test_num[c]``
    test slides, then ``shot`` train slides from what remains, drawn from
    one ``default_rng(seed)`` over ``n_splits`` folds."""
    ids = table.slide_ids
    class_pools = [table.class_indices(c) for c in range(table.num_classes)]
    rng = np.random.default_rng(seed)
    splits = []
    for _ in range(n_splits):
        rows: dict[str, list[int]] = {k: [] for k in _KEYS}
        for c, pool in enumerate(class_pools):
            val_rows = _stratified_pick(rng, pool, val_num[c])
            remaining = np.setdiff1d(pool, val_rows)
            test_rows = _stratified_pick(rng, remaining, test_num[c])
            remaining = np.setdiff1d(remaining, test_rows)
            train_rows = _stratified_pick(rng, remaining, shot)
            rows["val"].extend(val_rows.tolist())
            rows["test"].extend(test_rows.tolist())
            rows["train"].extend(train_rows.tolist())
        splits.append(Split(*(tuple(ids[i] for i in rows[k]) for k in _KEYS)))
    return splits
