"""Dual-scale bag loading for ViLa-MIL (PyTorch port of
``moc_tpu/data/vila_data.py``).

Each slide has two feature files, a small-scale (s) and a large-scale (l)
bag under two data directories, read together as ``(feats_s, feats_l,
label)`` and padded each to its own bucket. ``.pt`` bags are read; ``.h5``
bags only with ``use_h5`` where h5py imports, as elsewhere in the port.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

from moc_tpu_torch.data.bags import read_bag
from moc_tpu_torch.data.batching import bucket_size, pad_bag
from moc_tpu_torch.data.table import SlideTable


@dataclasses.dataclass
class DualScaleBag:
    """One padded dual-scale slide."""

    feats_s: torch.Tensor  # [Ns, D]
    mask_s: torch.Tensor  # [Ns] bool
    feats_l: torch.Tensor  # [Nl, D]
    mask_l: torch.Tensor
    label: torch.Tensor  # int64 scalar

    def to(self, device) -> "DualScaleBag":
        return DualScaleBag(*(getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)))


@dataclasses.dataclass
class DualScaleLoader:
    table: SlideTable
    data_dir_s: str
    data_dir_l: str
    use_h5: bool = False
    num_workers: int = 8

    def read(self, slide_id: str) -> DualScaleBag:
        label = self.table.label_of(slide_id)
        bag_s = read_bag(self.data_dir_s, slide_id, use_h5=self.use_h5, label=label)
        bag_l = read_bag(self.data_dir_l, slide_id, use_h5=self.use_h5, label=label)
        fs, ms, _ = pad_bag(bag_s.features, bucket_size(bag_s.n_patches))
        fl, ml, _ = pad_bag(bag_l.features, bucket_size(bag_l.n_patches))
        return DualScaleBag(feats_s=torch.from_numpy(fs), mask_s=torch.from_numpy(ms),
                            feats_l=torch.from_numpy(fl), mask_l=torch.from_numpy(ml),
                            label=torch.tensor(int(label), dtype=torch.int64))

    def read_all(self, slide_ids: Sequence[str] | None = None) -> list[DualScaleBag]:
        ids = list(slide_ids) if slide_ids is not None else list(self.table.slide_ids)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            return list(pool.map(self.read, ids))
