"""Bag loading and episode materialisation (port of ``BagLoader.read``,
``read_all`` and ``EpisodeBags`` in ``moc_tpu/data/loader.py``).

A thread pool reads the bags of a ``SlideTable``, optionally through a
locked LRU cache. A few-shot episode is loaded once: its train slides as
one padded batch on the device, its val and test slides as padded chunks,
and the reference's oversampled train order (``repeat_num`` visits that wrap
modulo the train size) as an explicit index sequence.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from moc_tpu_torch.data.bags import Bag, read_bag
from moc_tpu_torch.data.batching import BagBatch, bucket_size, bucketize, pack_bags
from moc_tpu_torch.data.table import SlideTable
from moc_tpu_torch.device import resolve_device


class BagLoader:
    """Reads the bags of the slides in ``table`` from ``data_dir`` (``.pt``
    bags, or ``.h5`` with ``use_h5``) with a pool of ``num_workers`` threads.
    With ``cache``, bags stay in host memory, least recently read first out
    once they pass ``cache_budget_gb`` (None: no limit)."""

    def __init__(self, table: SlideTable, data_dir: str, *, use_h5: bool = False,
                 num_workers: int = 8, cache: bool = False,
                 cache_budget_gb: float | None = None):
        self.table = table
        self.data_dir = data_dir
        self.use_h5 = use_h5
        self.num_workers = num_workers
        self._cache: dict[str, Bag] | None = {} if cache else None
        self._cache_budget = None if cache_budget_gb is None else int(cache_budget_gb * 2**30)
        self._cache_bytes = 0
        # read() runs in the pool, the same slide possibly twice at once: every
        # cache change (touch, insert, byte count, eviction) holds this lock
        self._cache_lock = threading.Lock()

    def read(self, slide_id: str) -> Bag:
        if self._cache is not None:
            with self._cache_lock:
                bag = self._cache.pop(slide_id, None)
                if bag is not None:
                    self._cache[slide_id] = bag  # re-insert: most recently read
                    return bag
        bag = read_bag(self.data_dir, slide_id, use_h5=self.use_h5,
                       label=self.table.label_of(slide_id))
        if self._cache is not None:
            with self._cache_lock:
                if slide_id not in self._cache:  # another reader may have won
                    self._cache[slide_id] = bag
                    self._cache_bytes += bag.features.nbytes
                while (self._cache_budget is not None and self._cache_bytes > self._cache_budget
                       and len(self._cache) > 1):
                    self._cache_bytes -= self._cache.pop(next(iter(self._cache))).features.nbytes
        return bag

    def read_all(self, slide_ids: Sequence[str] | None = None) -> list[Bag]:
        """The bags of ``slide_ids`` (default: the whole table), in order."""
        ids = list(self.table.slide_ids_ if slide_ids is None else slide_ids)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            return list(pool.map(self.read, ids))


def _eval_chunks(bags: list[Bag], eval_batch_size: int):
    """``(n_pad, bags)`` chunks of ``eval_batch_size`` per bucket; a short
    chunk is filled with copies of its first bag labelled -1."""
    chunks = []
    for n_pad, group in sorted(bucketize(bags).items()):
        for i in range(0, len(group), eval_batch_size):
            chunk = group[i:i + eval_batch_size]
            filler = [dataclasses.replace(chunk[0], label=-1)] * (eval_batch_size - len(chunk))
            chunks.append((n_pad, chunk + filler))
    return chunks


@dataclasses.dataclass
class EpisodeBags:
    """The bags of one few-shot episode, padded once: ``train`` is one batch
    on ``device``; ``val`` and ``test`` are chunks on ``device`` or, past the
    load's budget, in pinned host memory (each is copied over when it is
    evaluated, see ``BagBatch.to``)."""

    train: BagBatch
    val: list[BagBatch]
    test: list[BagBatch]
    repeat_num: int
    device: torch.device

    @classmethod
    def load(cls, loader: BagLoader, train_ids: Sequence[str], val_ids: Sequence[str],
             test_ids: Sequence[str], *, repeat_num: int | None = None,
             eval_batch_size: int = 8, eval_device_budget_gb: float = 4.0,
             device: str | torch.device | None = None) -> "EpisodeBags":
        """Read and pad one episode on ``device`` (default ``cuda``). The
        eval chunks stay on the device while their padded f32 features fit
        ``eval_device_budget_gb``."""
        dev = resolve_device(device)
        train_bags = loader.read_all(train_ids)
        n_pad = bucket_size(max(b.n_patches for b in train_bags))
        train = pack_bags(train_bags, n_pad=n_pad, device=dev)
        val_chunks = _eval_chunks(loader.read_all(val_ids), eval_batch_size)
        test_chunks = _eval_chunks(loader.read_all(test_ids), eval_batch_size)
        dim = train_bags[0].dim
        eval_bytes = sum(eval_batch_size * p * dim * 4 for p, _ in val_chunks + test_chunks)
        on_device = eval_bytes <= eval_device_budget_gb * 2**30

        def pack(chunks):
            if on_device:
                return [pack_bags(c, n_pad=p, device=dev) for p, c in chunks]
            host = [pack_bags(c, n_pad=p, device="cpu") for p, c in chunks]
            if dev.type != "cuda":
                return host
            return [dataclasses.replace(b, features=b.features.pin_memory()) for b in host]

        return cls(train=train, val=pack(val_chunks), test=pack(test_chunks),
                   repeat_num=repeat_num if repeat_num is not None else train.batch_size,
                   device=dev)

    def train_epoch_order(self, rng: np.random.Generator | None = None,
                          shuffle: bool = False) -> np.ndarray:
        """One oversampled epoch's train indices: ``repeat_num`` visits that
        wrap modulo the train size, unshuffled unless ``shuffle`` (with an
        ``rng``), as the reference's train loader is."""
        order = np.arange(self.repeat_num) % self.train.batch_size
        if shuffle:
            if rng is None:
                raise ValueError("shuffle=True needs an rng")
            rng.shuffle(order)
        return order
