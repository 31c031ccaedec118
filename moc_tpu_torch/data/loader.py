"""Bag loading, batch streams and episode materialisation (port of
``moc_tpu/data/loader.py``).

A thread pool reads the bags of a ``SlideTable``, optionally through a
locked LRU cache. ``batches`` and ``stream_batches`` yield the table as
bucketed padded ``BagBatch``es on the host, which ``prefetch_to_device``
copies to the card on a side stream, two batches ahead. A few-shot episode
is loaded once: its train slides as one padded batch on the device, its
val and test slides as padded chunks, and the reference's oversampled train
order (``repeat_num`` visits that wrap modulo the train size) as an explicit
index sequence.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from moc_tpu_torch.data.bags import Bag, bag_patch_count, read_bag
from moc_tpu_torch.data.batching import (DEFAULT_BUCKETS, BagBatch, bucket_size, bucketize,
                                         pack_bags)
from moc_tpu_torch.data.table import SlideTable
from moc_tpu_torch.device import resolve_device


def prefetch_to_device(batches: Iterable[BagBatch], device: str | torch.device | None = None,
                       depth: int = 2) -> Iterator[BagBatch]:
    """Copy host batches to ``device`` (default ``cuda``) ``depth`` ahead of
    the consumer. On a GPU the copies run on a side stream from pinned host
    memory (pinned here where a batch is not), so they overlap the
    consumer's work; each batch is handed over once its copy is ordered
    before the consumer's stream. On the CPU, batches pass through."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        yield from (b.to(dev) for b in batches)
        return
    side = torch.cuda.Stream(device=dev)
    queue: collections.deque = collections.deque()

    def issue(batch: BagBatch):
        if batch.features.device.type == "cpu" and not batch.features.is_pinned():
            batch = dataclasses.replace(batch, features=batch.features.pin_memory())
        with torch.cuda.stream(side):
            moved = batch.to(dev)
        done = torch.cuda.Event()
        done.record(side)
        return moved, done

    def hand_over(item):
        moved, done = item
        current = torch.cuda.current_stream(dev)
        current.wait_event(done)
        for t in (moved.features, moved.mask, moved.labels, moved.n_patches, moved.coords,
                  moved.scales):
            if t is not None:
                t.record_stream(current)  # the allocator must not reuse it early
        return moved

    for batch in batches:
        queue.append(issue(batch))
        if len(queue) > depth:
            yield hand_over(queue.popleft())
    while queue:
        yield hand_over(queue.popleft())


class BagLoader:
    """Reads the bags of the slides in ``table`` from ``data_dir`` (``.pt``
    bags, or ``.h5`` with ``use_h5``) with a pool of ``num_workers`` threads.
    With ``cache``, bags stay in host memory, least recently read first out
    once they pass ``cache_budget_gb`` (None: no limit).

    The reference's per-read options: ``bag_size`` (a seeded random subset
    of that many patches, the same for a slide whatever the read order),
    ``preselect`` (stored patch indices per slide, which win over
    ``bag_size``) and ``label_revert`` (binary labels inverted)."""

    def __init__(self, table: SlideTable, data_dir: str, *, use_h5: bool = False,
                 num_workers: int = 8, cache: bool = False,
                 cache_budget_gb: float | None = None, bag_size: int | None = None,
                 preselect: dict[str, np.ndarray] | None = None, label_revert: bool = False,
                 seed: int = 0):
        self.table = table
        self.data_dir = data_dir
        self.use_h5 = use_h5
        self.num_workers = num_workers
        self.bag_size = bag_size
        self.preselect = preselect
        self.label_revert = label_revert
        self.seed = seed
        self._cache: dict[str, Bag] | None = {} if cache else None
        self._cache_budget = None if cache_budget_gb is None else int(cache_budget_gb * 2**30)
        self._cache_bytes = 0
        # read() runs in the pool, the same slide possibly twice at once: every
        # cache change (touch, insert, byte count, eviction) holds this lock
        self._cache_lock = threading.Lock()

    def toggle_label_revert(self, toggle: bool) -> None:
        self.label_revert = toggle

    def _read_cached(self, slide_id: str) -> Bag:
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

    def read(self, slide_id: str) -> Bag:
        bag = self._read_cached(slide_id)
        idx = None
        if self.preselect is not None and slide_id in self.preselect:
            idx = np.asarray(self.preselect[slide_id])
        elif self.bag_size is not None and bag.n_patches > self.bag_size:
            # a generator of (seed, slide id): the pool's completion order
            # must not change which subset a slide gets
            rng = np.random.default_rng((self.seed, int.from_bytes(
                hashlib.sha1(slide_id.encode()).digest()[:8], "little")))
            idx = rng.permutation(bag.n_patches)[:self.bag_size]
        if idx is not None:
            bag = dataclasses.replace(bag, features=bag.features[idx],
                                      coords=None if bag.coords is None else bag.coords[idx])
        if self.label_revert and bag.label is not None:
            bag = dataclasses.replace(bag, label=1 - bag.label)
        return bag

    def read_all(self, slide_ids: Sequence[str] | None = None) -> list[Bag]:
        """The bags of ``slide_ids`` (default: the whole table), in order."""
        ids = list(self.table.slide_ids_ if slide_ids is None else slide_ids)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            return list(pool.map(self.read, ids))

    def _ids(self, shard) -> list[str]:
        ids = list(self.table.slide_ids_)
        if shard is not None:
            index, count = shard
            ids = ids[index::count]
        return ids

    def batches(self, *, batch_size: int = 8, buckets: Sequence[int] = DEFAULT_BUCKETS,
                with_coords: bool = False, shuffle_seed: int | None = None,
                shard: tuple[int, int] | None = None,
                pin_memory: bool = False) -> Iterator[BagBatch]:
        """Bucketed padded host batches covering the table: grouped by bucket
        (smallest first, table order within), in chunks of ``batch_size``; a
        short last chunk is filled with copies of its bags labelled -1, so
        shapes stay static and consumers weight rows by ``labels >= 0``.
        ``shuffle_seed`` permutes the read bags first; ``shard=(index,
        count)`` keeps every ``count``-th slide from ``index``.
        ``pin_memory`` packs into pinned host memory."""
        bags = self.read_all(self._ids(shard))
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(bags)
        for n_pad, group in sorted(bucketize(bags, buckets).items()):
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                real = len(chunk)
                while len(chunk) < batch_size:
                    chunk = chunk + [dataclasses.replace(chunk[len(chunk) % real], label=-1)]
                yield pack_bags(chunk, n_pad=n_pad, with_coords=with_coords, device="cpu",
                                pin_memory=pin_memory)

    def stream_batches(self, *, batch_size: int = 8, buckets: Sequence[int] = DEFAULT_BUCKETS,
                       with_coords: bool = False, shuffle_seed: int | None = None,
                       shard: tuple[int, int] | None = None, lookahead: int = 2,
                       pin_memory: bool = False) -> Iterator[BagBatch]:
        """``batches`` without holding the table in memory: the buckets come
        from the h5 headers (no feature bytes read), then the bags are read
        chunk by chunk, ``lookahead`` chunks in flight in the pool while the
        current batch is consumed. Within a bucket the order is the header
        scan's (deterministic). ``.pt`` bags carry no cheap header: such a
        table falls back to ``batches``."""
        ids = self._ids(shard)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(ids)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            counts = list(pool.map(
                lambda s: bag_patch_count(self.data_dir, s, use_h5=self.use_h5), ids))
        if any(c is None for c in counts):
            yield from self.batches(batch_size=batch_size, buckets=buckets,
                                    with_coords=with_coords, shuffle_seed=shuffle_seed,
                                    shard=shard, pin_memory=pin_memory)
            return
        if self.bag_size is not None:
            counts = [min(c, self.bag_size) for c in counts]
        if self.preselect is not None:
            # read() returns exactly the preselected rows, so they size the bucket
            counts = [len(self.preselect[sid]) if sid in self.preselect else c
                      for sid, c in zip(ids, counts)]
        grouped: dict[int, list[str]] = {}
        for sid, c in zip(ids, counts):
            grouped.setdefault(bucket_size(c, buckets), []).append(sid)
        chunks: list[tuple[int, list[str], int]] = []  # (n_pad, ids, n_real)
        for n_pad, group in sorted(grouped.items()):
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                real = len(chunk)
                while len(chunk) < batch_size:
                    chunk = chunk + [chunk[len(chunk) % real]]
                chunks.append((n_pad, chunk, real))

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending: collections.deque = collections.deque()

            def submit(i):
                n_pad, chunk_ids, real = chunks[i]
                pending.append((n_pad, [pool.submit(self.read, s) for s in chunk_ids], real))

            for i in range(min(lookahead + 1, len(chunks))):
                submit(i)
            for i in range(len(chunks)):
                n_pad, futures, real = pending.popleft()
                if i + lookahead + 1 < len(chunks):
                    submit(i + lookahead + 1)
                bags = [f.result() for f in futures]
                bags = bags[:real] + [dataclasses.replace(b, label=-1) for b in bags[real:]]
                yield pack_bags(bags, n_pad=n_pad, with_coords=with_coords, device="cpu",
                                pin_memory=pin_memory)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


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
