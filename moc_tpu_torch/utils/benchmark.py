"""Device timing (PyTorch port of ``moc_tpu/utils/benchmark.py``).

CUDA launches return before the card finishes, so a host clock around them
measures the enqueue. ``device_time`` times ``iters`` calls of a function
between two CUDA events on the card (the events are ordered on the stream,
so the end event waits for every launch), and with ``perf_counter`` where
the function's tensors lie on the CPU, which computes before it returns.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def _on_cuda(tree) -> bool:
    if torch.is_tensor(tree):
        return tree.is_cuda
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(x) for x in tree)
    if isinstance(tree, dict):
        return any(_on_cuda(x) for x in tree.values())
    return False


def _run_k(fn: Callable, args, k: int, cuda: bool) -> float:
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(k):
        fn(*args)
    return time.perf_counter() - t0


def device_time(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                repeats: int = 3, reduce: str = "best") -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``repeats``
    runs of ``iters`` calls, each timed whole and divided by ``iters``. On
    the card (any CUDA tensor among the arguments or in the result) by CUDA
    events, else by ``perf_counter``. ``reduce="best"`` (the least) suits
    comparisons of two versions; ``"median"`` suits a reported number."""
    if reduce not in ("best", "median"):
        raise ValueError(f"unknown reduce {reduce!r} (use 'best' or 'median')")
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    cuda = _on_cuda(args) or _on_cuda(out)
    if cuda:
        torch.cuda.synchronize()
    samples = [max(_run_k(fn, args, iters, cuda) / iters, 1e-12) for _ in range(repeats)]
    return float(np.median(samples)) if reduce == "median" else min(samples)
