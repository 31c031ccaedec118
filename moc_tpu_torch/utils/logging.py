"""Scalar logging and running-average meters (PyTorch port of
``moc_tpu/utils/logging.py``).

``ScalarLogger`` always writes the scalars to ``scalars.jsonl`` (greppable,
no dependency) and also TensorBoard event files where ``tensorboardX``
imports; hosts without it get the JSONL alone.
"""

from __future__ import annotations

import json
import os
from typing import IO


class AverageMeter:
    """Running average: ``update(val, n)``, then read ``.avg``, ``.sum``, ``.count``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class ScalarLogger:
    """Training-scalar sink: JSONL always, TensorBoard when available.
    ``log_dir=None`` makes every method a no-op."""

    def __init__(self, log_dir: str | None, tensorboard: bool = True):
        self._jsonl: IO[str] | None = None
        self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir, flush_secs=15)
            except ImportError:
                self._tb = None

    @property
    def enabled(self) -> bool:
        return self._jsonl is not None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, scalars: dict[str, float], step: int, prefix: str = "") -> None:
        for tag, value in scalars.items():
            self.add_scalar(prefix + tag, value, step)

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
