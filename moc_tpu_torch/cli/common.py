"""Command-line flags shared by the port's entry points (the ported part of
``moc_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse


def add_selection_flags(p: argparse.ArgumentParser | argparse._ArgumentGroup) -> None:
    """``--select_method`` and ``--zs_pooling``, with the JAX package's
    choices and defaults; both go into ``MOCConfig``."""
    from moc_tpu_torch.ops.pooling import POOLING_REGISTRY

    p.add_argument("--select_method", default="threshold", choices=["threshold", "sort"],
                   help="exact selection union: threshold (kernel K1) or sort (top_k); "
                        "they differ only where keys tie +0.0 with -0.0")
    p.add_argument("--zs_pooling", default="topj", choices=sorted(POOLING_REGISTRY),
                   help="zero-shot pooling family (the bottomk families pool the "
                        "extended bank)")
