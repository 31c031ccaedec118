"""GPipe-style pipeline execution over a ``pipe`` mesh axis (PyTorch port of
``moc_tpu/parallel/pipeline.py``).

The layer stack is split into S stages, one per rank along the axis;
microbatches stream through the stages, each stage's output passed to the
next rank by ``collectives.ppermute``, with the S-1-tick bubble at fill and
drain. Autograd runs the reverse pipeline: ``ppermute``'s backward sends
each cotangent back to the stage it came from. Every rank takes part in
every exchange: as in JAX, ``where`` picks stage 0's feed over what arrived
and the last stage's outputs over zeros, keeping both operands in the
graph, so each rank's backward runs the same exchanges in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from moc_tpu_torch.parallel.collectives import ppermute, psum
from moc_tpu_torch.parallel.mesh import resolve_axis


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor, axis_name,
                   num_stages: int, gather_output: bool = True) -> torch.Tensor:
    """Run ``microbatches [M, ...]`` through ``num_stages`` stages.

    ``stage_params`` is this rank's stage; ``stage_fn(params, x)`` maps one
    microbatch through it (shape-preserving). Returns ``[M, ...]``: the
    finished microbatches on the last stage and zeros elsewhere, or, with
    ``gather_output``, on every rank (a ``psum`` over the axis)."""
    ax = resolve_axis(axis_name)
    m, s = microbatches.shape[0], num_stages
    first = torch.tensor(ax.index == 0, device=microbatches.device)
    last = torch.tensor(ax.index == s - 1, device=microbatches.device)
    perm = [(i, (i + 1) % s) for i in range(s)]
    state = torch.zeros_like(microbatches[0])  # what arrived from the stage before
    zero = torch.zeros_like(microbatches[0])
    outputs = [zero] * m
    for t in range(m + s - 1):
        x = torch.where(first, microbatches[min(t, m - 1)], state)
        y = stage_fn(stage_params, x)
        done = t - (s - 1)
        if 0 <= done < m:
            outputs[done] = torch.where(last, y, zero)
        state = ppermute(y, ax, perm)
    out = torch.stack(outputs)
    return psum(out, ax) if gather_output else out
