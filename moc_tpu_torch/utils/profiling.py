"""Profiling and NaN tripwires (PyTorch port of ``moc_tpu/utils/profiling.py``,
on ``torch.profiler``).

``trace(log_dir)`` records CPU and, where a card is present, CUDA activity
(kernels by name, copies, the host ops that launched them) and writes one
Chrome-trace JSON file into ``log_dir`` (``<host>_<pid>.<ms>.pt.trace.json``,
``torch.profiler.tensorboard_trace_handler``'s name), which TensorBoard's
profiler plugin and Perfetto open. ``annotate(name)`` is a named region on
that timeline. ``detect_nan`` and ``assert_finite`` are host-side tripwires.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def profiler(log_dir: str) -> torch.profiler.profile:
    """An unstarted profiler over CPU and (with a card) CUDA activity that
    writes its trace into ``log_dir`` when it stops."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace around a block: ``with trace('/tmp/tb'):
    step(...)``, then open the directory in TensorBoard or the file in
    Perfetto. Only one profiler may run in a process at a time."""
    prof = profiler(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def annotate(name: str):
    """A named region of the trace timeline (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def detect_nan(x, name: str = "tensor") -> bool:
    """Host-side check: True, and a printed line, if any element of ``x`` (a
    tensor or an array) is not finite. Copies ``x`` to the host."""
    bad = not np.all(np.isfinite(_host(x)))
    if bad:
        print(f"[nan-tripwire] non-finite values in {name}")
    return bad


def assert_finite(x, name: str = "tensor"):
    """Raise FloatingPointError if ``x`` holds a NaN or an infinity; else
    return ``x``. On the card this waits for ``x`` (one host sync)."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x


def enable_nan_checks(enable: bool = True):
    """Turn autograd's anomaly mode on (or off): every backward function
    checks its outputs and raises on a NaN, naming the forward op that made
    it (``torch.autograd.set_detect_anomaly``). It checks the backward only;
    ``jax_debug_nans`` in the JAX package re-runs a forward that made a NaN,
    which has no counterpart here (use ``assert_finite`` on forward values).
    Called, it sets the mode for the process, as the JAX function does; used
    as ``with enable_nan_checks():`` it puts the mode back on exit."""
    return torch.autograd.set_detect_anomaly(enable)
