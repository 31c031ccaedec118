"""Command-line plumbing shared by the port's entry points (PyTorch port of
``moc_tpu/cli/common.py``): the ``--xprof`` trace of a whole invocation and
the performance tiers of ``MOCConfig``. The JAX runtime's device meshes wait
for the multi-device runtime (ROADMAP queue 1, item 9); its persistent
compilation cache has no counterpart (the port compiles only its nvcc
kernels, which ``ops.cuda_build`` caches by source hash)."""

from __future__ import annotations

import argparse
import atexit

_trace = None  # the running --xprof profiler, if any


def add_xprof_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--xprof", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the whole run (CPU and CUDA "
                        "activity) into DIR; TensorBoard and Perfetto open it")


def setup_runtime(args: argparse.Namespace) -> None:
    """Per-invocation runtime setup: with ``--xprof DIR``, start a
    ``torch.profiler`` trace (``utils.profiling``) of the whole invocation,
    written into DIR by ``stop_trace``, which runs at interpreter exit (a
    caller that runs a CLI's ``main`` in its own process may call it
    sooner). A trace left running by an earlier call is stopped first: a
    process holds one profiler at a time."""
    global _trace
    if not getattr(args, "xprof", None):
        return
    from moc_tpu_torch.utils.profiling import profiler

    stop_trace()
    _trace = profiler(args.xprof)
    _trace.start()


@atexit.register
def stop_trace() -> None:
    """Stop the ``--xprof`` trace, if one runs, and write it."""
    global _trace
    if _trace is not None:
        prof, _trace = _trace, None
        prof.stop()


def add_perf_flags(p: argparse.ArgumentParser) -> None:
    """``--dense``, ``--score_dtype``, ``--select_method`` and ``--approx_topk``
    in a "performance tiers" group, and ``--zs_pooling``, with the JAX
    package's choices and defaults; ``perf_cfg_kwargs`` turns them into
    ``MOCConfig`` fields."""
    from moc_tpu_torch.ops.pooling import POOLING_REGISTRY

    g = p.add_argument_group("performance tiers")
    g.add_argument("--dense", action="store_true",
                   help="selection-free fused forward (differs from the reference only "
                        "when a row outside the 4 x topj union would rank in the fused "
                        "top-k)")
    g.add_argument("--score_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="dtype of the full-bag scoring product; bfloat16 halves its read "
                        "(the selected rows are re-scored in f32)")
    g.add_argument("--select_method", default="threshold", choices=["threshold", "sort"],
                   help="exact selection union: threshold (kernel K1) or sort (top_k); "
                        "they differ only where keys tie +0.0 with -0.0")
    g.add_argument("--approx_topk", action="store_true",
                   help="the TPU's approximate top-k; refused here")
    p.add_argument("--zs_pooling", default="topj", choices=sorted(POOLING_REGISTRY),
                   help="zero-shot pooling family (the bottomk families pool the "
                        "extended bank)")


def perf_cfg_kwargs(args: argparse.Namespace) -> dict:
    """``MOCConfig`` fields of the flags of ``add_perf_flags``. Exits on
    ``--approx_topk``, the TPU's approximate top-k, which the GPU lacks."""
    if args.approx_topk:
        raise SystemExit("--approx_topk is the TPU's approximate top-k and belongs to the JAX "
                         "package; the GPU port has none (use the exact --select_method)")
    return dict(dense=args.dense, score_dtype=args.score_dtype,
                select_method=args.select_method, zs_pooling=args.zs_pooling)
