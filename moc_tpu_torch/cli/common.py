"""Command-line plumbing shared by the port's entry points (PyTorch port of
``moc_tpu/cli/common.py``): the multi-process runtime
(``parallel.runtime``, joined by ``setup_runtime`` from the ``MOC_TPU_*`` or
``torchrun`` variables, with ``--dist_backend``), the ``--xprof`` trace of a
whole invocation and the performance tiers of ``MOCConfig``. The JAX
package's persistent compilation cache has no counterpart (the port
compiles only its nvcc kernels, which ``ops.cuda_build`` caches by source
hash)."""

from __future__ import annotations

import argparse
import atexit
import sys

_trace = None  # the running --xprof profiler, if any


def add_xprof_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--xprof", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the whole run (CPU and CUDA "
                        "activity) into DIR; TensorBoard and Perfetto open it")


def add_dist_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dist_backend", default="nccl", choices=["nccl", "gloo"],
                   help="process-group backend of a multi-process run (the MOC_TPU_* or "
                        "torchrun variables): nccl, one card a rank (the default), or gloo, "
                        "for ranks on the CPU or several ranks sharing one card")


def setup_runtime(args: argparse.Namespace) -> None:
    """Per-invocation runtime setup: join the process group when the
    ``MOC_TPU_*`` (or ``torchrun``) variables configure a multi-process run
    (``parallel.runtime.initialize_runtime`` with ``--dist_backend`` and
    ``--device``; a no-op otherwise) and say on stderr how the ranks talk;
    with ``--xprof DIR``, start a ``torch.profiler`` trace
    (``utils.profiling``) of the whole invocation, written into DIR by
    ``stop_trace``, which runs at interpreter exit (a caller that runs a
    CLI's ``main`` in its own process may call it sooner). A trace left
    running by an earlier call is stopped first: a process holds one
    profiler at a time."""
    global _trace
    from moc_tpu_torch.parallel import runtime

    if runtime.initialize_runtime(backend=getattr(args, "dist_backend", None),
                                  device=getattr(args, "device", None)):
        print(runtime.describe(), file=sys.stderr)
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


def serving_devices(device) -> list:
    """The cards ``--data_parallel`` splits a batch over, ``device`` first
    and each once: every visible GPU in a one-process run on ``cuda``; this
    rank's own card in a multi-process run (the ranks split the slides
    instead); ``device`` alone on the CPU."""
    import torch

    from moc_tpu_torch.parallel import runtime

    device = torch.device(device)
    if device.type != "cuda" or runtime.process_count() > 1:
        return [device]
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return [device] + [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                       if i != device.index]


def round_up_to_devices(batch_size: int, n_devices: int) -> int:
    """``batch_size`` rounded up to a multiple of ``n_devices`` (stderr note
    when it changes), so each card scores an equal share of a batch."""
    if batch_size % n_devices == 0:
        return batch_size
    rounded = -(-batch_size // n_devices) * n_devices
    print(f"data-parallel over {n_devices} devices: batch_size rounded up to {rounded}",
          file=sys.stderr)
    return rounded


def _parts(n: int, k: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of ``k`` contiguous parts of ``n`` rows, the first
    ``n % k`` one row longer (``numpy.array_split``'s cut); empty parts left out."""
    bounds = [i * (n // k) + min(i, n % k) for i in range(k + 1)]
    return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


def split_batch_logits(replicas):
    """``batch_logits`` over ``replicas``, pairs ``(batch_logits, device)``
    one a card: a batch's rows cut in contiguous parts (as equal as the row
    count allows), each part moved to its card and scored there, the logits
    concatenated on the first card."""
    import dataclasses

    import torch

    if len(replicas) == 1:
        return replicas[0][0]
    home = replicas[0][1]

    def batch_logits(batch):
        fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
        outs = []
        for (a, b), (fn, dev) in zip(_parts(batch.features.shape[0], len(replicas)), replicas):
            part = {k: (v[a:b].to(dev) if isinstance(v, torch.Tensor) else v)
                    for k, v in fields.items()}
            outs.append(fn(type(batch)(**part)).to(home))
        return torch.cat(outs)

    return batch_logits


def split_encode(encoders):
    """``encode`` over ``encoders`` one a card: a batch of images cut in
    contiguous parts as ``split_batch_logits`` cuts rows, each encoded on its
    card, the features concatenated in order."""
    import numpy as np

    if len(encoders) == 1:
        return encoders[0]

    def encode(images):
        images = np.asarray(images)
        return np.concatenate([e(images[a:b]) for (a, b), e in
                               zip(_parts(images.shape[0], len(encoders)), encoders)])

    return encode

