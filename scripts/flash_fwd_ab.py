"""Time the flash-attention forward (K2) and the pretraining step of several
checkouts of this repository on one GPU, in turns.

    python scripts/flash_fwd_ab.py PARENT . . PARENT

Each argument is the root of a checkout of ``moc_tpu_torch`` (for example a
``git archive`` of another commit unpacked into a directory that
``.gitignore`` lists). The kernels of every distinct root are built first,
all at once. Then each argument in turn runs in a fresh process that imports
that root's ``moc_tpu_torch`` and this checkout's ``chip_smoke.py``, and runs
its ``phase_flash_times`` (K2 in f32 and bf16 at the extraction shape [64,
12, 785, 64], the pretraining shape [32, 12, 512, 64] and MUSK's shapes,
held against ``mha_reference``, per call, kernel-only and queued behind a
spin, beside ``scaled_dot_product_attention``; each dtype also on ``[B, L,
H, D]`` views where that root's K2 reads it by strides),
``phase_slice_kernel_times`` (K2, K3 and K4 at the encoder stack's and the
rings' shapes) and ``phase_pretrain_step_times`` (the full-width step in f32
and bf16, with a profile). The profiler reads the kernel-only times under the kernel names
in that root's source. Two runs
compare only within one call: interleave them (parent, change, change,
parent). Prints one ``AB {json}`` line per run and a summary; exits non-zero
if a run fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flash_bwd_ab import HERE, _build, _import_root, run_in_turns  # noqa: E402

# K2's kernels, by the names each generation of flash_fwd.cu gives them
F32_KERNELS = ("flash_fwd_tf32_wgmma_kernel", "flash_fwd_tf32_kernel", "flash_fwd_kernel")
BF16_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel", "flash_fwd_kernel")


def _kernel(root: str, names: tuple) -> str:
    with open(os.path.join(root, "moc_tpu_torch", "ops", "csrc", "flash_fwd.cu")) as fh:
        source = fh.read()
    return next(name for name in names if f"{name}(" in source)


def _time(root: str) -> None:
    _import_root(root)
    import torch

    from moc_tpu_torch.ops import flash_kernel

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.K2_KERNEL[torch.float32] = _kernel(root, F32_KERNELS)
    smoke.K2_KERNEL[torch.bfloat16] = _kernel(root, BF16_KERNELS)
    # a K2 that reads q/k/v of a dtype by their strides is timed on views as
    # well: bf16 since the wgmma kernel, f32 since its wgmma kernel
    strided = tuple(dtype for dtype in (torch.float32, torch.bfloat16)
                    if hasattr(flash_kernel, "tma_geometry") and "wgmma" in smoke.K2_KERNEL[dtype])
    record = {"root": root, "f32_kernel": smoke.K2_KERNEL[torch.float32],
              "bf16_kernel": smoke.K2_KERNEL[torch.bfloat16],
              "k2": smoke.phase_flash_times(strided=strided),
              "slice": smoke.phase_slice_kernel_times(),
              "step": smoke.phase_pretrain_step_times()}
    print("AB " + json.dumps(record), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] in ("--build", "--time"):
        (_build if argv[0] == "--build" else _time)(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    records = run_in_turns(os.path.abspath(__file__), [os.path.abspath(r) for r in argv])
    for rec in records:
        parts = []
        for tier in ("f32", "bf16"):
            for cell, k2 in rec["k2"][tier].items():
                parts.append(f"{tier} {cell}: K2 {k2['ms']:.4f} ms / {k2['kernel_us']} us "
                             f"kernel / {k2['device_us']} us queued, SDPA "
                             f"{k2['library_ms']:.4f} ms")
                if "strided" in k2:
                    parts.append(f"{tier} {cell} on views: K2 {k2['strided']['ms']:.4f} ms / "
                                 f"{k2['strided']['kernel_us']} us kernel")
            for cell, times in rec["slice"].items():
                if cell.endswith(f"_{tier}"):
                    k2 = times["K2"]
                    parts.append(f"{cell} {times['shape']}: K2 {k2['ms']:.4f} ms / "
                                 f"{k2['kernel_us']} us kernel / {k2['device_us']} us queued")
            parts.append(f"{tier} step {rec['step'][tier]['step_ms']:.3f} ms")
        print(f"[ab] {rec['root']} ({rec['f32_kernel']}, {rec['bf16_kernel']}): "
              + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
