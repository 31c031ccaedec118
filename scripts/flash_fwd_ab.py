"""Time the flash-attention forward (K2) and the pretraining step of several
checkouts of this repository on one GPU, in turns.

    python scripts/flash_fwd_ab.py PARENT . . PARENT

Each argument is the root of a checkout of ``moc_tpu_torch`` (for example a
``git archive`` of another commit unpacked into a directory that
``.gitignore`` lists). The kernels of every distinct root are built first,
all at once. Then each argument in turn runs in a fresh process that imports
that root's ``moc_tpu_torch`` and this checkout's ``chip_smoke.py``, and runs
its ``phase_flash_times`` (K2 in f32 and bf16 at the extraction shape [64,
12, 785, 64] and the pretraining shape [32, 12, 512, 64], held against
``mha_reference``, per call, kernel-only and queued behind a spin, beside
``scaled_dot_product_attention``) and ``phase_pretrain_step_times`` (the
full-width step in f32 and bf16, with a profile). The profiler reads the
kernel-only time under the f32 kernel's name in that root's source. Two runs
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

# K2's f32 kernel, by the name each generation of flash_fwd.cu gives it
F32_KERNELS = ("flash_fwd_tf32_kernel", "flash_fwd_kernel")


def _f32_kernel(root: str) -> str:
    with open(os.path.join(root, "moc_tpu_torch", "ops", "csrc", "flash_fwd.cu")) as fh:
        source = fh.read()
    return next(name for name in F32_KERNELS if f"{name}(" in source)


def _time(root: str) -> None:
    _import_root(root)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.K2_KERNEL[torch.float32] = _f32_kernel(root)
    record = {"root": root, "f32_kernel": smoke.K2_KERNEL[torch.float32],
              "k2": smoke.phase_flash_times(), "step": smoke.phase_pretrain_step_times()}
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
            parts.append(f"{tier} step {rec['step'][tier]['step_ms']:.3f} ms")
        print(f"[ab] {rec['root']} ({rec['f32_kernel']}): " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
