"""Time the flash-attention backward (K3, K4) and the pretraining step of
several checkouts of this repository on one GPU, in turns.

    python scripts/flash_bwd_ab.py PARENT . . PARENT

Each argument is the root of a checkout of ``moc_tpu_torch`` (for example a
``git archive`` of another commit unpacked into a directory that
``.gitignore`` lists). The kernels of every distinct root are built first,
all at once. Then each argument in turn runs in a fresh process that imports
that root's ``moc_tpu_torch`` and this checkout's ``chip_smoke.py``, and runs
its ``phase_flash_bwd_times`` (K3 and K4 at [32, 12, 512, 64] in f32 and
bf16, held against ``flash_bwd_reference``, per call, kernel-only and queued
behind a spin, beside ``scaled_dot_product_attention``'s backward) and
``phase_pretrain_step_times`` (the full-width step in f32 and bf16, with a
profile). Two runs compare only within one call: interleave them (parent,
change, change, parent). Prints one ``AB {json}`` line per run and a summary;
exits non-zero if a run fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_root(root: str):
    """``moc_tpu_torch`` from ``root`` (not from this checkout)."""
    sys.path.insert(0, root)
    import moc_tpu_torch

    if not os.path.abspath(moc_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"moc_tpu_torch came from {moc_tpu_torch.__file__}, not {root}")
    return moc_tpu_torch


def _build(root: str) -> None:
    _import_root(root)
    from moc_tpu_torch.ops import cuda_build

    cuda_build.build(["flash_fwd", "flash_bwd"])


def _time(root: str) -> None:
    _import_root(root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    record = {"root": root, "bwd": smoke.phase_flash_bwd_times(),
              "step": smoke.phase_pretrain_step_times()}
    print("AB " + json.dumps(record), flush=True)


def run_in_turns(script: str, roots: list[str]) -> list[dict]:
    """Build the kernels of every distinct root at once (``script --build
    ROOT`` each), then run ``script --time ROOT`` for each root in turn;
    returns the ``AB {json}`` record each run prints."""
    def child(mode: str, root: str) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, script, f"--{mode}", root],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    builds = {r: child("build", r) for r in dict.fromkeys(roots)}
    for root, proc in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(out)
            raise SystemExit(f"building {root} failed")
    records = []
    for root in roots:
        proc = child("time", root)
        out, _ = proc.communicate()
        print(out, end="", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"timing {root} failed")
        records.append(json.loads(next(line[3:] for line in out.splitlines()
                                       if line.startswith("AB "))))
    return records


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
            bwd = rec["bwd"][tier]
            parts.append(
                f"{tier}: K3 {bwd['dq']['ms']:.4f} ms / {bwd['dq']['kernel_us']} us kernel / "
                f"{bwd['dq']['device_us']} us queued, K4 {bwd['dkv']['ms']:.4f} ms / "
                f"{bwd['dkv']['kernel_us']} us / {bwd['dkv']['device_us']} us, SDPA backward "
                f"{bwd['dq']['library_ms']:.4f} ms, step {rec['step'][tier]['step_ms']:.3f} ms")
        print(f"[ab] {rec['root']}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
