"""Time variants of K2's bf16 kernel (``flash_fwd_wgmma_kernel``) on one GPU.

    python scripts/flash_fwd_wgmma_variants.py [ROUNDS]

Each variant is this checkout's ``flash_fwd.cu`` with a few text
substitutions, built with the flags of ``ops/cuda_build.py`` into
``moc_tpu_torch/build/variants_wgmma/`` (all at once, one nvcc each), loaded
with ctypes in place of the wrapper's library and called through
``flash_fwd_cuda`` on bf16 tensors on the card at the extraction shape [64,
12, 785, 64], the 8192-token ring sequence [2, 12, 8192, 64] and the MoE
pretraining shape [8, 12, 1024, 64]. Each is timed as 50 calls queued behind
a spin kernel (``chip_smoke._gated_us``), the variants in turns for ROUNDS
rounds (default 2), and its O held against ``mha_reference`` at the last
shape (the largest |O - plain|). Prints each variant's ptxas spill lines
and one line a round. Variants, all but the first probes whose outputs are
wrong by design and which time what is left without one part:

- ``current``: the source as it is;
- ``no_loads``: the producer issues no K/V copy (the consumers read stale
  shared memory);
- ``no_exp``: ``ex2.approx`` replaced by a move;
- ``no_s``: no S = Q.K^T product; ``no_pv``: no O += P.V product;
- ``stages4``: a K/V ring of four stages.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from moc_tpu_torch.ops import cuda_build, flash_kernel  # noqa: E402
from moc_tpu_torch.ops.flash_attention import mha_reference  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "variants_wgmma")
SHAPES = {"extraction": (64, 12, 785, 64), "ring_whole": (2, 12, 8192, 64),
          "moe_pretrain": (8, 12, 1024, 64)}
K_LOAD = ("            sm90::tma_load(dst + box * C::kKeys * C::kRowBytes, &k_map, "
          "k_full + 8 * s,\n                           box * C::kBoxCols, t * C::kKeys, h, b);\n")
V_LOAD = K_LOAD.replace("&k_map, k_full", "&v_map, v_full")
VARIANTS = {
    "current": [],
    "no_loads": [("sm90::mbar_arrive_tx(k_full + 8 * s, C::kKVBytes);",
                  "sm90::mbar_arrive(k_full + 8 * s);"), (K_LOAD, ""),
                 ("sm90::mbar_arrive_tx(v_full + 8 * s, C::kKVBytes);",
                  "sm90::mbar_arrive(v_full + 8 * s);"), (V_LOAD, "")],
    "no_exp": [("ex2.approx.ftz.f32 %0, %1;", "mov.f32 %0, %1;")],
    "no_s": [("    sm90::wgmma_ss<128>(s, a, b, ks > 0);\n", "")],
    "no_pv": [("    sm90::wgmma_rs<D>(o, p[kk], b, 1);\n", "")],
    "stages4": [("constexpr int kSm90Stages = 2;", "constexpr int kSm90Stages = 4;")],
}


def build() -> dict:
    """Every variant's library path, built at once."""
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_fwd.cu")) as fh:
        source = fh.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in flash_fwd.cu")
            text = text.replace(old, new)
        # beside the sources, so that its includes resolve
        path = os.path.join(cuda_build.CSRC_DIR, f"_variant_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT, f"libflash_fwd_{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, path)
    libs = {}
    for name, (proc, lib, path) in procs.items():
        log, _ = proc.communicate()
        os.remove(path)
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes stack frame")]
        print(f"[variants] {name}: built; nonzero stack or spill lines {spills}", flush=True)
        libs[name] = lib
    return libs


def use(lib: str) -> None:
    """Make ``flash_fwd_cuda`` launch the kernel in ``lib``."""
    flash_kernel._bound.pop("moc_flash_fwd", None)
    cuda_build.load = lambda _name, _lib=lib: ctypes.CDLL(_lib)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 2
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {cell: [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3)] for cell, shape in SHAPES.items()}
    with torch.inference_mode():
        for r in range(rounds):
            for name, lib in libs.items():
                use(lib)
                parts = []
                for cell, (q, k, v) in data.items():
                    us = chip_smoke._gated_us(lambda: flash_kernel.flash_fwd_cuda(q, k, v), 50)
                    b, h, length, d = q.shape
                    tflops = ("" if us is None
                              else f" {4 * b * h * length ** 2 * d / us / 1e6:.0f} TF/s")
                    parts.append(f"{cell} {chip_smoke._us(us)}{tflops}")
                o, _ = flash_kernel.flash_fwd_cuda(q, k, v)
                err = (o.float() - mha_reference(q, k, v)[0].float()).abs().max().item()
                print(f"[variants] round {r} {name}: " + "; ".join(parts)
                      + f"; max |O - plain| {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
