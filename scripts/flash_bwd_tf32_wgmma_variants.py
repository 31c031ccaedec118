"""Probe variants of f32 K3 and K4 (``flash_bwd_dq_tf32_wgmma_kernel``,
``flash_bwd_dkv_tf32_wgmma_kernel``) on one GPU.

    python scripts/flash_bwd_tf32_wgmma_variants.py [ROUNDS] [VARIANT ...]

Each variant is this checkout's ``flash_bwd.cu``, with the headers it
includes from ``csrc/`` written into it, and a few text substitutions,
built with the flags of ``ops/cuda_build.py`` into
``moc_tpu_torch/build/variants_bwd_tf32/`` (all at once, one nvcc each),
loaded with ctypes in place of the wrapper's library and called through
``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` on f32 tensors on the card
at the pretraining shape [32, 12, 512, 64], a dilated branch [4, 12, 2048,
64] and the 8192-token ring sequence [2, 12, 8192, 64]. Each is timed as 50
calls queued behind a spin kernel (``chip_smoke._gated_us``), the variants
in turns for ROUNDS rounds (default 2). Its gradients are held against
``flash_bwd_reference`` at [4, 12, 512, 64] and against gradients in
float64 from the same lse and delta at [1, 4, 8192, 64]: the largest |grad -
exact| over the largest |exact| of the three, and the signed bias mean((grad
- exact) sign(exact)) / mean |exact| of dq, dk and dv together, which sums
rounded toward zero make negative. Prints, first, each variant's ptxas lines
(registers, spills, stack, and any note that ptxas serialised the wgmma
products) and dynamic shared memory by head dim, then one line a variant a
round. Variants (all by default, or those named):

- ``current``: the source as it is (each tile's gradient product into a
  fresh accumulator, added to the running sum in f32; the passes lo.hi,
  hi.lo, hi.hi);
- ``chained``: the gradients summed in the wgmma accumulator over every tile;
- ``trunc``: the low-13-bit probe. The tiles in shared memory keep x itself
  as hi and take lo = tf32(x - x with its low 13 bits cleared), as built;
  this variant splits the register operands (p, ds) so too. If the tensor
  core drops an operand's low 13 bits, hi + lo is x again and the gradients
  stay within a few units in 2^-21; if it rounded them, the error would grow
  to about 2^-11;
- ``k4_q16``: K4 takes 16 queries a tile at D = 64 (32 as built);
- ``k3_stages1`` / ``k4_stages1``: one stage of each ring;
- ``k4_ss_scores``: K4's scores read K or V from shared memory in every
  pass (the hi passes from registers at D <= 64 as built);
- ``k3_producer56`` / ``k4_producer56``: the producer warpgroup keeps 56
  registers a thread, the consumers 224 (64 and 216 as built);
- ``k4_in_place``: K4 writes p^T and ds^T over the scores' accumulator, as
  K4 was first built;

and probes whose gradients are wrong by design, which time what is left
without one part:

- ``no_turns``: the consumer warpgroups issue without taking turns;
- ``no_split``: the splitter warps do not split the landed tiles;
  ``no_transpose``: K3's splitters and K4's consumers do not transpose them;
- ``no_scores``: no score product; ``no_grads``: no gradient product.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from moc_tpu_torch.ops import cuda_build, flash_kernel  # noqa: E402
from moc_tpu_torch.ops.flash_attention import flash_bwd_reference  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "variants_bwd_tf32")
SHAPES = {"pretraining": (32, 12, 512, 64), "dilated_branch": (4, 12, 2048, 64),
          "ring_whole": (2, 12, 8192, 64)}
ERROR_SHAPES = {"512": (4, 12, 512, 64), "8192": (1, 4, 8192, 64)}
NO = "if (false) "
VARIANTS = {
    "current": [],
    "chained": [("constexpr bool kTf32FreshGrads = true;",
                 "constexpr bool kTf32FreshGrads = false;")],
    "trunc": [("  hi = to_tf32(x);\n  lo = to_tf32(x - __uint_as_float(hi));\n",
               "  hi = __float_as_uint(x);\n"
               "  lo = to_tf32(x - __uint_as_float(hi & 0xFFFFE000u));\n")],
    "k4_q16": [("static constexpr int kQ = D == 128 ? 16 : 32;  // queries a tile",
                "static constexpr int kQ = D == 32 ? 32 : 16;  // queries a tile")],
    "k4_ss_scores": [("static constexpr bool kRsScores = D <= 64;",
                      "static constexpr bool kRsScores = false;")],
    "k3_stages1": [("static constexpr int kStages = D == 32 ? 3 : 2;",
                    "static constexpr int kStages = 1;")],
    "k4_stages1": [("static constexpr int kStages = D == 32 ? 3 : D == 64 ? 2 : 1;",
                    "static constexpr int kStages = 1;")],
    "k3_producer56": [("Sm90Tf32Bwd<D == 128 ? 1 : 2, 64>", "Sm90Tf32Bwd<D == 128 ? 1 : 2, 56>")],
    "k4_producer56": [("Sm90Tf32Bwd<2, 64>", "Sm90Tf32Bwd<2, 56>")],
    "k4_in_place": [("float sc[kQ / 2], pv[kQ / 2];",
                     "float sc[kQ / 2];\n      float (&pv)[kQ / 2] = sc;")],
    "no_turns": [("sm90::named_barrier(my_turn, 256);", ";"),
                 ("sm90::named_arrive(their_turn, 256);", ";"),
                 ("sm90::named_arrive(kTurnBarrier, 256);", ";")],
    "no_split": [("split_lo_tile<C::kTileBytes, C::kSplitters>(",
                  NO + "split_lo_tile<C::kTileBytes, C::kSplitters>(")],
    "no_transpose": [("transpose_tile<D, kKeys, C::kSplitters>(",
                      NO + "transpose_tile<D, kKeys, C::kSplitters>("),
                     ("transpose_tile<D, kQ, 128>(", NO + "transpose_tile<D, kQ, 128>(")],
    "no_scores": [("      sm90::wgmma_ss_tf32<N>(acc, a, b, pass > 0 || ks > 0);\n", "")],
    "no_grads": [("      sm90::wgmma_rs_tf32<M>(acc, pass == 0 ? lo[kk] : hi[kk], b,\n"
                  "                             !(fresh && pass == 0 && kk == 0));\n", "")],
}


def _ptxas_lines(log: str) -> list[str]:
    """The ptxas lines of the f32 kernels: registers, spills, and notes."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?$", line)
        if m:
            entry = chip_smoke._kernel_name(m.group(1))
            continue
        if entry and "tf32_wgmma" in entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
        elif "serialized" in line or "Performance" in line:
            out.append(line.strip())
    return out


def build(names: list[str]) -> dict:
    """Every named variant's library path, built at once."""
    source = cuda_build.inlined_source("flash_bwd")
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in flash_bwd.cu or its headers")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"flash_bwd_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT, f"libflash_bwd_{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:  # a probe can trip the compiler: say so and go on
            print(f"[variants] {name}: failed to build (rc {proc.returncode}): "
                  + " | ".join(log.strip().splitlines()[-3:]), flush=True)
            continue
        for line in _ptxas_lines(log):
            print(f"[variants] {name}: {line}", flush=True)
        libs[name] = lib
    if "current" in names and "current" not in libs:
        raise SystemExit("the source as it is failed to build")
    return libs


_LOAD = cuda_build.load


def use(lib: str) -> None:
    """Make ``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` launch the kernels in ``lib``."""
    for symbol in ("moc_flash_bwd_dq", "moc_flash_bwd_dkv"):
        flash_kernel._bound.pop(symbol, None)
    cuda_build.load = lambda name: ctypes.CDLL(lib) if name == "flash_bwd" else _LOAD(name)


def _inputs(shape, gen):
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
    with torch.no_grad():
        o, lse = flash_kernel.flash_fwd_cuda(q, k, v)
    return q, k, v, do, o, lse, (o * do).sum(-1)


def _exact(q, k, v, do, lse, delta):
    """dq, dk and dv in float64 from the same lse and delta, by heads in turn."""
    scale = q.shape[-1] ** -0.5
    grads = [torch.empty(t.shape, dtype=torch.float64, device=t.device) for t in (q, k, v)]
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            qd, kd, vd, dod = (t[b, h].double() for t in (q, k, v, do))
            p = torch.exp(qd @ kd.T * scale - lse[b, h].double()[:, None])
            ds = p * (dod @ vd.T - delta[b, h].double()[:, None]) * scale
            grads[0][b, h], grads[1][b, h], grads[2][b, h] = ds @ kd, ds.T @ qd, p.T @ dod
    return grads


def _errors(got, want) -> tuple[float, float]:
    largest = max(w.abs().max().item() for w in want)
    err = max((g.double() - w).abs().max().item() for g, w in zip(got, want)) / largest
    num = sum(((g.double() - w) * w.sign()).sum().item() for g, w in zip(got, want))
    den = sum(w.abs().sum().item() for w in want)
    return err, num / den


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 2
    names = argv[1:] or list(VARIANTS)
    libs = build(names)
    for name, lib in libs.items():
        use(lib)
        print(f"[variants] {name}: dynamic shared memory at D 32 / 64 / 128: "
              + "; ".join(f"{kid} " + " / ".join(str(flash_kernel.k3_k4_smem_bytes(
                  d, torch.float32, kid)) for d in (32, 64, 128)) for kid in ("K3", "K4"))
              + " bytes", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {cell: _inputs(shape, gen) for cell, shape in SHAPES.items()}
    checks = {}
    for cell, shape in ERROR_SHAPES.items():
        q, k, v, do, o, lse, delta = _inputs(shape, gen)
        want = (flash_bwd_reference(q, k, v, o, lse, do) if cell == "512"
                else _exact(q, k, v, do, lse, delta))
        checks[cell] = (q, k, v, do, lse, delta, [w.double() for w in want])
    for r in range(rounds):
        for name, lib in libs.items():
            use(lib)
            parts = []
            for cell, (q, k, v, do, o, lse, delta) in data.items():
                b, h, length, d = q.shape
                n = b * h * length * length * d
                for kid, fn, flop in (
                        ("K3", lambda: flash_kernel.flash_bwd_dq_cuda(q, k, v, do, lse, delta),
                         6 * n),
                        ("K4", lambda: flash_kernel.flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
                         8 * n)):
                    fn()  # the first call of a library binds it
                    us = chip_smoke._gated_us(fn, 50)
                    rate = "" if us is None else f" {3 * flop / us / 1e6:.0f} TF/s"
                    parts.append(f"{cell} {kid} {chip_smoke._us(us)}{rate}")
            for cell, (q, k, v, do, lse, delta, want) in checks.items():
                dq = flash_kernel.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
                dk, dv = flash_kernel.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
                err, bias = _errors((dq, dk, dv), want)
                parts.append(f"L={cell}: max |grad - exact| / largest {err:.3e}, bias {bias:.2e}")
            print(f"[variants] round {r} {name}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
