"""Time variants of bf16 K3 and K4 (``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel``) on one GPU.

    python scripts/flash_bwd_wgmma_variants.py [ROUNDS] [VARIANT ...]

Each variant is this checkout's ``flash_bwd.cu`` with a few text
substitutions, built with the flags of ``ops/cuda_build.py`` into
``moc_tpu_torch/build/variants_bwd/`` (all at once, one nvcc each), loaded
with ctypes in place of the wrapper's library and called through
``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` on bf16 tensors on the card
at the pretraining shape [32, 12, 512, 64], a dilated branch [4, 12, 2048,
64] and the 8192-token ring sequence [2, 12, 8192, 64]. Each is timed as 50
calls queued behind a spin kernel (``chip_smoke._gated_us``), the variants in
turns for ROUNDS rounds (default 2), and its gradients held against
``flash_bwd_reference`` at the first shape (the largest |grad - plain| over
the largest |grad|). Prints each wgmma kernel's ptxas lines (registers,
spills, and any note that ptxas serialised the wgmma products) and one line
a round. Variants (all by default, or those named), all but ``current`` and
the tile and stage choices probes whose gradients are wrong by design and
which time what is left without one part:

- ``current``: the source as it is;
- ``no_exp``: ``ex2.approx`` replaced by a move (K3 and K4);
- ``no_turns``: the consumer warpgroups issue without taking turns;
- ``k3_no_scores``: no S and dP products in K3's steady loop; ``k3_no_dq``: no
  dq product there;
- ``k4_no_scores``: no S^T and dP^T products in K4's steady loop;
  ``k4_no_grads``: no dv and dk products there;
- ``k4_no_loads``: K4's producer issues no Q/dO copy;
- ``k4_q32``: K4 takes 32 queries a tile at every head dim;
- ``k4_stages2`` / ``k4_stages4``: a two- or four-stage Q/dO ring for K4
  (six at D <= 64, four at D = 128, as built); ``k3_stages2``: a two-stage
  K/V ring for K3 (three at D <= 64, as built);
- ``producer24``: the producer keeps 24 registers a thread (the consumers
  240 instead of 232);
- ``k4_st_written``: K4 as first built, p^T written over s^T in f32 and
  packed after the products' wait, the gradient products of tile t issued
  after the scores of tile t + 1 (ptxas serialises its products: C7511,
  "insufficient register resources for the wgmma pipeline").
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

OUT = os.path.join(cuda_build.BUILD_DIR, "variants_bwd")
SHAPES = {"pretraining": (32, 12, 512, 64), "dilated_branch": (4, 12, 2048, 64),
          "ring_whole": (2, 12, 8192, 64)}
K3_SCORES = ("          issue_ss<D, kKeys>(s, q_tile, base + C::kKOff + stage1 * C::kKVBytes);\n"
             "          issue_ss<D, kKeys>(dp, do_tile, base + C::kVOff + stage1 * C::kKVBytes);\n")
K4_SCORES = ("          issue_ss<D, kQ>(st, k_tile, q_at(stage1));\n"
             "          issue_ss<D, kQ>(dpt, v_tile, do_at(stage1));\n")
K4_DV = "          issue_rs<D, kQ>(dv, pt, do_at(stage));\n"
K4_DK = "          issue_rs<D, kQ>(dk, dst, q_at(stage));\n"
K4_LOADS = ("            sm90::tma_load(q_dst + box * kQ * C::kRowBytes, &q_map, full + 8 * s,\n"
            "                           box * C::kBoxCols, q0, h, b);\n"
            "            sm90::tma_load(do_dst + box * kQ * C::kRowBytes, &do_map, full + 8 * s,\n"
            "                           box * C::kBoxCols, q0, h, b);\n")
COMMIT = "          sm90::wgmma_commit();\n"
# K4's steady loop as first built: scores of t + 1, then dv and dk of t; p^T
# written over s^T and packed, with ds^T, after the wait for every product
K4_FIRST = [
    (K4_DV + COMMIT + K4_SCORES + COMMIT + K4_DK + COMMIT,
     K4_SCORES + COMMIT + K4_DV + K4_DK + COMMIT),
    ("          sm90::wgmma_wait<1>();  // dv of tile t and the scores of tile t + 1 are done\n"
     "          sm90::fence_regs(st);\n          sm90::fence_regs(dpt);\n"
     "          sm90::fence_regs(dv);\n          sm90::fence_regs(pt);\n",
     "          sm90::wgmma_wait<1>();\n          sm90::fence_regs(st);\n"
     "          sm90::fence_regs(dpt);\n"),
    ("          sm90::fence_regs(dk);\n          sm90::fence_regs(dst);\n",
     "          sm90::fence_regs(dk);\n          sm90::fence_regs(dst);\n"
     "          sm90::fence_regs(dv);\n          sm90::fence_regs(pt);\n"),
    ("    pt[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);\n"
     "    pt[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);\n",
     "    for (int e = 0; e < 4; ++e) const_cast<float&>(st[4 * j + e]) = p[e];\n"),
    ("          pack_a<kQ>(dst, dpt);\n        }\n",
     "          pack_a<kQ>(dst, dpt);\n          pack_a<kQ>(pt, st);\n        }\n"),
    ("                      t4, scale_log2, sm_scale);\n        pack_a<kQ>(dst, dpt);\n",
     "                      t4, scale_log2, sm_scale);\n        pack_a<kQ>(dst, dpt);\n"
     "        pack_a<kQ>(pt, st);\n"),
]
VARIANTS = {
    "current": [],
    "no_exp": [("ex2.approx.ftz.f32 %0, %1;", "mov.f32 %0, %1;")],
    "no_turns": [("sm90::named_barrier(my_turn, 256);", ""),
                 ("sm90::named_arrive(their_turn, 256);", ""),
                 ("if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);", "")],
    "k3_no_scores": [(K3_SCORES, "")],
    "k3_no_dq": [("          issue_rs<D, kKeys>(dq, ds, base + C::kKOff + stage * C::kKVBytes);\n",
                  "")],
    "k4_no_scores": [(K4_SCORES, "")],
    "k4_no_grads": [(K4_DV, ""), (K4_DK, "")],
    "k4_no_loads": [("sm90::mbar_arrive_tx(full + 8 * s, 2 * C::kQBytes);",
                     "sm90::mbar_arrive(full + 8 * s);"), (K4_LOADS, "")],
    "k4_q32": [("static constexpr int kQ = D == 128 ? 32 : 64;",
                "static constexpr int kQ = 32;")],
    "k4_stages2": [("static constexpr int kStages = D == 128 ? 4 : 6;",
                    "static constexpr int kStages = 2;")],
    "k4_stages4": [("static constexpr int kStages = D == 128 ? 4 : 6;",
                    "static constexpr int kStages = 4;")],
    "k3_stages2": [("static constexpr int kStages = D == 128 ? 2 : 3;",
                    "static constexpr int kStages = 2;")],
    "producer24": [("static constexpr int kProducerRegs = 40;",
                    "static constexpr int kProducerRegs = 24;")],
    "k4_st_written": K4_FIRST,
}


def _ptxas_lines(log: str) -> list[str]:
    """The ptxas lines of the wgmma kernels: registers, spills, and notes."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = chip_smoke._kernel_name(m.group(1))
            continue
        if entry and "wgmma_kernel" in entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
        elif "wgmma" in line or "Performance" in line:
            out.append(line.strip())
    return out


def build(names: list[str]) -> dict:
    """Every named variant's library path, built at once."""
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_bwd.cu")) as fh:
        source = fh.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in flash_bwd.cu")
            text = text.replace(old, new)
        # beside the sources, so that its includes resolve
        path = os.path.join(cuda_build.CSRC_DIR, f"_variant_bwd_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT, f"libflash_bwd_{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, path)
    libs = {}
    for name, (proc, lib, path) in procs.items():
        log, _ = proc.communicate()
        os.remove(path)
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        for line in _ptxas_lines(log):
            print(f"[variants] {name}: {line}", flush=True)
        libs[name] = lib
    return libs


def use(lib: str) -> None:
    """Make ``flash_bwd_dq_cuda`` and ``flash_bwd_dkv_cuda`` launch the kernels in ``lib``."""
    for symbol in ("moc_flash_bwd_dq", "moc_flash_bwd_dkv"):
        flash_kernel._bound.pop(symbol, None)
    cuda_build.load = lambda _name, _lib=lib: ctypes.CDLL(_lib)


def _inputs(shape, gen):
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    with torch.no_grad():
        o, lse = flash_kernel.flash_fwd_cuda(q, k, v)
    return q, k, v, do, o, lse, (o.float() * do.float()).sum(-1)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 2
    names = argv[1:] or list(VARIANTS)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {cell: _inputs(shape, gen) for cell, shape in SHAPES.items()}
    q, k, v, do, o, lse, delta = data["pretraining"]
    want = flash_bwd_reference(q, k, v, o, lse, do)
    largest = max(w.float().abs().max().item() for w in want)
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
                    us = chip_smoke._gated_us(fn, 50)
                    rate = "" if us is None else f" {flop / us / 1e6:.0f} TF/s"
                    parts.append(f"{cell} {kid} {chip_smoke._us(us)}{rate}")
            q, k, v, do, o, lse, delta = data["pretraining"]
            dq = flash_kernel.flash_bwd_dq_cuda(q, k, v, do, lse, delta)
            dk, dv = flash_kernel.flash_bwd_dkv_cuda(q, k, v, do, lse, delta)
            err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip((dq, dk, dv), want)) / largest
            print(f"[variants] round {r} {name}: " + "; ".join(parts)
                  + f"; max |grad - plain| / largest {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
