"""Probe variants of K2's f32 kernel (``flash_fwd_tf32_wgmma_kernel``) on one GPU.

    python scripts/flash_fwd_tf32_wgmma_variants.py [ROUNDS] [VARIANT ...]

Each variant is this checkout's ``flash_fwd.cu`` with a few text
substitutions, built with the flags of ``ops/cuda_build.py`` into
``moc_tpu_torch/build/variants_tf32/`` (all at once, one nvcc each), loaded
with ctypes in place of the wrapper's library and called through
``flash_fwd_cuda`` on f32 tensors on the card at the extraction shape [64,
12, 785, 64], the pretraining shape [32, 12, 512, 64] and MUSK's vision
shape [64, 16, 577, 64]. Each is timed as 50 calls queued behind a spin
kernel (``chip_smoke._gated_us``), the variants in turns for ROUNDS rounds
(default 2). Its O is held against attention in float64 on the same inputs
at [4, 12, 785, 64] and [1, 4, 8192, 64]: the largest |O - O64| over the
largest |O64|, and the signed bias mean((O - O64) sign(O64)) / mean|O64|,
which a sum rounded toward zero makes negative. Prints, first, the key tile,
the ring's stages and the route of V's transpose as built, and each
variant's ptxas lines (registers, spills, stack, and any note that ptxas
serialised the wgmma products), then one line a variant a round. Variants
(all by default, or those named):

- ``current``: the source as it is (P.V into a fresh accumulator each tile,
  folded into O by an FFMA; the passes of each product lo.hi, hi.lo, hi.hi);
- ``chained``: P.V summed in O itself across every tile (O rescaled in
  place), as the bf16 kernel does;
- ``interleaved``: each k-step's three passes in turn (lo.hi, hi.lo, hi.hi
  of step 0, then of step 1, ...), the order of the ``mma.sync`` design;
- ``roles``: warp 1 splits K and warps 2 and 3 transpose V, each in a loop
  of its own (as built, each of the three splitter warps splits a third of
  K, then transposes a third of V);
- ``landing1``: one landing buffer for V (two as built);
- ``producer64``: the producer warpgroup keeps 64 registers (the consumers
  216, not 224);
- ``cvt``: the splits of K, V and Q rounded by ``cvt.rna.tf32.f32`` rather
  than by integer ops (P's split, in ``flash_mma.cuh``, is unchanged);

and probes whose outputs are wrong by design, which time what is left
without one part:

- ``no_split``: the splitter warps neither split K nor transpose V;
- ``no_ksplit``, ``no_vsplit``: the K split alone, or V's transpose alone,
  left out; ``no_qsplit``: the consumers do not split Q;
- ``no_turns``: the consumer warpgroups issue without taking turns;
- ``no_s``: no S = Q.K^T product; ``no_pv``: no O += P.V product;
- ``no_exp``: ``ex2.approx`` replaced by a move.
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

OUT = os.path.join(cuda_build.BUILD_DIR, "variants_tf32")
SHAPES = {"extraction": (64, 12, 785, 64), "pretraining": (32, 12, 512, 64),
          "musk_vision": (64, 16, 577, 64)}
ERROR_SHAPES = {"785": (4, 12, 785, 64), "8192": (1, 4, 8192, 64)}
PASS_LOOP = "#pragma unroll\n  for (int pass = 0; pass < 3; ++pass) {\n#pragma unroll\n"
ROLE_SPLITTERS = """    } else if (warp <= C::kKSplitters / 32) {
      // ---- K splitters: each K tile split in place, its segment ids copied ----
      const int i0 = threadIdx.x - 32;
      int g = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        int bh, q0, n_tiles;
        item_of(item, bh, q0, n_tiles);
        const int b = bh / heads;
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % C::kStages;
          sm90::mbar_wait(k_full + 8 * s, (g / C::kStages) & 1);
          split_tile<C::kKVBytes, C::kKSplitters>(smem + k_at(s),
                                                  smem + k_at(s) + C::kStages * C::kKVBytes, i0);
          if (segments) {  // keys past Lkv count for nothing (id unread)
            for (int col = i0; col < C::kKeys; col += C::kKSplitters) {
              const int key = t * C::kKeys + col;
              seg_smem[(g % C::kSegSlots) * C::kKeys + col] =
                  key < lkv ? kv_seg[static_cast<size_t>(b) * lkv + key] : 0;
            }
          }
          sm90::fence_async_smem();
          sm90::mbar_arrive(k_ready + 8 * s);
        }
      }
    } else {
      // ---- V splitters: each V tile, as it lands, into V^T hi and lo ----
      const int i0 = threadIdx.x - 32 - C::kKSplitters;
      int g = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        int bh, q0, n_tiles;
        item_of(item, bh, q0, n_tiles);
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % C::kStages, l = g % C::kLandings;
          sm90::mbar_wait(v_full + 8 * l, (g / C::kLandings) & 1);
          sm90::mbar_wait(vt_empty + 8 * s, ((g / C::kStages) & 1) ^ 1);  // the first round passes
          transpose_v_tile<D>(smem + C::kVOff + l * C::kKVBytes, smem + vt_at(s),
                              smem + vt_at(s) + C::kStages * C::kKVBytes, i0);
          sm90::fence_async_smem();
          sm90::mbar_arrive(vt_ready + 8 * s);
          sm90::mbar_arrive(v_free + 8 * l);
        }
      }
    }
"""
VARIANTS = {
    "current": [],
    "chained": [("constexpr bool kTf32FreshPv = true;", "constexpr bool kTf32FreshPv = false;")],
    "interleaved": [
        (PASS_LOOP + "    for (int ks = 0; ks < D / 8; ++ks) {\n",
         "#pragma unroll\n  for (int ks = 0; ks < D / 8; ++ks) {\n#pragma unroll\n"
         "    for (int pass = 0; pass < 3; ++pass) {\n"),
        (PASS_LOOP + "    for (int kk = 0; kk < C::kKeys / 8; ++kk) {\n",
         "#pragma unroll\n  for (int kk = 0; kk < C::kKeys / 8; ++kk) {\n#pragma unroll\n"
         "    for (int pass = 0; pass < 3; ++pass) {\n")],
    "producer64": [("static constexpr int kProducerRegs = 56;",
                    "static constexpr int kProducerRegs = 64;")],
    "cvt": [("// x split as hi = tf32(x), lo = tf32(x - hi), for four values at once\n",
             "__device__ __forceinline__ uint32_t cvt_tf32(float x) {\n"
             "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
             "  return r;\n}\n__device__ __forceinline__ void split_cvt(float x, uint32_t& h, "
             "uint32_t& l) {\n  h = cvt_tf32(x);\n  l = cvt_tf32(x - __uint_as_float(h));\n}\n"),
            ("  split_tf32(x.", "  split_cvt(x.")],
    "no_split": [("split_tile<C::kKVBytes, C::kSplitters>(",
                  "if (false) split_tile<C::kKVBytes, C::kSplitters>("),
                 ("transpose_v_tile<D>(smem + C::kVOff",
                  "if (false) transpose_v_tile<D>(smem + C::kVOff")],
    # warp 1 splits K, warps 2 and 3 transpose V, each in a loop of its own
    "roles": [("  static constexpr int kSplitters = 96;"
               "  // warps 1-3: K split in place, V into V^T",
               "  static constexpr int kSplitters = 96, kKSplitters = 32, kVSplitters = 64;"),
              ("sm90::mbar_init(k_ready + 8 * s, C::kSplitters);",
               "sm90::mbar_init(k_ready + 8 * s, C::kKSplitters);"),
              ("sm90::mbar_init(vt_ready + 8 * s, C::kSplitters);",
               "sm90::mbar_init(vt_ready + 8 * s, C::kVSplitters);"),
              ("sm90::mbar_init(v_free + 8 * i, C::kSplitters);",
               "sm90::mbar_init(v_free + 8 * i, C::kVSplitters);"),
              ("constexpr int kWarps = C::kSplitters / 32;",
               "constexpr int kWarps = C::kVSplitters / 32;"),
              (("    } else {\n      // ---- splitters: each K tile split in place",
                "  } else {\n    // ---- consumers: 64 query rows of every item each ----\n"),
               ROLE_SPLITTERS)],
    "landing1": [("static constexpr int kLandings = 2;", "static constexpr int kLandings = 1;")],
    "no_ksplit": [("split_tile<C::kKVBytes, C::kSplitters>(",
                   "if (false) split_tile<C::kKVBytes, C::kSplitters>(")],
    "no_vsplit": [("transpose_v_tile<D>(smem + C::kVOff",
                   "if (false) transpose_v_tile<D>(smem + C::kVOff")],
    "no_qsplit": [("split_tile<C::kQBytes, 128>(", "if (false) split_tile<C::kQBytes, 128>(")],
    "no_turns": [("sm90::named_barrier(my_turn, 256);", ""),
                 ("sm90::named_arrive(their_turn, 256);", ""),
                 ("if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);", "")],
    "no_s": [("      sm90::wgmma_ss_tf32<C::kKeys>(s, a, b, pass > 0 || ks > 0);\n", "")],
    "no_pv": [("      sm90::wgmma_rs_tf32<D>(o, pass == 0 ? p_lo[kk] : p_hi[kk], b,\n"
               "                             !(fresh && pass == 0 && kk == 0));\n", "")],
    "no_exp": [("ex2.approx.ftz.f32 %0, %1;", "mov.f32 %0, %1;")],
}


def _layout(source: str) -> str:
    """The key tile and stages of the f32 kernel as the source builds them."""
    keys = re.search(r"static constexpr int kKeys = (D == 128 \? \d+ : \d+);", source)
    stages = re.search(r"static constexpr int kStages = (D == 128 \? \d+ : \d+);\s+// of the K and "
                       r"V\^T ring", source)
    return (f"key tile {keys.group(1) if keys else '?'}, stages "
            f"{stages.group(1) if stages else '?'}; K split in place and V transposed into V^T "
            "hi and lo in the kernel by the producer warpgroup's warps 1-3 (split_tile, "
            "transpose_v_tile), Q split in place by the consumers")


def _ptxas_lines(log: str) -> list[str]:
    """The ptxas lines of the f32 kernel: registers, spills, and notes."""
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
    source = cuda_build.inlined_source("flash_fwd")
    print(f"[variants] as built: {_layout(source)}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if isinstance(old, tuple):  # the region from old[0] up to old[1]
                start = text.find(old[0])
                end = text.find(old[1], start)
                if start < 0 or end < 0:
                    raise SystemExit(f"{name}: {old!r} is not in flash_fwd.cu or its headers")
                text = text[:start] + new + text[end:]
                continue
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in flash_fwd.cu or its headers")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"flash_fwd_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT, f"libflash_fwd_{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, path)
    libs = {}
    for name, (proc, lib, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        for line in _ptxas_lines(log):
            print(f"[variants] {name}: {line}", flush=True)
        libs[name] = lib
    return libs


def use(lib: str) -> None:
    """Make ``flash_fwd_cuda`` launch the kernel in ``lib``."""
    flash_kernel._bound.pop("moc_flash_fwd", None)
    cuda_build.load = lambda _name, _lib=lib: ctypes.CDLL(_lib)


def _reference64(q, k, v):
    """O in float64, by heads in turn (softmax(q.k^T / sqrt(D)) . v)."""
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            s = (q[b, h].double() @ k[b, h].double().T) * q.shape[-1] ** -0.5
            out[b, h] = torch.softmax(s, -1) @ v[b, h].double()
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 2
    names = argv[1:] or list(VARIANTS)
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {cell: [torch.randn(shape, generator=gen, device="cuda") for _ in range(3)]
            for cell, shape in SHAPES.items()}
    checks = {}
    for cell, shape in ERROR_SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        checks[cell] = (q, k, v, _reference64(q, k, v))
    with torch.inference_mode():
        for r in range(rounds):
            for name, lib in libs.items():
                use(lib)
                parts = []
                for cell, (q, k, v) in data.items():
                    us = chip_smoke._gated_us(lambda: flash_kernel.flash_fwd_cuda(q, k, v), 50)
                    b, h, length, d = q.shape
                    rate = ("" if us is None
                            else f" {3 * 4 * b * h * length ** 2 * d / us / 1e6:.0f} TF/s")
                    parts.append(f"{cell} {chip_smoke._us(us)}{rate}")
                for cell, (q, k, v, want) in checks.items():
                    o = flash_kernel.flash_fwd_cuda(q, k, v)[0].double()
                    err = ((o - want).abs().max() / want.abs().max()).item()
                    bias = (((o - want) * want.sign()).mean() / want.abs().mean()).item()
                    parts.append(f"L={cell}: max |O - O64| / max |O64| {err:.3e}, bias {bias:.2e}")
                print(f"[variants] round {r} {name}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
