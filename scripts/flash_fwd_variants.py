"""Time variants of K2's f32 kernel (``flash_fwd_tf32_kernel``) on one GPU.

    python scripts/flash_fwd_variants.py [ROUNDS]

Each variant is this checkout's ``flash_fwd.cu`` and ``flash_mma.cuh`` with
a few text substitutions, built with the flags of ``ops/cuda_build.py``
into ``moc_tpu_torch/build/variants/<name>/`` (all at once, one nvcc each),
loaded with ctypes and called on f32 tensors on the card at the extraction
shape [64, 12, 785, 64] and the pretraining shape [32, 12, 512, 64]. Each
call is held against ``mha_reference`` (the largest |O - plain| over the
largest |O|, and of lse) and timed as 30 calls queued behind a spin kernel
(``chip_smoke._gated_us``), the variants in turns for ROUNDS rounds
(default 2). Prints each variant's registers at D = 64 and one line a
timing. Variants:

- ``current``: the source as it is;
- ``cvt``: the TF32 rounding by ``cvt.rna.tf32.f32`` (the same bits);
- ``default_bounds``: no minimum-blocks launch bound on the kernel;
- ``keys32``: passes of 32 keys at D = 64;
- ``k_split_once``, ``v_split_once``: K's or V's tile split once a CTA,
  each thread splitting the chunks it copied (hi in place, lo into a plane
  of its own), behind one more barrier a tile;
- probes, whose outputs are wrong by design and which time what is left
  without one phase: ``no_s`` (S read from K's tile, no product),
  ``no_pv`` (no P.V product), ``no_softmax`` (no max, exp or rescale).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from moc_tpu_torch.ops import cuda_build  # noqa: E402
from moc_tpu_torch.ops.flash_attention import mha_reference  # noqa: E402

OUT = os.path.join(cuda_build.BUILD_DIR, "variants")
SHAPES = {"extraction": (64, 12, 785, 64), "pretraining": (32, 12, 512, 64)}

# a plane of lo parts for one tile, after the kernel's two stages of K and V
SPLIT_HELPER = r"""
template <int D>
__device__ __forceinline__ void split_own_chunks(float* tile, float* lo, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = 0; i < kBlock * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int off = (e / kChunks) * Layout<D>::kStride + (e % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

}  // namespace flash
"""
END = "}  // namespace flash\n"
SMEM = "return sizeof(float) * 5 * Layout<D>::kTile + 2 * kBlock * sizeof(int);"
SEGS = "  int* kv_segs = reinterpret_cast<int*>(vs + 2 * kTile);  // [2][64]\n\n  const int bh"
TOP = ("    if (t + 1 < n_tiles) load_kv(t + 1);  // into the stage tile t - 1 used\n"
       "    cp_async_commit();\n    const float* kt = ks + stage * kTile;\n"
       "    const float* vt = vs + stage * kTile;\n")
SCORES = "      tf32_scores<D>(s, qs, wrow, kt, kc, lane);"
GRADS = "      tf32_grads<D>(acc, s, vt, kc, lane);"


def _split_once(which: str) -> list:
    """K's (``which`` "ks") or V's ("vs") tile split once a CTA, read split."""
    subs = [("flash_mma.cuh", END, SPLIT_HELPER),
            ("flash_fwd.cu", SMEM, SMEM.replace("* 5 *", "* 6 *")),
            ("flash_fwd.cu", SEGS, "  float* lo = vs + 2 * kTile;\n"
             + SEGS.replace("(vs + 2 * kTile)", "(lo + kTile)")),
            ("flash_fwd.cu", TOP, TOP.replace(
                "    const float* kt",
                f"    split_own_chunks<D>({which} + stage * kTile, lo, tid);\n"
                "    __syncthreads();\n    const float* kt"))]
    if which == "ks":  # S from the split planes: two ldmatrix, no split
        return subs + [
            ("flash_mma.cuh", "__device__ __forceinline__ void tf32_scores(",
             "__device__ __forceinline__ void tf32_scores_split(float (&acc)[NT][4], "
             "const float* a, int arow, const float* bt, const float* bl, int b0, int lane) {\n"
             "#pragma unroll\n  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = "
             "acc[j][3] = 0.f;\n#pragma unroll 1\n  for (int ks = 0; ks < D / 8; ks += 2) {\n"
             "    uint32_t x[4], ah0[4], al0[4], ah1[4], al1[4];\n"
             "    ldsm_x4(x, a_addr_f32<D>(a, arow, ks, lane));\n    split_tf32(x, ah0, al0);\n"
             "    ldsm_x4(x, a_addr_f32<D>(a, arow, ks + 1, lane));\n    split_tf32(x, ah1, al1);\n"
             "#pragma unroll\n    for (int jj = 0; jj < NT / 2; ++jj) {\n"
             "      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};\n"
             "      uint32_t h[4], l[4];\n"
             "#pragma unroll\n      for (int k2 = 0; k2 < 2; ++k2) {\n"
             "        ldsm_x4(h, b_addr_f32<D>(bt, b0 + 16 * jj, ks + k2, lane));\n"
             "        ldsm_x4(l, b_addr_f32<D>(bl, b0 + 16 * jj, ks + k2, lane));\n"
             "        mma_3xtf32(t0, k2 ? ah1 : ah0, k2 ? al1 : al0, h[0], h[1], l[0], l[1]);\n"
             "        mma_3xtf32(t1, k2 ? ah1 : ah0, k2 ? al1 : al0, h[2], h[3], l[2], l[3]);\n"
             "      }\n      add_acc(acc[2 * jj], t0);\n      add_acc(acc[2 * jj + 1], t1);\n"
             "    }\n  }\n}\n\ntemplate <int D, int NT>\n"
             "__device__ __forceinline__ void tf32_scores("),
            ("flash_fwd.cu", SCORES, SCORES.replace("tf32_scores<D>(s, qs, wrow, kt,",
                                                    "tf32_scores_split<D>(s, qs, wrow, kt, lo,"))]
    # P.V from the split planes: four scalar reads, no split
    return subs + [
        ("flash_mma.cuh", "__device__ __forceinline__ void tf32_grads(",
         "__device__ __forceinline__ void tf32_grads_split(float (&acc)[D / 8][4], "
         "const float (&w)[NT][4], const float* bt, const float* bl, int r0, int lane) {\n"
         "  constexpr int kS = Layout<D>::kStride;\n#pragma unroll\n"
         "  for (int kk = 0; kk < NT; kk += 2) {\n"
         "    uint32_t ah0[4], al0[4], ah1[4], al1[4];\n"
         "    acc_to_a_tf32(ah0, al0, w[kk]);\n    acc_to_a_tf32(ah1, al1, w[kk + 1]);\n"
         "    const int off = (r0 + 8 * kk + 2 * (lane & 3)) * kS + (lane >> 2);\n"
         "#pragma unroll\n    for (int n = 0; n < D / 8; ++n) {\n"
         "      float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
         "      const float* h = bt + off + 8 * n;\n      const float* l = bl + off + 8 * n;\n"
         "      mma_3xtf32(t, ah0, al0, __float_as_uint(h[0]), __float_as_uint(h[kS]), "
         "__float_as_uint(l[0]), __float_as_uint(l[kS]));\n"
         "      mma_3xtf32(t, ah1, al1, __float_as_uint(h[8 * kS]), __float_as_uint(h[9 * kS]), "
         "__float_as_uint(l[8 * kS]), __float_as_uint(l[9 * kS]));\n"
         "      add_acc(acc[n], t);\n    }\n  }\n}\n\ntemplate <int D, int NT>\n"
         "__device__ __forceinline__ void tf32_grads("),
        ("flash_fwd.cu", GRADS, GRADS.replace("tf32_grads<D>(acc, s, vt,",
                                              "tf32_grads_split<D>(acc, s, vt, lo,"))]


def _variants() -> dict:
    with open(os.path.join(cuda_build.CSRC_DIR, "flash_fwd.cu")) as fh:
        source = fh.read()
    softmax = source[source.index("      // online softmax over the pass"):
                     source.index("      // O += P . V, P straight")]
    bounds = "__launch_bounds__(kMmaThreads, 1)\nflash_fwd_tf32_kernel"
    return {
        "current": [],
        "cvt": [("flash_mma.cuh", "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
                 "  return r;")],
        "default_bounds": [("flash_fwd.cu", bounds, bounds.replace(", 1)", ")"))],
        "keys32": [("flash_fwd.cu", "D == 128 ? 16 : D == 64 ? 64 : 32;", "D == 128 ? 16 : 32;")],
        "k_split_once": _split_once("ks"),
        "v_split_once": _split_once("vs"),
        "no_s": [("flash_fwd.cu", SCORES,
                  "      for (int j = 0; j < kKeyTiles; ++j)\n"
                  "        for (int e = 0; e < 4; ++e)\n"
                  "          s[j][e] = kt[(kc + 8 * j + 2 * t4 + (e & 1)) * 4 + (e >> 1)];")],
        "no_pv": [("flash_fwd.cu", GRADS, "      acc[0][0] += s[0][0] + s[kKeyTiles - 1][3];")],
        "no_softmax": [("flash_fwd.cu", softmax, "")],
    }


def _build(variants: dict) -> dict:
    """Each variant's ``moc_flash_fwd``, bound by ctypes; prints registers."""
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, d)
        for fname, old, new in subs:
            path = os.path.join(d, fname)
            with open(path) as fh:
                text = fh.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {fname} holds {text.count(old)} of {old[:60]!r}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        entry = None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                entry = chip_smoke._kernel_name(m.group(1))
            elif entry == "flash_fwd_tf32_kernel<64>" and (m := re.search(
                    r"Used (\d+) registers", line)):
                print(f"[variants] {name}: {m.group(1)} registers at D = 64", flush=True)
        fn = ctypes.CDLL(os.path.join(OUT, name, "lib.so")).moc_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call(fn, q, k, v, o, lse) -> None:
    b, h, lq, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), None, None,
             b * h, h, lq, k.shape[2], d, 0, 0, d ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the variants run on a GPU only", file=sys.stderr)
        return 1
    rounds = int(argv[0]) if argv else 2
    fns = _build(_variants())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cells = {}
    for cell, shape in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        cells[cell] = (q, k, v, *mha_reference(q, k, v))
    for r in range(rounds):
        for name, fn in fns.items():
            for cell, (q, k, v, ro, rlse) in cells.items():
                o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
                _call(fn, q, k, v, o, lse)
                torch.cuda.synchronize()
                rel = ((o - ro).abs().max() / ro.abs().max()).item()
                err_lse = (lse - rlse).abs().max().item()
                us = chip_smoke._gated_us(lambda: _call(fn, q, k, v, o, lse), 30)
                print(f"[variants] round {r} {name} {cell}: {chip_smoke._us(us)} a call queued, "
                      f"max |O - plain| {rel:.2e} of the largest |O|, max |lse - plain| "
                      f"{err_lse:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
