// Register-level pieces of the flash-attention kernels K2 (flash_fwd.cu) and
// K3/K4 (flash_bwd.cu), all built on Hopper's wgmma (flash_sm90.cuh), whose
// accumulators and register A operands keep mma.sync's fragment layout:
//
// - cp_async4: a 4-byte global -> shared copy (cp.async), zero-filled past
//   the end of a vector, which an mbarrier arrival waits for (K4's lse,
//   delta and segment ids);
// - pack_bf16: two f32 values rounded to one bf16 pair (the bf16 kernels'
//   register A operands);
// - the f32 tier's split: to_tf32 and split_tf32 (x = hi + lo, both rounded
//   as cvt.rna.tf32.f32 rounds), and acc_to_a_tf32, an accumulator n-tile
//   as the split A fragment of an m16n8k8 step, with the k index permuted
//   so that no shuffle is needed.
//
// A warp owns 16 rows of a product. In the fragments, lane = 4 * g + t: an
// accumulator n-tile holds rows g and g + 8, columns 2t and 2t + 1
// (elements 0, 1 and 2, 3); a TF32 A fragment (m16n8k8) holds (row g, k t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes global -> shared, or zero when !valid (src unread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the f32 tier: three TF32 passes ----
//
// One TF32 pass keeps 10 bits of each mantissa, about three decimal digits,
// which misses the JAX package's f32 tolerances, forward (2e-5) and backward
// (5e-4). Each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi), both rounded to nearest with ties away from zero (as cvt.rna rounds);
// x - hi is exact in f32, so x = hi + lo within 2^-22 |x|. hi.hi + hi.lo +
// lo.hi leaves out lo.lo (at most 2^-22 |ab|): every product is within a few
// units in 2^-22 of its f32 value. Nothing here reads or sets the
// process-global TF32 flags: the split is this code's own.

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): half a unit of the 13 dropped bits added to the magnitude,
// then the bits dropped. Integer ops give the same bits; on an H100 K2 in
// f32 took a fifth longer with the cvt (the `cvt` variant of
// scripts/flash_fwd_tf32_wgmma_variants.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// One accumulator n-tile (16 rows x 8 columns) as the A fragment of an
// m16n8k8 step over those 8 columns, split into hi and lo. The lane holds
// columns 2t and 2t + 1, where A wants k = t and t + 4, so the step takes
// its k index in the order of the columns 0, 2, 4, 6, 1, 3, 5, 7: k = t is
// column 2t and k = t + 4 is column 2t + 1. The B operand of the same step
// lies in that order (flash_tf32.cuh's transpose_tile), and no shuffle is
// needed.
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

}  // namespace flash
