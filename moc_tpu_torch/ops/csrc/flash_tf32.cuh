// The f32 tier on Hopper: what K2's flash_fwd_tf32_wgmma_kernel
// (flash_fwd.cu) and K3's and K4's flash_bwd_dq_tf32_wgmma_kernel and
// flash_bwd_dkv_tf32_wgmma_kernel (flash_bwd.cu) share. Every product is
// taken in three TF32 passes (hi.hi + hi.lo + lo.hi) of operands split as
// hi = tf32(x), lo = tf32(x - hi) (flash_mma.cuh's split_tf32), and wgmma
// takes 32-bit operands from shared memory K-major only (flash_sm90.cuh).
// A tile lands by TMA in boxes of 32 f32 columns, a box row 128 bytes,
// 128-byte swizzled, a box's rows apart:
//
// - split_tile: a landed tile split in place, hi over x and lo at the same
//   offset of another tile, 16 bytes a thread at a time (K2);
// - the backward's split, by the rule the tensor core follows: it drops the
//   low 13 bits of an f32 operand, so a landed tile serves as its own hi
//   (tf32(x) with x's low bits cleared) and only lo = tf32(x - hi) is
//   written (lo_of_raw, split_lo_tile). hi + lo is x within 2^-21 |x|. A
//   probe of the rule (scripts/flash_bwd_tf32_wgmma_variants.py, `trunc`)
//   kept the gradients within 3.4e-6 of the largest |grad| of float64 ones,
//   where a tensor core that rounded the low bits would have left them about
//   2^-11 off;
// - transpose_tile: a landed tile [N rows, D] as its transpose [D rows, N]
//   in hi and lo, the operand of a product whose reduction index is the
//   tile's row (K3's dS.K reduces over keys, K4's gradients over queries).
//   Each 8 rows lie in the order 0, 2, 4, 6, 1, 3, 5, 7, the k index that an
//   accumulator passes on as an A fragment with no shuffle (acc_to_a_tf32);
// - kmajor_desc: the descriptor of a K-major tf32 operand;
// - acc_to_a_tf32 of a whole accumulator: its 8-column blocks as the split
//   A fragments of the k-steps of a register product.

#pragma once

#include <cstdint>

#include "flash_mma.cuh"
#include "flash_sm90.cuh"

namespace flash {

// x split as hi = tf32(x), lo = tf32(x - hi), for four values at once
__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// Chunk i0 + n * Threads of a tile, for n in [n0, n0 + N), split in place: hi
// over x, lo at the same offset of `lo`; all N loads are issued first
template <int N, int Threads>
__device__ __forceinline__ void split_chunks(unsigned char* hi, unsigned char* lo, int i0,
                                             int n0) {
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x[n] = *reinterpret_cast<const float4*>(hi + 16 * (i0 + (n0 + n) * Threads));
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int i = i0 + (n0 + n) * Threads;
    uint4 h, l;
    split4(x[n], h, l);
    *reinterpret_cast<uint4*>(hi + 16 * i) = h;
    *reinterpret_cast<uint4*>(lo + 16 * i) = l;
  }
}

// A tile of `Bytes` split in place, 16 bytes at a time by `Threads` threads
// (this one the i0-th), four loads in flight; the layout (boxes, swizzle)
// stays as it landed
template <int Bytes, int Threads>
__device__ __forceinline__ void split_tile(unsigned char* hi, unsigned char* lo, int i0) {
  constexpr int kChunks = Bytes / 16, kFull = kChunks / Threads;  // chunks every thread has
#pragma unroll 1
  for (int n0 = 0; n0 + 4 <= kFull; n0 += 4) split_chunks<4, Threads>(hi, lo, i0, n0);
  if constexpr (kFull % 4 != 0) split_chunks<kFull % 4, Threads>(hi, lo, i0, kFull / 4 * 4);
  if constexpr (kChunks % Threads != 0) {
    if (i0 < kChunks % Threads) split_chunks<1, Threads>(hi, lo, i0, kFull);
  }
}

// lo of an f32 operand whose hi is x itself, as the tensor core takes it: x
// less x with its low 13 bits cleared, rounded as cvt.rna rounds
__device__ __forceinline__ uint32_t lo_of_raw(float x) {
  return to_tf32(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u));
}

__device__ __forceinline__ float4 lo_of_raw(const float4& x) {
  return make_float4(__uint_as_float(lo_of_raw(x.x)), __uint_as_float(lo_of_raw(x.y)),
                     __uint_as_float(lo_of_raw(x.z)), __uint_as_float(lo_of_raw(x.w)));
}

// lo of a landed tile of `Bytes` (which stays as it landed: its own hi) into
// `lo` at the same offsets, 16 bytes at a time by `Threads` threads (this one
// the i0-th), four loads in flight
template <int Bytes, int Threads>
__device__ __forceinline__ void split_lo_tile(const unsigned char* x, unsigned char* lo, int i0) {
  constexpr int kChunks = Bytes / 16;
#pragma unroll 1
  for (int i = i0; i < kChunks; i += 4 * Threads) {
    float4 v[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (i + n * Threads < kChunks) {
        v[n] = *reinterpret_cast<const float4*>(x + 16 * (i + n * Threads));
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (i + n * Threads < kChunks) {
        *reinterpret_cast<float4*>(lo + 16 * (i + n * Threads)) = lo_of_raw(v[n]);
      }
    }
  }
}

// The byte offset of (row d, column k) in a transposed tile of D rows and N
// columns. N >= 32: boxes of 32 columns (128-byte rows, 128-byte swizzle),
// D rows apart; N = 16: rows of 64 bytes, 64-byte swizzle. `chunk` is the
// 16-byte chunk of the row's box (0-7, or 0-3), `box` the box.
template <int D, int N>
__device__ __forceinline__ uint32_t transposed_off(int d, int box, int chunk) {
  if constexpr (N == 16) {
    return sm90::swizzle<64>(d * 64 + chunk * 16);
  } else {
    return box * D * 128 + sm90::swizzle<128>(d * 128 + chunk * 16);
  }
}

// column e of four rows of four floats, as one row
__device__ __forceinline__ float4 column(const float4 (&v)[4], int e) {
  return e == 0   ? make_float4(v[0].x, v[1].x, v[2].x, v[3].x)
         : e == 1 ? make_float4(v[0].y, v[1].y, v[2].y, v[3].y)
         : e == 2 ? make_float4(v[0].z, v[1].z, v[2].z, v[3].z)
                  : make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
}

// A tile [N rows, D] as TMA lands it (boxes of 32 columns, N rows apart) as
// its transpose [D rows, N] (transposed_off), hi (x itself) and lo
// (lo_of_raw), each 8 rows r of the source in the order 0, 2, 4, 6, 1, 3, 5,
// 7, so that rows 8a + par + 2m (m = 0..3) are the four floats of one 16-byte
// chunk. A task of a thread is such a quad of rows times four columns 4 c4 ..
// 4 c4 + 3: four 16-byte reads, a 4 x 4 transpose in registers and four
// 16-byte writes each of hi and lo. `Threads` threads (this one the i0-th,
// whole warps) share the tile. Lane 8r + i of a warp takes c4 = i (mod 8), par = (i >> 2) ^ (r
// & 1) and a = ((i >> 1) & 1) ^ (r >> 1) (mod 2), so that each 8-lane phase
// reads 8 distinct bank groups under the 128-byte swizzle (and at N >= 32
// writes them too); the warps and their iterations take the rest of a (a /
// 2) and c4 (c4 / 8).
template <int D, int N, int Threads>
__device__ __forceinline__ void transpose_tile(const unsigned char* x, unsigned char* t_hi,
                                               unsigned char* t_lo, int i0) {
  static_assert(N == 16 || N % 32 == 0, "16 rows, or whole 32-row boxes");
  constexpr int kBoxes = D / 32, kPairs = N / 16;  // of c4 / 8, of a / 2
  constexpr int kWarps = Threads / 32;
  const int lane = i0 & 31, r = lane >> 3, i = lane & 7;
  const int par = (i >> 2) ^ (r & 1), a_lo = ((i >> 1) & 1) ^ (r >> 1);
#pragma unroll 1
  for (int combo = i0 >> 5; combo < kBoxes * kPairs; combo += kWarps) {
    const int cb = combo % kBoxes, a = 2 * (combo / kBoxes) + a_lo;
    const int c4 = 8 * cb + i;
    const int box = a / 4, chunk = N == 16 ? 2 * a + par : 2 * (a % 4) + par;
    float4 v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t off = cb * N * 128 + sm90::swizzle<128>((8 * a + par + 2 * m) * 128 + i * 16);
      v[m] = *reinterpret_cast<const float4*>(x + off);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = transposed_off<D, N>(4 * c4 + e, box, chunk);
      const float4 col = column(v, e);
      *reinterpret_cast<float4*>(t_hi + off) = col;
      *reinterpret_cast<float4*>(t_lo + off) = lo_of_raw(col);
    }
  }
}

// the descriptor of a K-major tf32 operand at `addr`, in a tile of
// swizzled rows (128 bytes, or 64) laid out 8-row groups apart. The operand
// `off` bytes further in has the descriptor + off / 16: the address field
// takes addresses below 2^18 and does not carry.
template <int Swizzle = 128>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  uint64_t d = sm90::smem_desc<Swizzle>(addr, 16, 8 * Swizzle);
  // keep the compiler from hoisting what is computed from it out of the loop
  // around the caller: every k-step's descriptor, in registers for the whole
  // loop, would spill
  asm volatile("" : "+l"(d));
  return d;
}

// An accumulator of N columns split as the register A operand of a product
// over those columns, k-step kk from its 8-column block kk as acc_to_a_tf32
// packs it
template <int N>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4],
                                              const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    acc_to_a_tf32(hi[kk], lo[kk], reinterpret_cast<const float(&)[4]>(x[4 * kk]));
  }
}

}  // namespace flash
