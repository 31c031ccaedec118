// Tensor-core pieces shared by the bf16 flash-attention kernels: K2's
// forward (flash_fwd.cu), K3's dq and K4's dk/dv (flash_bwd.cu).
//
// - cp_async16 / cp_async4: global -> shared copies (cp.async), zero-filled
//   for rows at or past the end of a slab (the ragged 785-token edge), with
//   commit / wait for a two-stage ring;
// - Tile<D>: a [64, D] bf16 tile in shared memory, rows of D/8 16-byte
//   chunks, the chunk index XOR-swizzled by the row so that the eight row
//   addresses of every ldmatrix phase hit eight distinct 16-byte bank
//   groups (free of bank conflicts without padding);
// - ldsm_x4 / ldsm_x4_trans: ldmatrix of four 8 x 8 bf16 matrices, plain or
//   transposed;
// - mma_bf16: mma.sync m16n8k16, bf16 inputs, f32 accumulators;
// - acc_to_a: two f32 accumulator fragments (16 x 16) rounded to bf16 as
//   one A fragment, so P and dS pass from one product to the next in
//   registers.
//
// A warp owns 16 rows of a product. In the fragments of mma.sync,
// lane = 4 * g + t: an accumulator n-tile holds rows g and g + 8, columns
// 2t and 2t + 1 (elements 0, 1 and 2, 3); an A fragment holds (row g, cols
// 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); a B fragment
// holds (k 2t..2t+1, col g) and (k 2t + 8.., col g).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;  // 16 rows each: one 64-row tile
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or zero when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static constexpr int kElems = kBlock * D;
  static constexpr int kBytes = kElems * 2;
  // bf16 offset of chunk `chunk` of row `row`. A 128-byte line holds 8
  // chunks: rows of 8 or 16 chunks XOR their low 3 bits with row & 7; rows
  // of 4 chunks (D = 32, two rows a line) XOR with (row >> 1) & 3.
  __device__ __forceinline__ static int offset(int row, int chunk) {
    const int x = D == 32 ? (row >> 1) & 3 : row & 7;
    return row * D + ((chunk ^ x) << 3);
  }
};

// rows [r0, r0 + 64) of a row-major [len, D] bf16 slab into a Tile<D>, by
// cp.async from all kMmaThreads threads; rows at or past `len` are zero
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* __restrict__ dst,
                                                const bf16* __restrict__ src, int r0, int len,
                                                int tid) {
  constexpr int kChunks = Tile<D>::kChunks;
  static_assert(kBlock * kChunks % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kBlock * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int row = e / kChunks;
    const int chunk = e % kChunks;
    const bool valid = r0 + row < len;
    const bf16* s = src + static_cast<size_t>(valid ? r0 + row : 0) * D + chunk * 8;
    cp_async16(dst + Tile<D>::offset(row, chunk), s, valid);
  }
}

// entries [r0, r0 + 64) of a 4-byte vector of length `len` into shared
// memory, zero past `len`: entry r0 + i by the thread that passes i, for
// i in [0, 64); other values of i copy nothing
template <typename T>
__device__ __forceinline__ void load_vec_async(T* __restrict__ dst, const T* __restrict__ src,
                                               int r0, int len, int i) {
  if (static_cast<unsigned>(i) < kBlock) {
    const bool valid = r0 + i < len;
    cp_async4(dst + i, src + (valid ? r0 + i : 0), valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The lane's ldmatrix row address for the three operand shapes, over a
// Tile<D> whose rows start at `row0`:
// - A (16 rows x 16 k, row-major): rows row0.., k-step `ks` (chunks 2ks, 2ks+1);
// - B from a [n][k] tile (keys x d for S = Q.K^T): n rows row0..row0+15
//   (two n-tiles), k-step `ks`; r[0..1] feed n-tile 0, r[2..3] n-tile 1;
// - B from a [k][n] tile by .trans (keys x d for P.V): k rows row0..row0+15,
//   n-tiles 2dd and 2dd + 1 (chunks 2dd, 2dd + 1).
template <int D>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int row0, int ks, int lane) {
  return tile + Tile<D>::offset(row0 + (lane & 15), 2 * ks + (lane >> 4));
}

template <int D>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int row0, int ks, int lane) {
  return tile + Tile<D>::offset(row0 + (lane & 7) + ((lane >> 4) << 3), 2 * ks + ((lane >> 3) & 1));
}

template <int D>
__device__ __forceinline__ const bf16* bt_addr(const bf16* tile, int row0, int dd, int lane) {
  return tile + Tile<D>::offset(row0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dd + (lane >> 4));
}

// d += a . b over one m16n8k16 step: exact bf16 products summed in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator n-tiles c0 (columns 0..7) and c1 (8..15) of 16 rows, rounded
// to bf16, as the A fragment of the k-step that spans those 16 columns
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// a warp's [16, D] f32 accumulator (rows g and g + 8 of n-tiles of 8
// columns), times the row scales s0 (row g) and s1 (row g + 8), as bf16 into
// rows row0.. of a Tile<D>
template <int D>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[D / 8][4], float s0,
                                           float s1, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + Tile<D>::offset(row0 + g, n) + 2 * t) =
        pack_bf16(acc[n][0] * s0, acc[n][1] * s0);
    *reinterpret_cast<uint32_t*>(tile + Tile<D>::offset(row0 + g + 8, n) + 2 * t) =
        pack_bf16(acc[n][2] * s1, acc[n][3] * s1);
  }
}

// rows row0..row0+15 of a Tile<D> to rows r0 + row0.. of a row-major [len,
// D] bf16 slab in 16-byte stores by one warp; rows at or past `len` dropped
template <int D>
__device__ __forceinline__ void store_rows_16(bf16* __restrict__ dst, const bf16* tile, int row0,
                                              int r0, int len, int lane) {
  constexpr int kChunks = Tile<D>::kChunks;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int row = row0 + e / kChunks;
    const int chunk = e % kChunks;
    if (r0 + row < len) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + row) * D + chunk * 8) =
          *reinterpret_cast<const uint4*>(tile + Tile<D>::offset(row, chunk));
    }
  }
}

}  // namespace flash
