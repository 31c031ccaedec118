// Tensor-core pieces shared by the flash-attention kernels: K2's forward
// (flash_fwd.cu), K3's dq and K4's dk/dv (flash_bwd.cu), each in bf16 and in
// f32.
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
//   registers;
// - the f32 tier in three TF32 passes: a [64, D] f32 tile with rows padded
//   to D + 4 floats (Layout<D>::kStride, loaded by load_tile_f32_async),
//   ldmatrix of its untransposed operands, split_tf32 (x = hi + lo, both
//   rounded as cvt.rna.tf32.f32 rounds), mma_3xtf32 (hi.hi + hi.lo + lo.hi on
//   mma.sync m16n8k8, into a fresh accumulator that add_acc adds in f32),
//   acc_to_a_tf32 (an accumulator n-tile as an A fragment, with the k index
//   permuted so that no shuffle is needed), tf32_b_pair (the B fragment
//   that pairs with it, read as two scalars), and the two products built of
//   them: tf32_scores (a warp's 16 rows times a tile's rows, transposed: S)
//   and tf32_grads (accumulator n-tiles times a tile: P.V, dS.K), with
//   store_acc_f32 for the result.
//
// A warp owns 16 rows of a product. In the fragments of mma.sync,
// lane = 4 * g + t: an accumulator n-tile holds rows g and g + 8, columns
// 2t and 2t + 1 (elements 0, 1 and 2, 3); a bf16 A fragment (m16n8k16)
// holds (row g, cols 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8,
// 2t + 8..); a bf16 B fragment holds (k 2t..2t+1, col g) and (k 2t + 8..,
// col g). A TF32 A fragment (m16n8k8) holds (row g, k t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); a TF32 B fragment (k t, col g), (k t + 4,
// col g).

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

// ---- the f32 tier: three TF32 passes ----
//
// One TF32 pass keeps 10 bits of each mantissa, about three decimal digits,
// which misses the JAX package's f32 tolerances, forward (2e-5) and backward
// (5e-4). Each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi), both rounded to nearest with ties away from zero (as cvt.rna rounds);
// x - hi is exact in f32, so x = hi + lo within 2^-22 |x|. hi.hi + hi.lo + lo.hi leaves out lo.lo (at most
// 2^-22 |ab|): every product is within a few units in 2^-22 of its f32
// value, and the sums over k-steps are f32 adds, rounded to nearest (see
// mma_3xtf32). Nothing here reads or sets the process-global TF32 flags:
// the split is this code's own.

// rows [r0, r0 + 64) of a row-major [len, D] f32 slab into a [64, D] tile of
// rows padded to Layout<D>::kStride floats, by cp.async from all
// kMmaThreads threads; rows at or past `len` are zero. The padding of four
// floats puts the eight 16-byte rows of an ldmatrix phase on eight distinct
// bank groups, and the lanes of a scalar operand read (tf32_b_pair) on 32
// distinct banks.
template <int D>
__device__ __forceinline__ void load_tile_f32_async(float* __restrict__ dst,
                                                    const float* __restrict__ src, int r0,
                                                    int len, int tid) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  static_assert(kBlock * kChunks % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kBlock * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int row = e / kChunks;
    const int chunk = e % kChunks;
    const bool valid = r0 + row < len;
    const float* s = src + static_cast<size_t>(valid ? r0 + row : 0) * D + chunk * 4;
    cp_async16(dst + row * Layout<D>::kStride + chunk * 4, s, valid);
  }
}

// ldmatrix of four 8 x 8 b16 matrices from an f32 tile: each 16-byte row is
// four floats, so lane 4g + t receives float t of row g of each matrix,
// which is a TF32 fragment's own layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The lane's ldmatrix row address in an f32 tile (rows of kStride floats)
// whose rows start at `row0`, at k-step `ks` (columns 8ks .. 8ks + 7):
// - A (16 rows x 8 k): r[0..3] are a0..a3;
// - B from a [n][k] tile (keys x d for S = Q.K^T): n rows row0..row0+15 (two
//   n-tiles); r[0..1] are b0, b1 of n-tile 0 and r[2..3] of n-tile 1.
template <int D>
__device__ __forceinline__ const float* a_addr_f32(const float* tile, int row0, int ks,
                                                   int lane) {
  return tile + (row0 + (lane & 15)) * Layout<D>::kStride + 8 * ks + 4 * (lane >> 4);
}

template <int D>
__device__ __forceinline__ const float* b_addr_f32(const float* tile, int row0, int ks,
                                                   int lane) {
  return tile + (row0 + (lane & 7) + 8 * (lane >> 4)) * Layout<D>::kStride + 8 * ks +
         4 * ((lane >> 3) & 1);
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): half a unit of the 13 dropped bits added to the magnitude,
// then the bits dropped. Integer ops give the same bits; on an H100 K2 in
// f32 took a fifth longer with the cvt (scripts/flash_fwd_variants.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += a . b over one m16n8k8 step, TF32 inputs, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// t += a . b over one k-step in three TF32 passes, the two small terms
// first. The tensor core rounds its sum toward zero, so a running sum kept
// inside it drifts by half a unit in its last place at each of its 3 L / 8
// mma: on an H100 at L = 512 that came to 1e-5 of the largest |grad|. So
// `t` is a fresh accumulator that spans at most two k-steps, and add_acc
// takes it into the running sum by f32 adds, rounded to nearest: 2e-6 of
// the largest |grad| there. It also keeps the chains of dependent mma
// short.
__device__ __forceinline__ void mma_3xtf32(float (&t)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
}

__device__ __forceinline__ void add_acc(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// One accumulator n-tile (16 rows x 8 columns) as the A fragment of an
// m16n8k8 step over those 8 columns, split into hi and lo. The lane holds
// columns 2t and 2t + 1, where A wants k = t and t + 4, so the step takes
// its k index in the order of the columns 0, 2, 4, 6, 1, 3, 5, 7: k = t is
// column 2t and k = t + 4 is column 2t + 1. The B operand of the same step
// reads its rows in that order (tf32_b_pair), and no shuffle is needed.
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The B fragment, split, of a step whose k index is permuted as in
// acc_to_a_tf32: `p` points at row 2t (of the step's 8 rows) and column g
// of a [k][n] f32 tile with rows of kStride floats; b0 is that row and b1
// the next. With kStride = 4 mod 32 the 32 lanes read 32 distinct banks.
template <int D>
__device__ __forceinline__ void tf32_b_pair(const float* p, uint32_t& h0, uint32_t& h1,
                                            uint32_t& l0, uint32_t& l1) {
  split_tf32(p[0], h0, l0);
  split_tf32(p[Layout<D>::kStride], h1, l1);
}

// acc[j] = (16 rows of a from row `arow`) . (rows b0 + 8j .. b0 + 8j + 7 of
// bt)^T over D, for the NT n-tiles of a pass: S (K2, K3), dP (K3) or s^T,
// dp^T (K4). Two k-steps a fresh accumulator; the A fragments of both steps
// are split once and serve every n-tile.
template <int D, int NT>
__device__ __forceinline__ void tf32_scores(float (&acc)[NT][4], const float* a, int arow,
                                            const float* bt, int b0, int lane) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < D / 8; ks += 2) {
    uint32_t x[4], ah0[4], al0[4], ah1[4], al1[4];
    ldsm_x4(x, a_addr_f32<D>(a, arow, ks, lane));
    split_tf32(x, ah0, al0);
    ldsm_x4(x, a_addr_f32<D>(a, arow, ks + 1, lane));
    split_tf32(x, ah1, al1);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t h[4], l[4];
      ldsm_x4(x, b_addr_f32<D>(bt, b0 + 16 * jj, ks, lane));
      split_tf32(x, h, l);
      mma_3xtf32(t0, ah0, al0, h[0], h[1], l[0], l[1]);
      mma_3xtf32(t1, ah0, al0, h[2], h[3], l[2], l[3]);
      ldsm_x4(x, b_addr_f32<D>(bt, b0 + 16 * jj, ks + 1, lane));
      split_tf32(x, h, l);
      mma_3xtf32(t0, ah1, al1, h[0], h[1], l[0], l[1]);
      mma_3xtf32(t1, ah1, al1, h[2], h[3], l[2], l[3]);
      add_acc(acc[2 * jj], t0);
      add_acc(acc[2 * jj + 1], t1);
    }
  }
}

// acc[n] += w . (rows r0 .. r0 + 8 NT - 1 of bt), w being NT accumulator
// n-tiles (16 rows x 8 NT columns: p for o (K2), ds for dq, p^T or ds^T for
// dv or dk) taken as the A operand with the k index of acc_to_a_tf32; two
// k-steps a fresh accumulator
template <int D, int NT>
__device__ __forceinline__ void tf32_grads(float (&acc)[D / 8][4], const float (&w)[NT][4],
                                           const float* bt, int r0, int lane) {
  static_assert(NT % 2 == 0, "k-steps in pairs");
  constexpr int kS = Layout<D>::kStride;
#pragma unroll
  for (int kk = 0; kk < NT; kk += 2) {
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    acc_to_a_tf32(ah0, al0, w[kk]);
    acc_to_a_tf32(ah1, al1, w[kk + 1]);
    const float* b = bt + (r0 + 8 * kk + 2 * (lane & 3)) * kS + (lane >> 2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t h0, h1, l0, l1;
      tf32_b_pair<D>(b + 8 * n, h0, h1, l0, l1);
      mma_3xtf32(t, ah0, al0, h0, h1, l0, l1);
      tf32_b_pair<D>(b + 8 * kS + 8 * n, h0, h1, l0, l1);
      mma_3xtf32(t, ah1, al1, h0, h1, l0, l1);
      add_acc(acc[n], t);
    }
  }
}

// a warp's [16, D] f32 accumulator (rows r and r + 8 of n-tiles of 8
// columns, r = row0 + g) into a row-major [len, D] f32 slab; rows at or
// past `len` dropped
template <int D>
__device__ __forceinline__ void store_acc_f32(float* __restrict__ dst, const float (&acc)[D / 8][4],
                                              int row0, int len, int lane) {
  const int r = row0 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r < len) {
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r) * D + 8 * n + col) =
          make_float2(acc[n][0], acc[n][1]);
    }
    if (r + 8 < len) {
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r + 8) * D + 8 * n + col) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

}  // namespace flash
