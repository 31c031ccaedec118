// Pieces shared by the flash-attention kernels K2 (flash_fwd.cu) and K3/K4
// (flash_bwd.cu): the tile size, the mask value and the mask test, which
// every kernel uses; the f32 tile layout (Layout: 64 rows padded to D + 4
// floats), which K2's f32 kernel and the f32 tier of K3/K4 (three TF32
// passes on the tensor cores) both stage in shared memory; and, for K2's
// f32 kernel, the last one on the CUDA cores, its tile loads, products and
// stores and the map from a thread to the output columns it owns. The
// tensor-core kernels take their other pieces from flash_mma.cuh.
//
// K2's f32 kernel runs 256 threads as a 16 x 16 grid: ty = tid >> 4 owns rows
// 4*ty .. 4*ty+3 of a 64-row tile, tx = tid & 15 owns keys tx + 16*j of a
// 64-key tile in the score products, and the columns ColMap<D>::col(tx, c)
// of a D-wide accumulator.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace flash {

constexpr int kBlock = 64;  // rows of a query tile and of a key tile
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the JAX package's DEFAULT_MASK_VALUE, rounded to f32 as jnp.where does
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

template <int D>
struct Layout {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  // floats per staged row: float4 reads, ldmatrix phases and the TF32 tiers'
  // scalar operand reads (rows 2t, 2t + 1 at column g) free of bank conflicts
  static constexpr int kStride = D + 4;
  static constexpr int kPStride = kBlock + 4;  // floats per staged row of a 64 x 64 score tile
  static constexpr int kTile = kBlock * kStride;
  static constexpr int kPTile = kBlock * kPStride;
};

// The D / 16 accumulator columns a thread owns in each row: kGroups groups
// of kG neighbouring columns (float4, or float2 when D == 32), so the 16
// threads of a row read and write neighbouring addresses.
template <int D>
struct ColMap {
  static constexpr int kPer = D / 16;
  static constexpr int kG = kPer < 4 ? kPer : 4;
  static constexpr int kGroups = kPer / kG;
  __device__ __forceinline__ static int col(int tx, int c) { return c * 16 * kG + kG * tx; }
};

// kG floats from 8- or 16-byte aligned shared memory
template <int G>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (G == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
    static_assert(G == 2, "groups of 2 or 4 columns");
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  }
}

// rows [r0, r0 + 64) of a row-major [len, D] f32 slab into shared memory;
// rows at or past `len` are zero
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src, float* __restrict__ dst,
                                          int r0, int len) {
  constexpr int kPerRow = D / 4;
  for (int e = threadIdx.x; e < kBlock * kPerRow; e += kThreads) {
    const int row = e / kPerRow;
    const int col = (e % kPerRow) * 4;
    *reinterpret_cast<float4*>(dst + row * Layout<D>::kStride + col) =
        r0 + row < len
            ? *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + row) * D + col)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// G neighbouring values (times `scale`) stored as f32
template <int G>
__device__ __forceinline__ void store_group(float* dst, const float* x, float scale) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0] * scale, x[1] * scale);
  }
}

// a [rows, D] accumulator of a thread (rows 4*ty + i, columns of ColMap) stored
// to a row-major [len, D] f32 slab from row r0, rows at or past `len` dropped
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (*acc)[D / 16],
                                           const float* scale, int r0, int len, int ty, int tx) {
  using Cols = ColMap<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= len) continue;
    float* out = dst + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < Cols::kGroups; ++c) {
      store_group<Cols::kG>(out + Cols::col(tx, c), &acc[i][c * Cols::kG], scale[i]);
    }
  }
}

// s[i][j] += a[4*ty + i] . b[tx + 16*j] over D, both tiles staged with Layout<D>
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a, const float* __restrict__ b,
                                         float (&s)[4][4], int ty, int tx) {
  constexpr int kS = Layout<D>::kStride;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (4 * ty + i) * kS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(av[i].x, bv[j].x, x);
        x = fmaf(av[i].y, bv[j].y, x);
        x = fmaf(av[i].z, bv[j].z, x);
        x = fmaf(av[i].w, bv[j].w, x);
        s[i][j] = x;
      }
    }
  }
}

// acc[i][:] += sum_kk w[4*ty + i][kk] * m[kk][cols]: a 64 x 64 weight tile
// (row stride kPStride, rows 4*ty + i) times a staged 64 x D tile
template <int D>
__device__ __forceinline__ void tile_accumulate(const float* __restrict__ w,
                                                const float* __restrict__ m,
                                                float (&acc)[4][D / 16], int ty, int tx) {
  using Cols = ColMap<D>;
  constexpr int kS = Layout<D>::kStride;
  constexpr int kP = Layout<D>::kPStride;
#pragma unroll 2
  for (int kk = 0; kk < kBlock; kk += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = *reinterpret_cast<const float4*>(w + (4 * ty + i) * kP + kk);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int c = 0; c < Cols::kGroups; ++c) {
        float mv[Cols::kG];
        lds<Cols::kG>(m + (kk + t) * kS + Cols::col(tx, c), mv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = t == 0 ? wv[i].x : t == 1 ? wv[i].y : t == 2 ? wv[i].z : wv[i].w;
#pragma unroll
          for (int e = 0; e < Cols::kG; ++e) {
            acc[i][c * Cols::kG + e] = fmaf(x, mv[e], acc[i][c * Cols::kG + e]);
          }
        }
      }
    }
  }
}

// true where key `key` is hidden from query `row` (top-left causal, or
// another segment): the score takes kMaskValue there and still counts
__device__ __forceinline__ bool masked(bool causal, bool segments, int row, int key, int row_seg,
                                       int key_seg) {
  return (causal && key > row) || (segments && key_seg != row_seg);
}

// opt a kernel in to `bytes` of dynamic shared memory (above 48 KB needs it)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
