// Pieces shared by the flash-attention kernels K2 (flash_fwd.cu) and K3/K4
// (flash_bwd.cu): the tile size, the mask value and the mask test, which
// every kernel uses; the f32 tile layout (Layout: 64 rows padded to D + 4
// floats), which the f32 tier of all three (three TF32 passes on the tensor
// cores) stages in shared memory; and the shared-memory opt-in. The
// tensor-core pieces are in flash_mma.cuh.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace flash {

constexpr int kBlock = 64;  // rows of a query tile and of a key tile
constexpr unsigned kFull = 0xFFFFFFFFu;
// the JAX package's DEFAULT_MASK_VALUE, rounded to f32 as jnp.where does
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

template <int D>
struct Layout {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  // floats per staged row: ldmatrix phases and the TF32 tiers' scalar
  // operand reads (rows 2t, 2t + 1 at column g) free of bank conflicts
  static constexpr int kStride = D + 4;
  static constexpr int kTile = kBlock * kStride;
};

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
