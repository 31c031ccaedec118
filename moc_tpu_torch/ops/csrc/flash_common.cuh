// Pieces shared by the flash-attention kernels K2 (flash_fwd.cu) and K3/K4
// (flash_bwd.cu): the mask value and the mask test, which every kernel
// uses. The register-level pieces are in flash_mma.cuh, the Hopper ones in
// flash_sm90.cuh and the f32 tier's splits and transposes in
// flash_tf32.cuh.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace flash {

constexpr unsigned kFull = 0xFFFFFFFFu;
// the JAX package's DEFAULT_MASK_VALUE, rounded to f32 as jnp.where does
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

// true where key `key` is hidden from query `row` (top-left causal, or
// another segment): the score takes kMaskValue there and still counts
__device__ __forceinline__ bool masked(bool causal, bool segments, int row, int key, int row_seg,
                                       int key_seg) {
  return (causal && key > row) || (segments && key_seg != row_seg);
}

}  // namespace flash
