// K1: exact per-row top-k MEMBERSHIP mask with jax.lax.top_k tie semantics.
//
// Replaces the Pallas TPU kernel moc_tpu/ops/topk_kernel.py::_threshold_kernel
// (launched by topk_threshold_mask_tpu). For each row of keys [R, N] (f32,
// row-major) it writes out[r, i] = 1 for exactly k entries: every key above
// the k-th largest value v_k, then the first (k - #above) keys equal to v_k
// in index order. -0.0 ties +0.0, as float comparison does.
//
// Bound: memory. The least traffic is one read of R*N*4 bytes and one write
// of R*N bytes; at the serving shapes that is a few MB, about a microsecond
// at 3.35 TB/s, so the kernel is bound by launch and latency in practice.
//
// Design: one CTA of 1024 threads per row. Keys map to a monotone u32 rank
// space. Four passes of an 8-bit radix select (256-bin shared histogram,
// most significant digit first) find v_k exactly; warp-aggregated atomics
// (__match_any_sync) keep tie-heavy rows from serialising on one bin. A last
// pass writes the mask, ranking ties in index order with a block-wide ballot
// scan carried across 1024-wide tiles. The row is re-read from global memory
// on every pass instead of being staged in shared memory, so any N works
// (131072 keys are 512 KB, more than a CTA's shared memory); L2 holds it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Order-preserving f32 -> u32 map (the radix-sort trick): flip every bit of
// a negative, set the sign bit of a non-negative. -0.0 is folded into +0.0.
__device__ __forceinline__ uint32_t monotone(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const float* __restrict__ keys, uint8_t* __restrict__ out,
                      int n, int k) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned warp_ties[kWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_remaining;

  const float* row = keys + static_cast<size_t>(blockIdx.x) * n;
  uint8_t* orow = out + static_cast<size_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // every lane of a warp runs the same number of iterations, so the warp
  // intrinsics below always see the full mask
  const int n_iter = (n + kThreads - 1) / kThreads * kThreads;

  // radix select: `prefix` holds the digits of v_k found so far and
  // `remaining` the rank of v_k among the keys that share them
  uint32_t prefix = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    const uint32_t hi_mask = shift == 24 ? 0u : (kFull << (shift + 8));
    for (int i = tid; i < n_iter; i += kThreads) {
      int digit = kBins;  // no bin: past the row or outside the prefix
      if (i < n) {
        const uint32_t u = monotone(row[i]);
        if ((u & hi_mask) == prefix) digit = static_cast<int>((u >> shift) & 0xFFu);
      }
      const unsigned peers = __match_any_sync(kFull, digit);
      if (digit < kBins && lane == __ffs(peers) - 1) {
        atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    if (tid == 0) {
      // walk the bins from the top until the one holding the remaining-th key
      unsigned above = 0;
      int b = kBins - 1;
      for (; b > 0; --b) {
        if (above + hist[b] >= static_cast<unsigned>(remaining)) break;
        above += hist[b];
      }
      s_prefix = prefix | (static_cast<uint32_t>(b) << shift);
      s_remaining = remaining - static_cast<int>(above);
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
  }

  // prefix == v_k; `remaining` ties at v_k complete the k members
  const uint32_t vk = prefix;
  const int fill = remaining;
  int ties_before_tile = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool in_row = i < n;
    const uint32_t u = in_row ? monotone(row[i]) : 0u;
    const bool tie = in_row && u == vk;
    const unsigned ballot = __ballot_sync(kFull, tie);
    if (lane == 0) warp_ties[warp] = static_cast<unsigned>(__popc(ballot));
    __syncthreads();
    int before = ties_before_tile + __popc(ballot & ((1u << lane) - 1u));
    int tile_ties = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += static_cast<int>(warp_ties[w]);
      tile_ties += static_cast<int>(warp_ties[w]);
    }
    if (in_row) orow[i] = static_cast<uint8_t>(u > vk || (tie && before < fill));
    __syncthreads();  // warp_ties is rewritten by the next tile
    ties_before_tile += tile_ties;
  }
}

}  // namespace

// keys [rows, n] f32 and out [rows, n] u8, both contiguous on the device;
// 1 <= k <= n. Launches on `stream` without synchronising and returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int moc_topk_threshold_mask_f32(const float* keys, uint8_t* out,
                                           int rows, int n, int k,
                                           cudaStream_t stream) {
  if (rows > 0) {
    topk_threshold_kernel<<<rows, kThreads, 0, stream>>>(keys, out, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
