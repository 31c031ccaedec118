// K1: exact per-row top-k MEMBERSHIP mask with jax.lax.top_k tie semantics.
//
// Replaces the Pallas TPU kernel moc_tpu/ops/topk_kernel.py::_threshold_kernel
// (launched by topk_threshold_mask_tpu). For each row of f32 keys it writes
// out[r, i] = 1 for exactly k entries: every key above the k-th largest value
// v_k, then the first (k - #above) keys equal to v_k in index order. -0.0 ties
// +0.0, as float comparison does. A "row" is addressed by strides, so the
// same kernel serves contiguous [R, N] rows and the columns of a [B, N, C]
// tensor read in place (row r = column r % C of slide r / C).
//
// Bound: memory. The least traffic is one read of R*N*4 bytes and one write
// of R*N bytes; at the serving shapes that is a few MB, about a microsecond
// at 3.35 TB/s, so the kernel is bound by launch and latency in practice.
//
// Design, for latency:
// - Each row is split over a thread-block cluster of 1-8 CTAs (the wrapper
//   picks the size from R and N so that R x cluster fills the SMs where the
//   row is long enough). Each CTA reads its slice from device memory once,
//   with 16-byte loads where the layout allows, into dynamic shared memory,
//   already mapped to the monotone u32 rank space, and counts the first
//   digit on the way. Rows too long for a cluster of 8 to stage (over 8 x
//   kMaxStagedKeys keys) take the same code with the slice re-read from
//   device memory on every pass instead.
// - Up to four 8-bit radix passes find v_k. A thread takes 4 keys a step.
//   Each warp counts into its own 256-bin histogram in shared memory (a warp
//   whose 128 keys share one digit adds 128 once, so tie-heavy rows do not
//   serialise on one bin); the warp copies are summed per CTA, and the CTAs
//   of the cluster add each other's sums through distributed shared memory
//   after one cluster barrier a pass (the sums are double-buffered, so a peer
//   never reads a buffer that is being rewritten). One warp then finds the
//   bin holding the remaining-th key with a suffix scan over the bins by
//   shuffles.
// - When the chosen bin holds exactly the keys still needed, every key of it
//   is a member and the search stops early: the mask is "the digits found so
//   far reach the prefix" (after the fourth pass that is u >= v_k). Only when
//   more keys equal v_k than the fill are they ranked: each thread owns a
//   contiguous run of its CTA's slice, counts its ties, takes one block-wide
//   exclusive scan, and adds the tie counts of the CTAs before it in the
//   cluster through distributed shared memory.
// - The mask is written 4 bytes at a time where the output is contiguous
//   along the row; columns of [B, N, C] are written a byte at a time.
// - Every CTA of a cluster passes a last cluster barrier before it exits, so
//   no CTA leaves while a peer still reads its shared memory.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
// keys a CTA stages in shared memory (192 KB); ops/topk_kernel.py's
// MAX_STAGED_KEYS mirrors it
constexpr int kMaxStagedKeys = 49152;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Order-preserving f32 -> u32 map (the radix-sort trick): flip every bit of
// a negative, set the sign bit of a non-negative. -0.0 is folded into +0.0.
__device__ __forceinline__ uint32_t monotone(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct Job {
  const float* keys;
  uint8_t* out;
  int n, k, cols, slice;          // slice: keys per CTA, a multiple of 4
  long long key_b, key_c, key_n;  // element strides of slide, column, key
  long long out_b, out_c, out_n;  // byte strides of the bool output
  bool vec_in, vec_out;           // 16-byte loads, 4-byte stores allowed
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) topk_cluster_kernel(Job job) {
  extern __shared__ __align__(16) uint32_t s_keys[];  // the slice, rank space
  __shared__ unsigned warp_hist[kWarps][kBins];
  __shared__ unsigned cta_hist[2][kBins];  // read by the peers, double-buffered
  __shared__ unsigned merged[kBins];
  __shared__ unsigned warp_ties[kWarps];
  __shared__ unsigned s_ties;  // this CTA's keys equal to v_k (read by peers)
  __shared__ uint32_t s_prefix;
  __shared__ unsigned s_remaining, s_count;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = blockIdx.x;
  const long long start = static_cast<long long>(rank) * job.slice;
  const float* row = job.keys + (r / job.cols) * job.key_b + (r % job.cols) * job.key_c +
                     start * job.key_n;
  uint8_t* orow = job.out + (r / job.cols) * job.out_b + (r % job.cols) * job.out_c +
                  start * job.out_n;
  const int len = static_cast<int>(
      max(0LL, min(static_cast<long long>(job.slice), job.n - start)));

  // key i of the slice in rank space
  auto key = [&](int i) -> uint32_t {
    if constexpr (kStaged) {
      return s_keys[i];
    } else {
      return monotone(row[i * job.key_n]);
    }
  };
  // keys i..i+3 (i a multiple of 4) into u; returns how many lie in the slice
  auto fetch4 = [&](int i, uint32_t (&u)[4]) -> int {
    const int valid = min(4, len - i);
    if (kStaged && valid == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(s_keys + i);
      u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    } else {
      for (int j = 0; j < 4; ++j) u[j] = j < valid ? key(i + j) : 0u;
    }
    return valid;
  };
  // count keys u[0..valid) that share `prefix` on `hi_mask` into the warp's
  // histogram by their digit at `shift`; a warp whose 128 keys all fall in
  // one bin adds 128 once. Every lane of the warp calls it.
  auto count4 = [&](unsigned* hist, const uint32_t (&u)[4], int valid, uint32_t hi_mask,
                    uint32_t prefix, int shift) {
    int d[4];
    for (int j = 0; j < 4; ++j) {
      d[j] = j < valid && (u[j] & hi_mask) == prefix ? static_cast<int>((u[j] >> shift) & 0xFFu)
                                                      : kBins;
    }
    const bool same = d[0] == d[1] && d[1] == d[2] && d[2] == d[3];
    const int first = __shfl_sync(kFull, d[0], 0);
    if (__all_sync(kFull, same && d[0] == first)) {
      if (lane == 0 && first < kBins) atomicAdd(&hist[first], 128u);
    } else {
      for (int j = 0; j < 4; ++j) {
        if (d[j] < kBins) atomicAdd(&hist[d[j]], 1u);
      }
    }
  };

  // every lane of a warp runs the same iterations: the votes see all 32
  const int n_iter = (len + 4 * kThreads - 1) / (4 * kThreads) * (4 * kThreads);
  // each warp's histogram starts at zero, and is zeroed again as it is summed
  unsigned* hist = warp_hist[warp];
  for (int b = lane; b < kBins; b += 32) hist[b] = 0;
  __syncwarp();
  if constexpr (kStaged) {
    // stage the slice in rank space, counting the first digit on the way
    for (int i = 4 * tid; i < n_iter; i += 4 * kThreads) {
      const int valid = min(4, len - i);
      uint32_t u[4];
      if (job.vec_in && valid == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + i));
        u[0] = monotone(v.x), u[1] = monotone(v.y), u[2] = monotone(v.z), u[3] = monotone(v.w);
        *reinterpret_cast<uint4*>(s_keys + i) = make_uint4(u[0], u[1], u[2], u[3]);
      } else {
        for (int j = 0; j < 4; ++j) {
          u[j] = j < valid ? monotone(row[(i + j) * job.key_n]) : 0u;
          if (j < valid) s_keys[i + j] = u[j];
        }
      }
      count4(hist, u, valid, 0u, 0u, 24);
    }
  }

  // radix select: `prefix` holds the digits of v_k found so far (the bits
  // under `done`), `remaining` the rank of v_k among the keys of the row
  // that share them, `count` the number of those keys
  uint32_t prefix = 0, done = 0;
  unsigned remaining = static_cast<unsigned>(job.k), count = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (!kStaged || pass > 0) {
      for (int i = 4 * tid; i < n_iter; i += 4 * kThreads) {
        uint32_t u[4];
        const int valid = fetch4(i, u);
        count4(hist, u, valid, done, prefix, shift);
      }
    }
    __syncthreads();
    unsigned* mine = cta_hist[pass & 1];
    for (int b = tid; b < kBins; b += kThreads) {
      unsigned s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += warp_hist[w][b];
        warp_hist[w][b] = 0;
      }
      mine[b] = s;
    }
    // the row's histogram: this CTA's own, or the sum over the cluster
    const unsigned* totals = mine;
    if (n_ctas > 1) {
      cluster.sync();  // every CTA's sums for this pass are written
      for (int b = tid; b < kBins; b += kThreads) {
        unsigned v[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          v[q] = q < n_ctas ? cluster.map_shared_rank(mine, q)[b] : 0u;
        }
        unsigned s = 0;
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) s += v[q];
        merged[b] = s;
      }
      totals = merged;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 8l..8l+7; `suffix` counts the keys in them and in
      // every bin above, so exactly one lane holds the remaining-th key
      unsigned h[8], total = 0;
      for (int j = 0; j < 8; ++j) {
        h[j] = totals[lane * 8 + j];
        total += h[j];
      }
      unsigned suffix = total;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_down_sync(kFull, suffix, off);
        if (lane + off < 32) suffix += v;
      }
      unsigned above = suffix - total;
      if (above < remaining && remaining <= suffix) {
        int j = 7;
        for (; j > 0 && above + h[j] < remaining; --j) above += h[j];
        s_prefix = prefix | (static_cast<uint32_t>(lane * 8 + j) << shift);
        s_remaining = remaining - above;
        s_count = h[j];
      }
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
    count = s_count;
    done |= 0xFFu << shift;
    // every key of the chosen bin is a member: its lower digits do not matter
    if (count == remaining) break;
  }

  // bits: byte j is the mask of key i + j; i is a multiple of 4
  auto store4 = [&](int i, unsigned bits) {
    if (job.vec_out && i + 4 <= len) {
      *reinterpret_cast<uint32_t*>(orow + i) = bits;
    } else {
      for (int j = 0; j < 4 && i + j < len; ++j) {
        orow[(i + j) * job.out_n] = static_cast<uint8_t>((bits >> (8 * j)) & 1u);
      }
    }
  };
  if (count == remaining) {
    // the members are the keys whose digits so far reach the prefix
    for (int i = 4 * tid; i < len; i += 4 * kThreads) {
      uint32_t u[4];
      fetch4(i, u);
      unsigned bits = 0;
      for (int j = 0; j < 4; ++j) bits |= static_cast<unsigned>((u[j] & done) >= prefix) << (8 * j);
      store4(i, bits);
    }
  } else {
    // prefix == v_k, and the first `fill` of the `count` keys equal to it
    // complete the k members: rank them in index order. Each thread owns a
    // run of `per` keys, an odd number of 16-byte chunks, so that the runs'
    // chunks of 8 neighbouring threads fall in distinct banks.
    const uint32_t vk = prefix;
    const unsigned fill = remaining;
    const int per = 4 * ((((len + kThreads - 1) / kThreads + 3) / 4) | 1);
    const int lo = min(len, tid * per);
    const int hi = min(len, lo + per);
    unsigned ties = 0;
    for (int i = lo; i < hi; i += 4) {
      uint32_t u[4];
      const int valid = fetch4(i, u);
      for (int j = 0; j < valid; ++j) ties += u[j] == vk;
    }
    unsigned incl = ties;
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_ties[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned w = lane < kWarps ? warp_ties[lane] : 0u;
      unsigned wi = w;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, wi, off);
        if (lane >= off) wi += v;
      }
      if (lane < kWarps) warp_ties[lane] = wi - w;  // exclusive, per warp
      if (lane == 31) s_ties = wi;
    }
    if (n_ctas > 1) {
      cluster.sync();  // every CTA's tie count is written
    } else {
      __syncthreads();
    }
    unsigned before = warp_ties[warp] + incl - ties;
    for (int q = 0; q < rank; ++q) before += *cluster.map_shared_rank(&s_ties, q);
    for (int i = lo; i < hi; i += 4) {
      uint32_t u[4];
      const int valid = fetch4(i, u);
      unsigned bits = 0;
      for (int j = 0; j < valid; ++j) {
        const bool tie = u[j] == vk;
        bits |= static_cast<unsigned>(u[j] > vk || (tie && before < fill)) << (8 * j);
        before += tie;
      }
      store4(i, bits);
    }
  }
  // no CTA leaves while a peer may still read its shared memory
  if (n_ctas > 1) cluster.sync();
}

}  // namespace

// Top-k membership of `rows` rows of `n` f32 keys. Row r is column r % cols
// of slide r / cols: key i of it is at keys[slide*key_b + col*key_c +
// i*key_n] (element strides) and its mask byte at out[slide*out_b +
// col*out_c + i*out_n]; 1 <= k <= n. Each row is split over a cluster of
// `cluster` CTAs (1..8); with `staged` every CTA holds its slice of
// ceil(n / cluster) keys, rounded up to 4, in shared memory (at most
// kMaxStagedKeys), without it the slice is re-read from device memory on each
// pass. Launches on `stream` without synchronising and returns the CUDA
// error code of the shared-memory opt-in or of the launch (0 on success).
extern "C" int moc_topk_threshold_mask_f32(const float* keys, uint8_t* out, int rows, int cols,
                                           int n, int k, long long key_b, long long key_c,
                                           long long key_n, long long out_b, long long out_c,
                                           long long out_n, int cluster, int staged,
                                           cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || cols < 1 || n < 1 || k < 1 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Job job;
  job.keys = keys;
  job.out = out;
  job.n = n;
  job.k = k;
  job.cols = cols;
  job.slice = ((n + cluster - 1) / cluster + 3) & ~3;
  job.key_b = key_b, job.key_c = key_c, job.key_n = key_n;
  job.out_b = out_b, job.out_c = out_c, job.out_n = out_n;
  job.vec_in = key_n == 1 && key_b % 4 == 0 && (cols == 1 || key_c % 4 == 0) &&
               reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  job.vec_out = out_n == 1 && out_b % 4 == 0 && (cols == 1 || out_c % 4 == 0) &&
                reinterpret_cast<uintptr_t>(out) % 4 == 0;
  if (staged && job.slice > kMaxStagedKeys) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(cluster), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (staged) {
    cfg.dynamicSmemBytes = static_cast<size_t>(job.slice) * sizeof(uint32_t);
    err = cudaFuncSetAttribute(topk_cluster_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cfg.dynamicSmemBytes));
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, topk_cluster_kernel<true>, job);
  } else {
    err = cudaLaunchKernelEx(&cfg, topk_cluster_kernel<false>, job);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
