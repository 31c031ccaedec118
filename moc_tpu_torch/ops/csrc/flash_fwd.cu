// K2: flash-attention forward with log-sum-exp output.
//
// Replaces the Pallas TPU kernel moc_tpu/ops/flash_attention.py:68
// (_fwd_kernel, launched by _fwd). For q [BH, Lq, D] and k, v [BH, Lkv, D]
// (row-major, f32 or bf16) it writes o [BH, Lq, D] in the input type and
// lse [BH, Lq] in f32:
//
//   s = (q . k) * sm_scale, summed in f32;
//   s = MASK (-0.7 * f32max) where the key is causally later than the query
//       (top-left alignment: key j is masked for query i when j > i) or its
//       segment id differs from the query's; such a key still counts in the
//       softmax, so a row masked everywhere gives mean(V) and lse = MASK;
//   keys at index >= Lkv (the ragged edge of the last tile) count for nothing;
//   o = softmax(s) . v, lse = max + log(sum); a row that met no key tile
//       (Lkv == 0) gives o = 0 and lse = -inf.
//
// In bf16 the products are exact in f32 and summed in f32, and P is rounded
// to bf16 before the P.V product, as p.astype(v.dtype) does on the TPU.
//
// Bound at the extraction shape ([64 * 12, 785, 64]): 4 * 768 * 785^2 * 64 =
// 121 GFLOP. In f32 that is 1.81 ms at the H100's 67 TFLOP/s outside the
// tensor cores, against 0.18 ms for its bytes (q, k, v and o, 154 MB each, at
// 3.35 TB/s): compute-bound. In bf16 it is 0.12 ms at 989 TFLOP/s: compute-
// bound too. This kernel does its products on the CUDA cores in f32 (no
// mma.sync / wgmma yet), so in bf16 it cannot approach that bound.
//
// Design: one CTA of 256 threads per (b*h, 64-row query tile), looping over
// 64-key tiles of K and V staged in shared memory as f32 (rows padded by four
// floats so float4 reads stay free of bank conflicts). A thread owns a 4x4
// block of the score tile (rows 4*ty.., keys tx + 16*j) and the same four
// rows of the output accumulator (the columns of ColMap), so the running max
// m, sum l and the rescale factor stay in its registers; the row max and sum
// are reduced over the 16 threads of a half-warp with shuffles. Causal key
// tiles wholly above the diagonal are skipped. Any Lq and Lkv work: the
// ragged edge is masked by bounds, not by padding. D is 32, 64 or 128.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * Layout<D>::kTile + Layout<D>::kPTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 int heads, int lq, int lkv, int n_qtiles, int causal, float sm_scale) {
  constexpr int kP = Layout<D>::kPStride;
  constexpr int kPer = ColMap<D>::kPer;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + Layout<D>::kTile;
  float* vs = ks + Layout<D>::kTile;
  float* ps = vs + Layout<D>::kTile;

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlock;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const bool segments = q_seg != nullptr;
  const T* qb = q + static_cast<size_t>(bh) * lq * D;
  const T* kb = k + static_cast<size_t>(bh) * lkv * D;
  const T* vb = v + static_cast<size_t>(bh) * lkv * D;

  load_tile<T, D>(qb, qs, q0, lq);

  int row_seg[4];
  float m[4], l[4], acc[4][kPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    row_seg[i] = (segments && r < lq) ? q_seg[static_cast<size_t>(b) * lq + r] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[i][c] = 0.f;
  }

  // key tiles wholly above the diagonal contribute nothing: skip them
  const int kv_end = causal ? min(lkv, q0 + kBlock) : lkv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    load_tile<T, D>(kb, ks, kv0, lkv);
    load_tile<T, D>(vb, vs, kv0, lkv);
    __syncthreads();

    float s[4][4] = {};
    tile_dot<D>(qs, ks, s, ty, tx);

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kv0 + tx + 16 * j;
      const int key_seg =
          (segments && key < lkv) ? kv_seg[static_cast<size_t>(b) * lkv + key] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        float x = s[i][j] * sm_scale;
        if (key >= lkv) {
          x = -INFINITY;
        } else if (masked(causal, segments, row, key, row_seg[i], key_seg)) {
          x = kMaskValue;
        }
        s[i][j] = x;
      }
    }

    // online softmax; every tile holds a key below Lkv, so the tile max is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mc = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        ps[(4 * ty + i) * kP + tx + 16 * j] = round_like<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    tile_accumulate<D>(ps, vs, acc, ty, tx);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
  store_rows<T, D>(o + static_cast<size_t>(bh) * lq * D, acc, inv, q0, lq, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if (row < lq) {
        lse[static_cast<size_t>(bh) * lq + row] =
            l[i] == 0.f ? -INFINITY : m[i] + logf(fmaxf(l[i], 1e-37f));
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* q_seg, const int* kv_seg, int bh, int heads, int lq, int lkv,
           int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (lq + kBlock - 1) / kBlock;
  flash_fwd_kernel<T, D><<<bh * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, q_seg, kv_seg, heads, lq, lkv, n_qtiles, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, const int* q_seg,
             const int* kv_seg, int bh, int heads, int lq, int lkv, int d, int causal,
             float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, causal, sm_scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, causal, sm_scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, causal,
                            sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [bh, lq, d], k and v [bh, lkv, d], o [bh, lq, d] (all contiguous, 16-byte
// aligned, f32 when is_bf16 == 0 else bf16); lse [bh, lq] f32; q_seg [bh/heads,
// lq] and kv_seg [bh/heads, lkv] int32, both null or both set. d is 32, 64 or
// 128. Launches on `stream` without synchronising and returns the
// cudaGetLastError() code of the launch (0 on success).
extern "C" int moc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int* q_seg, const int* kv_seg, int bh, int heads, int lq,
                             int lkv, int d, int is_bf16, int causal, float sm_scale,
                             cudaStream_t stream) {
  if (bh <= 0 || lq <= 0) return 0;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, d,
                                           causal, sm_scale, stream)
                 : dispatch<float>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, d, causal,
                                   sm_scale, stream);
}
