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
// rows of the output accumulator (columns 4*tx + 64*c), so the running max m,
// sum l and the rescale factor stay in its registers; the row max and sum
// are reduced over the 16 threads of a half-warp with shuffles. Causal key
// tiles wholly above the diagonal are skipped. Any Lq and Lkv work: the
// ragged edge is masked by bounds, not by padding.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the JAX package's DEFAULT_MASK_VALUE, rounded to f32 as jnp.where does
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

template <int D>
struct Layout {
  static constexpr int kStride = D + 4;        // floats per staged Q/K/V row
  static constexpr int kPStride = kBlockK + 4;  // floats per staged P row
  static constexpr size_t kBytes =
      sizeof(float) * ((kBlockQ + 2 * kBlockK) * kStride + kBlockQ * kPStride);
};

// 16 bytes of T (4 f32 or 8 bf16) to f32 in shared memory
template <typename T>
__device__ __forceinline__ void to_f32(const uint4& raw, float* out) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(&raw);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
    *reinterpret_cast<float4*>(out) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(out + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// rows [r0, r0 + 64) of a row-major [len, D] slab into shared memory as f32;
// rows at or past `len` are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* __restrict__ dst,
                                          int r0, int len) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  static_assert(kBlockQ == kBlockK, "one loader serves Q, K and V tiles");
  for (int e = threadIdx.x; e < kBlockK * kPerRow; e += kThreads) {
    const int row = e / kPerRow;
    const int col = (e % kPerRow) * kVec;
    float* out = dst + row * Layout<D>::kStride + col;
    if (r0 + row < len) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + row) * D + col);
      to_f32<T>(raw, out);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(out + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_like_v(float p) {
  if constexpr (std::is_same_v<T, float>) {
    return p;
  } else {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c, float d) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 int heads, int lq, int lkv, int n_qtiles, int causal, float sm_scale) {
  constexpr int kS = Layout<D>::kStride;
  constexpr int kP = Layout<D>::kPStride;
  constexpr int kCols = D / 64;  // float4 output columns a thread owns per row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * kS;
  float* vs = ks + kBlockK * kS;
  float* ps = vs + kBlockK * kS;

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows 4*ty .. 4*ty+3 of the tile
  const int tx = tid & 15;  // keys tx + 16*j; output columns 4*tx + 64*c
  const bool segments = q_seg != nullptr;
  const T* qb = q + static_cast<size_t>(bh) * lq * D;
  const T* kb = k + static_cast<size_t>(bh) * lkv * D;
  const T* vb = v + static_cast<size_t>(bh) * lkv * D;

  load_tile<T, D>(qb, qs, q0, lq);

  int row_seg[4];
  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    row_seg[i] = (segments && r < lq) ? q_seg[static_cast<size_t>(b) * lq + r] : 0;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  // key tiles wholly above the diagonal contribute nothing: skip them
  const int kv_end = causal ? min(lkv, q0 + kBlockQ) : lkv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    load_tile<T, D>(kb, ks, kv0, lkv);
    load_tile<T, D>(vb, vs, kv0, lkv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kS + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
      }
    }

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
        } else if ((causal && key > row) || (segments && key_seg != row_seg[i])) {
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
        ps[(4 * ty + i) * kP + tx + 16 * j] = round_like_v<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kP + kk);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (kk + t) * kS + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= lq) continue;
    const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
    T* orow = o + (static_cast<size_t>(bh) * lq + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store4<T>(orow + 64 * c + 4 * tx, acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
    }
    if (tx == 0) {
      lse[static_cast<size_t>(bh) * lq + row] =
          l[i] == 0.f ? -INFINITY : m[i] + logf(fmaxf(l[i], 1e-37f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* q_seg, const int* kv_seg, int bh, int heads, int lq, int lkv,
           int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (lq + kBlockQ - 1) / kBlockQ;
  flash_fwd_kernel<T, D><<<bh * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, q_seg, kv_seg, heads, lq, lkv, n_qtiles, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [bh, lq, d], k and v [bh, lkv, d], o [bh, lq, d] (all contiguous, 16-byte
// aligned, f32 when is_bf16 == 0 else bf16); lse [bh, lq] f32; q_seg [bh/heads,
// lq] and kv_seg [bh/heads, lkv] int32, both null or both set. d is 64 or 128.
// Launches on `stream` without synchronising and returns the cudaGetLastError()
// code of the launch (0 on success).
extern "C" int moc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int* q_seg, const int* kv_seg, int bh, int heads, int lq,
                             int lkv, int d, int is_bf16, int causal, float sm_scale,
                             cudaStream_t stream) {
  if (bh <= 0 || lq <= 0) return 0;
  if (d == 64) {
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq,
                                               lkv, causal, sm_scale, stream)
                   : launch<float, 64>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv,
                                       causal, sm_scale, stream);
  }
  if (d == 128) {
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq,
                                                lkv, causal, sm_scale, stream)
                   : launch<float, 128>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv,
                                        causal, sm_scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
