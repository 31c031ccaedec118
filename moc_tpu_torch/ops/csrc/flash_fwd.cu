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
// Both tiers run on the tensor cores and sum in another order than the
// plain version, so they agree with it within a tolerance, not bit for bit.
// In bf16 the products are exact in f32 and summed in f32, and P is rounded
// to bf16 before the P.V product, as p.astype(v.dtype) does on the TPU under
// preferred_element_type=f32 (2e-2). In f32 every product is taken in three
// TF32 passes (flash_mma.cuh), within a few units in 2^-22 of f32: within
// the JAX package's f32 forward tolerance (2e-5) and within 1e-5 of the
// largest |O| of the plain version; one TF32 pass is about 5e-4 off.
//
// Bound: operations, 4 * BH * Lq * Lkv * D. At the extraction shape
// ([64 * 12, 785, 64]) that is 121.2 GFLOP: in f32, three TF32 passes of it
// at the H100's 495 TFLOP/s, 0.7343 ms (its bytes, q, k, v and o at 154 MB
// each, take 0.18 ms at 3.35 TB/s); in bf16 0.1225 ms at 989 TFLOP/s. At the
// pretraining shape ([32 * 12, 512, 64]) f32 takes 0.1562 ms by its
// operations and bf16 0.0303 ms by its bytes. On an H100 mma.sync reaches
// 222-239 TFLOP/s of TF32 in the pattern of three passes and an f32 add
// (scripts/mma_tf32_rate.py), so about 1.6 ms at the extraction shape is the
// floor of the f32 design.
//
// Design, both tiers: one CTA of four warps per (b*h, 64-row query tile); a
// warp owns 16 query rows. The 64-row tiles are kept: with causal masking
// and segments together, which rows match no key depends on the tile size
// (as on the TPU, whose tiles are larger). 64-key K and V tiles stream
// through a two-stage cp.async ring (zero-filled past Lkv), so the copy of
// tile t + 1 overlaps the products of tile t; causal key tiles wholly above
// the diagonal are skipped. S = Q.K^T lands in f32 accumulator fragments
// that are scaled and masked in place; the online softmax reduces each row's
// max over the quad of lanes that shares it (two shuffles) and keeps each
// lane's partial sum until the end; P = exp2((S - m) * log2e) passes from
// the score fragments to the A operand of P.V in registers, never through
// shared memory. The f32 O accumulator is rescaled per pass and scaled by
// 1/l at the end.
//
// - f32 (flash_fwd_tf32_kernel): f32 tiles with rows padded to D + 4 floats
//   (87552 B of shared memory at D = 64, two CTAs an SM). Q and K, the A and B
//   operands of S, are both untransposed and read by ldmatrix; V, which the
//   bf16 tier reads with ldmatrix.trans (there is no 32-bit .trans), is read
//   as scalar pairs on 32 distinct banks (tf32_b_pair). Every product is
//   hi.hi + hi.lo + lo.hi on mma.sync m16n8k8 of operands split in the
//   kernel (rounded as cvt.rna rounds, by integer ops), with no
//   process-global TF32 flag read or set. The tensor core rounds its sums
//   toward zero, so two k-steps at a time go into a fresh accumulator that
//   an f32 add takes into the running sum. P is
//   split in the score fragments and passed with the k index of each 8-wide
//   step in the order 0, 2, 4, 6, 1, 3, 5, 7 on both operands (no shuffle).
//   Keys are taken in passes of 64 at D = 64 (32 at D = 32, 16 at D =
//   128, for the register budget), with no register spills at D = 32, 64
//   or 128; a pass wholly past Lkv is skipped. O is stored from the
//   fragments as float2.
// - bf16 (flash_fwd_mma_kernel): swizzled bf16 tiles; Q's A fragments are
//   loaded once and stay in registers; V is read by ldmatrix.trans and P is
//   rounded to bf16; O is staged through the warp's own rows of the Q tile
//   and written in 16-byte stores.
//
// Left for wgmma: the products at most ~60% of the tensor-core rate that
// mma.sync reaches on Hopper (about half of it in TF32), operands re-read
// from shared memory by every warp (ldmatrix, not wgmma's shared-memory
// descriptors), the f32 tier's B operands split by every warp (splitting
// them once a CTA, through a plane of lo parts in shared memory and one more
// barrier a tile, was slower on an H100), and the copies issued by the same
// warps that compute (no TMA producer warp).

#include "flash_mma.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t tf32_smem_bytes() {
  // Q; two stages of K and V (f32 rows padded to D + 4); two of the key segment ids
  return sizeof(float) * 5 * Layout<D>::kTile + 2 * kBlock * sizeof(int);
}

// At least one CTA an SM, not the default: without it ptxas holds the
// kernel to 168 registers at D = 64 (three CTAs' worth, where shared memory
// allows two), and on an H100 it took a third longer there
// (scripts/flash_fwd_variants.py).
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                      const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int heads,
                      int lq, int lkv, int n_qtiles, int causal, float sm_scale) {
  // keys per pass: the register budget
  constexpr int kKeyChunk = D == 128 ? 16 : D == 64 ? 64 : 32;
  constexpr int kKeyTiles = kKeyChunk / 8;       // n-tiles of S in a pass
  constexpr int kTile = Layout<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kTile;      // [2][64, kStride]
  float* vs = ks + 2 * kTile;  // [2][64, kStride]
  int* kv_segs = reinterpret_cast<int*>(vs + 2 * kTile);  // [2][64]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlock;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const bool segments = q_seg != nullptr;
  const size_t q_off = static_cast<size_t>(bh) * lq;
  const float* kb = k + static_cast<size_t>(bh) * lkv * D;
  const float* vb = v + static_cast<size_t>(bh) * lkv * D;
  const int* kv_seg_b = segments ? kv_seg + static_cast<size_t>(b) * lkv : nullptr;

  // this lane's two query rows: g and g + 8 of the warp's 16
  const int wrow = 16 * warp;
  const int row0 = q0 + wrow + (lane >> 2);
  const int row1 = row0 + 8;
  int seg0 = 0, seg1 = 0;
  if (segments) {
    if (row0 < lq) seg0 = q_seg[static_cast<size_t>(b) * lq + row0];
    if (row1 < lq) seg1 = q_seg[static_cast<size_t>(b) * lq + row1];
  }

  // key tiles wholly above the diagonal contribute nothing: skip them
  const int kv_end = causal ? min(lkv, q0 + kBlock) : lkv;
  const int n_tiles = (kv_end + kBlock - 1) / kBlock;
  auto load_kv = [&](int t) {
    const int stage = t & 1;
    load_tile_f32_async<D>(ks + stage * kTile, kb, t * kBlock, lkv, tid);
    load_tile_f32_async<D>(vs + stage * kTile, vb, t * kBlock, lkv, tid);
    if (segments) load_vec_async(kv_segs + stage * kBlock, kv_seg_b, t * kBlock, lkv, tid);
  };
  load_tile_f32_async<D>(qs, q + q_off * D, q0, lq, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlock;
    const int stage = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);  // into the stage tile t - 1 used
    cp_async_commit();
    const float* kt = ks + stage * kTile;
    const float* vt = vs + stage * kTile;
    const int* segs = kv_segs + stage * kBlock;

#pragma unroll
    for (int kc = 0; kc < kBlock; kc += kKeyChunk) {
      // a pass wholly past Lkv counts for nothing; the first pass of a tile
      // always holds a key below Lkv, so the running max is finite after it
      if (kv0 + kc >= lkv) break;
      float s[kKeyTiles][4];
      tf32_scores<D>(s, qs, wrow, kt, kc, lane);

      // scale and mask in place; the lane holds keys kv0 + kc + 8j + 2 * t4 + (e & 1)
      const bool edge = kv0 + kc + kKeyChunk > lkv;
      if (edge || causal || segments) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kc + 8 * j + 2 * t4 + (e & 1);
            const int key = kv0 + col;
            float x = s[j][e] * sm_scale;
            if (key >= lkv) {
              x = -INFINITY;
            } else if (masked(causal, segments, e < 2 ? row0 : row1, key, e < 2 ? seg0 : seg1,
                              segments ? segs[col] : 0)) {
              x = kMaskValue;
            }
            s[j][e] = x;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sm_scale;
        }
      }

      // online softmax over the pass
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // differences, not a fused x * log2e - m * log2e: MASK * log2e overflows
      const float alpha0 = exp2f((m0 - mn0) * kLog2e), alpha1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        s[j][0] = exp2f((s[j][0] - mn0) * kLog2e);
        s[j][1] = exp2f((s[j][1] - mn0) * kLog2e);
        s[j][2] = exp2f((s[j][2] - mn1) * kLog2e);
        s[j][3] = exp2f((s[j][3] - mn1) * kLog2e);
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      l0 = alpha0 * l0 + rs0;
      l1 = alpha1 * l1 + rs1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }

      // O += P . V, P straight from the score fragments, the 8 keys of a
      // step as its k index in acc_to_a_tf32's order
      tf32_grads<D>(acc, s, vt, kc, lane);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0, inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= inv0;
    acc[n][1] *= inv0;
    acc[n][2] *= inv1;
    acc[n][3] *= inv1;
  }
  cp_async_wait<0>();  // no copy is left in flight (also when no key tile ran)
  store_acc_f32<D>(o + q_off * D, acc, q0 + wrow, lq, lane);
  if (t4 == 0) {
    float* lse_b = lse + q_off;
    if (row0 < lq) lse_b[row0] = l0 == 0.f ? -INFINITY : m0 + logf(fmaxf(l0, 1e-37f));
    if (row1 < lq) lse_b[row1] = l1 == 0.f ? -INFINITY : m1 + logf(fmaxf(l1, 1e-37f));
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {  // Q, two stages of K and V, two of the key segment ids
  return 5 * Tile<D>::kBytes + 2 * kBlock * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int heads,
                     int lq, int lkv, int n_qtiles, int causal, float sm_scale) {
  constexpr int kSteps = D / 16;      // k-steps of S = Q.K^T
  constexpr int kKeyTiles = kBlock / 8;  // n-tiles of S
  constexpr int kDTiles = D / 8;      // n-tiles of O
  constexpr int kTileElems = Tile<D>::kElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTileElems;      // [2][64, D]
  bf16* vs = ks + 2 * kTileElems;  // [2][64, D]
  int* kv_segs = reinterpret_cast<int*>(vs + 2 * kTileElems);  // [2][64]

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlock;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const bool segments = q_seg != nullptr;
  const bf16* kb = k + static_cast<size_t>(bh) * lkv * D;
  const bf16* vb = v + static_cast<size_t>(bh) * lkv * D;
  const int* kv_seg_b = segments ? kv_seg + static_cast<size_t>(b) * lkv : nullptr;

  // this lane's two query rows: g and g + 8 of the warp's 16
  const int wrow = 16 * warp;
  const int row0 = q0 + wrow + (lane >> 2);
  const int row1 = row0 + 8;
  int seg0 = 0, seg1 = 0;
  if (segments) {
    if (row0 < lq) seg0 = q_seg[static_cast<size_t>(b) * lq + row0];
    if (row1 < lq) seg1 = q_seg[static_cast<size_t>(b) * lq + row1];
  }

  // key tiles wholly above the diagonal contribute nothing: skip them
  const int kv_end = causal ? min(lkv, q0 + kBlock) : lkv;
  const int n_tiles = (kv_end + kBlock - 1) / kBlock;
  auto load_kv = [&](int t) {
    const int stage = t & 1;
    load_tile_async<D>(ks + stage * kTileElems, kb, t * kBlock, lkv, tid);
    load_tile_async<D>(vs + stage * kTileElems, vb, t * kBlock, lkv, tid);
    if (segments) load_vec_async(kv_segs + stage * kBlock, kv_seg_b, t * kBlock, lkv, tid);
  };
  load_tile_async<D>(qs, q + static_cast<size_t>(bh) * lq * D, q0, lq, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  uint32_t qf[kSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlock;
    const int stage = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);  // into the stage tile t - 1 used
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int kstep = 0; kstep < kSteps; ++kstep) {
        ldsm_x4(qf[kstep], a_addr<D>(qs, wrow, kstep, lane));
      }
    }
    const bf16* kt = ks + stage * kTileElems;
    const bf16* vt = vs + stage * kTileElems;

    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kstep = 0; kstep < kSteps; ++kstep) {
#pragma unroll
      for (int jj = 0; jj < kKeyTiles / 2; ++jj) {
        uint32_t kf[4];
        ldsm_x4(kf, b_addr<D>(kt, 16 * jj, kstep, lane));
        mma_bf16(s[2 * jj], qf[kstep], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kstep], kf[2], kf[3]);
      }
    }

    // scale and mask in place; the lane holds keys kv0 + 8j + 2 * t4 + (e & 1)
    const bool edge = kv0 + kBlock > lkv;
    if (edge || causal || segments) {
      const int* segs = kv_segs + stage * kBlock;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int key = kv0 + col;
          float x = s[j][e] * sm_scale;
          if (key >= lkv) {
            x = -INFINITY;
          } else if (masked(causal, segments, e < 2 ? row0 : row1, key, e < 2 ? seg0 : seg1,
                            segments ? segs[col] : 0)) {
            x = kMaskValue;
          }
          s[j][e] = x;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= sm_scale;
      }
    }

    // online softmax; every tile holds a key below Lkv, so the tile max is finite
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // differences, not a fused x * log2e - m * log2e: MASK * log2e overflows
    const float alpha0 = exp2f((m0 - mn0) * kLog2e), alpha1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = exp2f((s[j][0] - mn0) * kLog2e);
      s[j][1] = exp2f((s[j][1] - mn0) * kLog2e);
      s[j][2] = exp2f((s[j][2] - mn1) * kLog2e);
      s[j][3] = exp2f((s[j][3] - mn1) * kLog2e);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + rs0;
    l1 = alpha1 * l1 + rs1;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += bf16(P) . V, P straight from the score fragments
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < kDTiles / 2; ++dd) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, bt_addr<D>(vt, 16 * kk, dd, lane));
        mma_bf16(acc[2 * dd], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dd + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  // the Q tile has landed (also when no key tile ran) and no warp reads it
  // again: each warp stages its O rows in its own 16 rows of it
  cp_async_wait<0>();
  __syncthreads();
  stage_rows<D>(qs, acc, l0 == 0.f ? 1.f : 1.f / l0, l1 == 0.f ? 1.f : 1.f / l1, wrow, lane);
  __syncwarp();
  store_rows_16<D>(o + static_cast<size_t>(bh) * lq * D, qs, wrow, q0, lq, lane);
  if (t4 == 0) {
    float* lse_b = lse + static_cast<size_t>(bh) * lq;
    if (row0 < lq) lse_b[row0] = l0 == 0.f ? -INFINITY : m0 + logf(fmaxf(l0, 1e-37f));
    if (row1 < lq) lse_b[row1] = l1 == 0.f ? -INFINITY : m1 + logf(fmaxf(l1, 1e-37f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const int* q_seg,
           const int* kv_seg, int bh, int heads, int lq, int lkv, int is_bf16, int causal,
           float sm_scale, cudaStream_t stream) {
  const int n_qtiles = (lq + kBlock - 1) / kBlock;
  if (is_bf16) {
    constexpr size_t smem = mma_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_mma_kernel<D><<<bh * n_qtiles, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, q_seg, kv_seg, heads, lq, lkv, n_qtiles, causal, sm_scale);
  } else {
    constexpr size_t smem = tf32_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_fwd_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_tf32_kernel<D><<<bh * n_qtiles, kMmaThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, q_seg, kv_seg, heads, lq,
        lkv, n_qtiles, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [bh, lq, d], k and v [bh, lkv, d], o [bh, lq, d] (all contiguous, 16-byte
// aligned, f32 when is_bf16 == 0 else bf16); lse [bh, lq] f32; q_seg [bh/heads,
// lq] and kv_seg [bh/heads, lkv] int32, both null or both set. d is 32, 64 or
// 128. Both tiers run on the tensor cores: bf16 in one pass, f32 in three
// TF32 passes. Launches on `stream` without synchronising and returns the
// cudaGetLastError() code of the launch, or of a refused shared-memory
// opt-in (0 on success).
extern "C" int moc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int* q_seg, const int* kv_seg, int bh, int heads, int lq,
                             int lkv, int d, int is_bf16, int causal, float sm_scale,
                             cudaStream_t stream) {
  if (bh <= 0 || lq <= 0) return 0;
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, is_bf16, causal,
                        sm_scale, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, is_bf16, causal,
                        sm_scale, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, is_bf16, causal,
                         sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
