// K2: flash-attention forward with log-sum-exp output.
//
// Replaces the Pallas TPU kernel moc_tpu/ops/flash_attention.py:68
// (_fwd_kernel, launched by _fwd). For q [BH, Lq, D] and k, v [BH, Lkv, D]
// (f32 row-major; bf16 read by its strides) it writes o [BH, Lq, D] in the
// input type and lse [BH, Lq] in f32:
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
// f32 (flash_fwd_tf32_kernel): one CTA of four warps per (b*h, 64-row query
// tile); a warp owns 16 query rows. The 64-row tiles are kept: with causal
// masking and segments together, which rows match no key depends on the tile
// size (as on the TPU, whose tiles are larger). 64-key K and V tiles stream
// through a two-stage cp.async ring (zero-filled past Lkv), so the copy of
// tile t + 1 overlaps the products of tile t; causal key tiles wholly above
// the diagonal are skipped. S = Q.K^T lands in f32 accumulator fragments
// that are scaled and masked in place; the online softmax reduces each row's
// max over the quad of lanes that shares it (two shuffles) and keeps each
// lane's partial sum until the end; P = exp2((S - m) * log2e) passes from
// the score fragments to the A operand of P.V in registers, never through
// shared memory. The f32 O accumulator is rescaled per pass and scaled by
// 1/l at the end. f32 tiles have rows padded to D + 4 floats (87552 B of
// shared memory at D = 64, two CTAs an SM). Q and K, the A and B operands of
// S, are both untransposed and read by ldmatrix; V is read as scalar pairs on
// 32 distinct banks (tf32_b_pair; there is no 32-bit ldmatrix.trans). Every
// product is hi.hi + hi.lo + lo.hi on mma.sync m16n8k8 of operands split in
// the kernel (rounded as cvt.rna rounds, by integer ops), with no
// process-global TF32 flag read or set. The tensor core rounds its sums
// toward zero, so two k-steps at a time go into a fresh accumulator that an
// f32 add takes into the running sum. P is split in the score fragments and
// passed with the k index of each 8-wide step in the order 0, 2, 4, 6, 1, 3,
// 5, 7 on both operands (no shuffle). Keys are taken in passes of 64 at D =
// 64 (32 at D = 32, 16 at D = 128, for the register budget), with no
// register spills at D = 32, 64 or 128; a pass wholly past Lkv is skipped. O
// is stored from the fragments as float2. Left: mma.sync reaches about half
// of Hopper's TF32 rate, and every warp splits its B operands itself
// (splitting them once a CTA, through a plane of lo parts in shared memory
// and one more barrier a tile, was slower on an H100).
//
// bf16 (flash_fwd_wgmma_kernel), built for Hopper (flash_sm90.cuh): a
// persistent kernel, one CTA of three warpgroups an SM, each CTA taking work
// items (b*h, 128-row query tile) in turn.
// - Warpgroup 0 produces: its first warp issues every copy by TMA (4-D
//   tensor maps over q, k, v and o, encoded on the host from their byte
//   strides, so the [B, H, L, D] view of a [B, L, H, D] projection is read
//   without a copy; rows past L are zero-filled on a load and dropped on a
//   store). Q comes once an item into one of two buffers; K and V tiles of
//   128 keys stream through a two-stage ring that runs on across items, each
//   stage with full and empty mbarriers, K and V apart so that S can start
//   while V is in flight; its lanes copy the key segment ids beside K. It
//   also stores each item's O, which the consumers stage in that item's Q
//   buffer, before the buffer takes another Q. It keeps 24 registers a thread
//   (setmaxnreg) and gives the rest to the consumers.
// - Warpgroups 1 and 2 consume, 64 query rows of each item each. S = Q.K^T
//   is wgmma m64n128k16 with Q and K both read from 128-byte-swizzled shared
//   memory (64-byte at D = 32) through descriptors; O += P.V is wgmma
//   m64nDk16 with P from registers (the score accumulator rounded to bf16, as
//   p.astype(v.dtype) does on the TPU) and V read MN-major from shared
//   memory, so nothing passes through ldmatrix or shared memory on the way.
//   The accumulator layout is mma.sync's, so the mask and the online softmax
//   are the f32 tier's, kept in base 2 (one FFMA and one ex2 a probability).
//   Tile t + 1's S is issued with tile t's P.V, so the tensor cores run the
//   one while the softmax of the other waits only for S; the two warpgroups
//   take turns to issue (named barriers), so one's softmax runs while the
//   other's products hold the tensor cores. A warpgroup none of whose rows
//   is below Lq (the last tile's second half) computes nothing and only
//   keeps the ring and the turns in step.
// - Causal: an item's key tiles end at its last row's diagonal, and each
//   warpgroup's keys at its own 64-row tile's (kv_end), so which keys a row
//   that matches no key counts is what it was with 64-row tiles; past
//   kv_end inside a running 128-key tile, keys count for nothing.
// - Epilogue: O scaled by 1/l into the warpgroup's Q tile (swizzled as the
//   O map's boxes), stored by the producer, one TMA store a box; lse from
//   the lanes.
// What bounds it (an H100 80GB HBM3, PERF.md): at D = 64 the exponentials
// (64 x 128 a warpgroup a tile, 16 a clock an SM) take about as long as the
// products, and neither pipe is full: the K/V loads are not the limit (the
// kernel takes as long with them left out), the softmax of one warpgroup and
// the products of the other overlap only in part.

#include <algorithm>
#include <atomic>

#include "flash_mma.cuh"
#include "flash_sm90.cuh"

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

// bf16 on Hopper (the design note at the top): the tiles, the shared-memory
// plan and the register split of flash_fwd_wgmma_kernel.
constexpr int kSm90Stages = 2;  // of the K/V ring

template <int D>
struct Sm90Fwd {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kConsumers = 2;
  static constexpr int kRows = 64;                     // query rows a consumer warpgroup
  static constexpr int kQTile = kRows * kConsumers;    // query rows a CTA
  static constexpr int kKeys = 128;                    // keys a K/V tile
  static constexpr int kStages = kSm90Stages;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kSwizzle = D == 32 ? 64 : 128;  // bytes: one box row
  static constexpr int kBoxCols = kSwizzle / 2;        // columns of a TMA box
  static constexpr int kRowBytes = kSwizzle;
  static constexpr int kQBytes = kRows * D * 2;        // a warpgroup's Q (then O) tile
  static constexpr int kKVBytes = kKeys * D * 2;       // one stage of K or of V
  static constexpr int kKOff = 2 * kConsumers * kQBytes;  // Q (then O): two buffers
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kSegOff = kVOff + kStages * kKVBytes;
  static constexpr int kBarOff = kSegOff + kStages * kKeys * 4;
  // q_full, o_full a Q buffer; k_full, k_empty, v_full, v_empty a stage
  static constexpr int kBars = 4 + 4 * kStages;
  static constexpr size_t kSmem = kBarOff + 8 * kBars + 1024;  // + alignment to 1024 bytes
  // setmaxnreg moves registers within what the CTA was launched with (a
  // multiple of 8 a thread, at most 65536 / kThreads): the producer
  // warpgroup keeps 24 a thread, the consumers share the rest
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= kLaunchRegs * kThreads,
                "setmaxnreg asks for more registers than the CTA holds");
};

// S = Q.K^T of a 128-key tile: D/16 k-steps of m64n128k16, Q and K both
// K-major; k-step ks reads 32 bytes further into a box row, past it the next box
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q_tile, uint32_t k_tile) {
  using C = Sm90Fwd<D>;
  constexpr int kStepsPerBox = C::kBoxCols / 16;
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t in_row = (ks % kStepsPerBox) * 32;
    const uint32_t box = ks / kStepsPerBox;
    const uint64_t a = sm90::smem_desc<C::kSwizzle>(
        q_tile + box * C::kRows * C::kRowBytes + in_row, 16, 8 * C::kRowBytes);
    const uint64_t b = sm90::smem_desc<C::kSwizzle>(
        k_tile + box * C::kKeys * C::kRowBytes + in_row, 16, 8 * C::kRowBytes);
    sm90::wgmma_ss<128>(s, a, b, ks > 0);
  }
  sm90::wgmma_commit();
}

// O += bf16(P).V of a 128-key tile: 8 k-steps of m64nDk16, P from registers,
// V MN-major (a row of V is a key; boxes of kBoxCols columns lie kKeys rows apart)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[8][4],
                                         uint32_t v_tile) {
  using C = Sm90Fwd<D>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t b = sm90::smem_desc<C::kSwizzle>(v_tile + kk * 16 * C::kRowBytes,
                                                    C::kKeys * C::kRowBytes, 8 * C::kRowBytes);
    sm90::wgmma_rs<D>(o, p[kk], b, 1);
  }
  sm90::wgmma_commit();
}

// one consumer thread's rows and running softmax state
struct RowState {
  int row0, row1, seg0, seg1;
  float m0, m1, l0, l1;  // m: base-2 running max; l: this lane's partial sums
};

constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale and mask the scores of key tile `kv0` in place, fold them into the
// running max and sums, and leave exp(S - max) in s; returns in alpha0/1 the
// factors that rescale O. The lane holds keys kv0 + 8j + 2t + (e & 1).
// The max is kept in base 2 of the scaled scores, x = s * scale * log2e, so
// that a probability is one FFMA and one ex2. A masked key takes MASK itself
// (MASK * log2e would overflow): beside any visible key 2^(MASK - m) is 0,
// as exp(MASK - m) is, and a row whose keys are all masked has m = MASK and
// 2^(MASK - MASK) = 1 for each, as exp gives; its lse is MASK (see the end).
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], RowState& st, int kv0, int kv_end,
                                             bool causal, bool segments, const int* segs, int t4,
                                             float scale_log2, float& alpha0, float& alpha1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if (kMask) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int key = kv0 + col;
        float x = s[4 * j + e] * scale_log2;
        if (key >= kv_end) {
          x = -INFINITY;
        } else if (masked(causal, segments, e < 2 ? st.row0 : st.row1, key,
                          e < 2 ? st.seg0 : st.seg1, segments ? segs[col] : 0)) {
          x = kMaskValue;
        }
        s[4 * j + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  } else {  // the max of the raw scores, scaled once (the scale is positive)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  // every tile holds a key below kv_end for every row, so the tile max is finite
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  alpha0 = ex2(st.m0 - mn0);
  alpha1 = ex2(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mn = e < 2 ? mn0 : mn1;
      s[4 * j + e] = kMask ? ex2(s[4 * j + e] - mn) : ex2(fmaf(s[4 * j + e], scale_log2, -mn));
    }
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  st.l0 = alpha0 * st.l0 + rs0;
  st.l1 = alpha1 * st.l1 + rs1;
}

__device__ __forceinline__ void softmax(float (&s)[64], RowState& st, int kv0, int kv_end,
                                        bool causal, bool segments, const int* segs, int t4,
                                        float scale_log2, float& alpha0, float& alpha1) {
  // the masked form also where a negative scale would turn the raw max into the min
  if (kv0 + 128 > kv_end || causal || segments || scale_log2 < 0.f) {
    softmax_tile<true>(s, st, kv0, kv_end, causal, segments, segs, t4, scale_log2, alpha0,
                       alpha1);
  } else {
    softmax_tile<false>(s, st, kv0, kv_end, causal, segments, segs, t4, scale_log2, alpha0,
                        alpha1);
  }
}

// a row's lse from its base-2 max and sum (a row whose keys are all masked
// has the max MASK, and its lse is MASK + log(l), MASK in f32)
__device__ __forceinline__ float row_lse(float m, float l) {
  if (l == 0.f) return -INFINITY;
  return (m == kMaskValue ? m : m * kLn2) + logf(fmaxf(l, 1e-37f));
}

// exp(S - max), rounded to bf16, as the A operand of P.V (as acc_to_a packs it)
__device__ __forceinline__ void scores_to_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    o[i] *= alpha0;
    o[i + 1] *= alpha0;
    o[i + 2] *= alpha1;
    o[i + 3] *= alpha1;
  }
}

// A consumer warpgroup's part in an item none of whose rows it holds: every
// K/V tile waited for and released, and the turns taken, as in the item's
// products (n_tiles + 1 turns: S of the first tile, then S and P.V of each
// next, then the last P.V), so that the ring and the turns stay in step.
__device__ __forceinline__ void idle_item(int g, int n_tiles, uint32_t k_full, uint32_t k_empty,
                                          uint32_t v_full, uint32_t v_empty, int my_turn,
                                          int their_turn, bool signal) {
  for (int t = 0; t <= n_tiles && n_tiles > 0; ++t) {
    if (t < n_tiles) {
      const int stage = (g + t) % kSm90Stages;
      sm90::mbar_wait(k_full + 8 * stage, ((g + t) / kSm90Stages) & 1);
      if (signal) sm90::mbar_arrive(k_empty + 8 * stage);
    }
    sm90::named_barrier(my_turn, 256);
    sm90::named_arrive(their_turn, 256);
    if (t > 0) {
      const int stage = (g + t - 1) % kSm90Stages;
      sm90::mbar_wait(v_full + 8 * stage, ((g + t - 1) / kSm90Stages) & 1);
      if (signal) sm90::mbar_arrive(v_empty + 8 * stage);
    }
  }
}

// named barriers: 0 is __syncthreads; from 1 a consumer warpgroup's epilogue
// each, from 4 its turn at the tensor cores
constexpr int kEpilogueBarrier = 1, kTurnBarrier = 4;

template <int D>
__global__ void __launch_bounds__(Sm90Fwd<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
                       const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int heads,
                       int lq, int lkv, int n_qtiles, int n_items, int causal, float sm_scale) {
  using C = Sm90Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles (and wgmma's descriptors) need 1024-byte aligned addresses
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* seg_smem = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kSegOff);
  const uint32_t bars = base + C::kBarOff;
  const uint32_t q_full = bars;                           // [2]: a Q buffer each
  const uint32_t o_full = q_full + 16;                    // [2]
  const uint32_t k_full = o_full + 16;                    // [kStages]
  const uint32_t k_empty = k_full + 8 * C::kStages;
  const uint32_t v_full = k_empty + 8 * C::kStages;
  const uint32_t v_empty = v_full + 8 * C::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool segments = q_seg != nullptr;
  // the work item (b*h, 128-row query tile) and its key tiles: those wholly
  // above the diagonal of the item's last row contribute nothing
  auto item_of = [&](int item, int& bh, int& q0, int& n_tiles) {
    bh = item / n_qtiles;
    q0 = (item % n_qtiles) * C::kQTile;
    const int kv_stop = causal ? min(lkv, q0 + C::kQTile) : lkv;
    n_tiles = (kv_stop + C::kKeys - 1) / C::kKeys;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(q_full + 8 * i, 1);
      sm90::mbar_init(o_full + 8 * i, 128 * C::kConsumers);  // every consumer thread
    }
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(k_full + 8 * s, 32);  // the producer warp's lanes (segment ids)
      sm90::mbar_init(k_empty + 8 * s, 4 * C::kConsumers);  // every consumer warp
      sm90::mbar_init(v_full + 8 * s, 1);
      sm90::mbar_init(v_empty + 8 * s, 4 * C::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: every load of every item of this CTA, in order ----
    sm90::reg_dealloc<C::kProducerRegs>();
    if (warp != 0) return;
    if (lane == 0) {
      sm90::tma_prefetch(&q_map);
      sm90::tma_prefetch(&k_map);
      sm90::tma_prefetch(&v_map);
    }
    // the O that the consumers staged in Q buffer jj & 1 for item jj (rows
    // past Lq dropped), stored before the buffer takes another Q
    auto store_o = [&](int jj) {
      int bh, q0, n_tiles;
      item_of(blockIdx.x + jj * gridDim.x, bh, q0, n_tiles);
      sm90::mbar_wait(o_full + 8 * (jj & 1), (jj >> 1) & 1);
      if (lane == 0) {
        const uint32_t src = base + (jj & 1) * C::kConsumers * C::kQBytes;
        for (int w = 0; w < C::kConsumers && q0 + w * C::kRows < lq; ++w) {
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_store(&o_map, src + w * C::kQBytes + box * C::kRows * C::kRowBytes,
                            box * C::kBoxCols, q0 + w * C::kRows, bh % heads, bh / heads);
          }
        }
        sm90::tma_store_commit_and_wait();
      }
      __syncwarp();
    };
    int g = 0;  // K/V tiles loaded so far, over all items: the ring's position
    int j = 0;
    for (int item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, q0, n_tiles;
      item_of(item, bh, q0, n_tiles);
      const int b = bh / heads, h = bh % heads;
      // Q of both consumers into buffer j & 1, once the O of item j - 2 left it
      if (j >= 2) store_o(j - 2);
      if (lane == 0) {
        const uint32_t dst = base + (j & 1) * C::kConsumers * C::kQBytes;
        sm90::mbar_arrive_tx(q_full + 8 * (j & 1), C::kConsumers * C::kQBytes);
        for (int w = 0; w < C::kConsumers; ++w) {
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_load(dst + w * C::kQBytes + box * C::kRows * C::kRowBytes, &q_map,
                           q_full + 8 * (j & 1), box * C::kBoxCols, q0 + w * C::kRows, h, b);
          }
        }
      }
      for (int t = 0; t < n_tiles; ++t, ++g) {
        const int s = g % C::kStages;
        const uint32_t parity = ((g / C::kStages) & 1) ^ 1;  // the first round passes
        sm90::mbar_wait(k_empty + 8 * s, parity);
        if (segments) {  // 4 ids a lane; keys past Lkv count for nothing (id unread)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 4 * lane + i, key = t * C::kKeys + col;
            seg_smem[s * C::kKeys + col] =
                key < lkv ? kv_seg[static_cast<size_t>(b) * lkv + key] : 0;
          }
        }
        if (lane == 0) {
          sm90::mbar_arrive_tx(k_full + 8 * s, C::kKVBytes);
          const uint32_t dst = base + C::kKOff + s * C::kKVBytes;
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_load(dst + box * C::kKeys * C::kRowBytes, &k_map, k_full + 8 * s,
                           box * C::kBoxCols, t * C::kKeys, h, b);
          }
        } else {
          sm90::mbar_arrive(k_full + 8 * s);
        }
        sm90::mbar_wait(v_empty + 8 * s, parity);
        if (lane == 0) {
          sm90::mbar_arrive_tx(v_full + 8 * s, C::kKVBytes);
          const uint32_t dst = base + C::kVOff + s * C::kKVBytes;
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_load(dst + box * C::kKeys * C::kRowBytes, &v_map, v_full + 8 * s,
                           box * C::kBoxCols, t * C::kKeys, h, b);
          }
        }
      }
    }
    for (int jj = j < 2 ? 0 : j - 2; jj < j; ++jj) store_o(jj);
  } else {
    // ---- consumers: 64 query rows of every item each ----
    sm90::reg_alloc<C::kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int wt = threadIdx.x & 127;  // thread in the warpgroup
    const int t4 = lane & 3;
    const bool signal = lane == 0;  // one arrival a warp on the empty barriers
    const float scale_log2 = sm_scale * kLog2e;
    // The consumer warpgroups take turns to issue their products (a named
    // barrier each, passed round): one's softmax runs while another's
    // products hold the tensor cores. Warpgroup 0 goes first.
    const int my_turn = kTurnBarrier + wg;
    const int their_turn = kTurnBarrier + (wg + 1) % C::kConsumers;  // the next in turn
    if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);

    float o[D / 2];
    float s[64];
    uint32_t p[8][4];
    float alpha0, alpha1;
    int g = 0;  // K/V tiles consumed so far, over all items
    for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, q0, n_tiles;
      item_of(item, bh, q0, n_tiles);
      const int b = bh / heads;
      const int qw = q0 + wg * C::kRows;  // the warpgroup's first query row
      // a causal row's keys end at its 64-row tile's diagonal: past it, within
      // a running tile, keys count for nothing, as past Lkv
      const int kv_end = causal ? min(lkv, qw + C::kRows) : lkv;
      const uint32_t q_tile = base + ((j & 1) * C::kConsumers + wg) * C::kQBytes;
      RowState st;
      st.row0 = qw + 16 * (wt >> 5) + (lane >> 2);
      st.row1 = st.row0 + 8;
      st.seg0 = st.seg1 = 0;
      if (segments) {
        if (st.row0 < lq) st.seg0 = q_seg[static_cast<size_t>(b) * lq + st.row0];
        if (st.row1 < lq) st.seg1 = q_seg[static_cast<size_t>(b) * lq + st.row1];
      }
      st.m0 = st.m1 = -INFINITY;
      st.l0 = st.l1 = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

      if (qw >= lq) {
        // no row of this warpgroup is real (the last query tile's second half):
        // keep the ring and the turns in step, and compute nothing
        idle_item(g, n_tiles, k_full, k_empty, v_full, v_empty, my_turn, their_turn, signal);
        g += n_tiles;
        sm90::mbar_arrive(o_full + 8 * (j & 1));
        continue;
      }
      sm90::mbar_wait(q_full + 8 * (j & 1), (j >> 1) & 1);
      if (n_tiles > 0) {
        const int stage0 = g % C::kStages;
        sm90::mbar_wait(k_full + 8 * stage0, (g / C::kStages) & 1);
        sm90::named_barrier(my_turn, 256);
        issue_scores<D>(s, q_tile, base + C::kKOff + stage0 * C::kKVBytes);
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        softmax(s, st, 0, kv_end, causal, segments, seg_smem + stage0 * C::kKeys, t4,
                scale_log2, alpha0, alpha1);
        if (signal) sm90::mbar_arrive(k_empty + 8 * stage0);
        scores_to_p(p, s);
        // the steady state, free of branches so that ptxas can pipeline the
        // products: S of tile t + 1 runs beside P.V of tile t, whose softmax
        // waits only for S
        for (int t = 0; t + 1 < n_tiles; ++t) {
          const int gt = g + t;
          const int stage = gt % C::kStages, stage1 = (gt + 1) % C::kStages;
          sm90::mbar_wait(k_full + 8 * stage1, ((gt + 1) / C::kStages) & 1);
          sm90::mbar_wait(v_full + 8 * stage, (gt / C::kStages) & 1);
          sm90::named_barrier(my_turn, 256);
          issue_scores<D>(s, q_tile, base + C::kKOff + stage1 * C::kKVBytes);
          issue_pv<D>(o, p, base + C::kVOff + stage * C::kKVBytes);
          sm90::named_arrive(their_turn, 256);
          sm90::wgmma_wait<1>();  // S of tile t + 1 is done; P.V of tile t runs on
          sm90::fence_regs(s);
          softmax(s, st, (t + 1) * C::kKeys, kv_end, causal, segments,
                  seg_smem + stage1 * C::kKeys, t4, scale_log2, alpha0, alpha1);
          if (signal) sm90::mbar_arrive(k_empty + 8 * stage1);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          sm90::fence_regs(p);
          if (signal) sm90::mbar_arrive(v_empty + 8 * stage);
          rescale(o, alpha0, alpha1);
          scores_to_p(p, s);
        }
        const int last = g + n_tiles - 1, stage = last % C::kStages;
        sm90::mbar_wait(v_full + 8 * stage, (last / C::kStages) & 1);
        sm90::named_barrier(my_turn, 256);
        issue_pv<D>(o, p, base + C::kVOff + stage * C::kKVBytes);
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(p);
        if (signal) sm90::mbar_arrive(v_empty + 8 * stage);
      }
      g += n_tiles;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        st.l0 += __shfl_xor_sync(kFull, st.l0, off);
        st.l1 += __shfl_xor_sync(kFull, st.l1, off);
      }
      const float inv0 = st.l0 == 0.f ? 1.f : 1.f / st.l0;
      const float inv1 = st.l1 == 0.f ? 1.f : 1.f / st.l1;
      // O in bf16 into the warpgroup's Q tile, once every product of the
      // warpgroup that reads it is done, swizzled as the O map's boxes lay it
      // out; the producer stores it
      sm90::named_barrier(kEpilogueBarrier + wg, 128);
      unsigned char* tile = smem_raw + (q_tile - raw);
      const int r0 = 16 * (wt >> 5) + (lane >> 2);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t4;
        const uint32_t box = (col / C::kBoxCols) * C::kRows * C::kRowBytes;
        const uint32_t c = (col % C::kBoxCols) * 2;
        *reinterpret_cast<uint32_t*>(tile + box +
                                     sm90::swizzle<C::kSwizzle>(r0 * C::kRowBytes + c)) =
            pack_bf16(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
        *reinterpret_cast<uint32_t*>(tile + box +
                                     sm90::swizzle<C::kSwizzle>((r0 + 8) * C::kRowBytes + c)) =
            pack_bf16(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
      }
      sm90::fence_async_smem();
      sm90::mbar_arrive(o_full + 8 * (j & 1));
      if (t4 == 0) {
        float* lse_b = lse + static_cast<size_t>(bh) * lq;
        if (st.row0 < lq) lse_b[st.row0] = row_lse(st.m0, st.l0);
        if (st.row1 < lq) lse_b[st.row1] = row_lse(st.m1, st.l1);
      }
    }
  }
}

// The SM count of `device`, with the wgmma kernel of head dim D opted in to
// its dynamic shared memory there: both asked of the runtime once a device
// and a D, and kept
template <int D>
cudaError_t wgmma_device(int device, int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet, else the SM count
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  int n = known[device].load(std::memory_order_acquire);
  if (n == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = allow_smem(flash_fwd_wgmma_kernel<D>, Sm90Fwd<D>::kSmem);
    if (err != cudaSuccess) return err;
    known[device].store(n, std::memory_order_release);
  }
  *sms = n;
  return cudaSuccess;
}

// bf16: TMA maps over q, k, v and o by their byte strides (`strides`: L, H
// and B of each of q, k, v, o), then one launch of the wgmma kernel
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 const int* q_seg, const int* kv_seg, const long long* strides, int bh, int heads,
                 int lq, int lkv, int causal, float sm_scale, cudaStream_t stream) {
  using C = Sm90Fwd<D>;
  const int b = bh / heads;
  CUtensorMap maps[4] = {};
  int err = sm90_host::make_map(&maps[0], q, D, lq, heads, b, strides, C::kBoxCols, C::kRows,
                                C::kSwizzle);
  if (!err && lkv > 0) {  // no key: no K or V tile is loaded
    err = sm90_host::make_map(&maps[1], k, D, lkv, heads, b, strides + 3, C::kBoxCols, C::kKeys,
                              C::kSwizzle);
    if (!err) {
      err = sm90_host::make_map(&maps[2], v, D, lkv, heads, b, strides + 6, C::kBoxCols,
                                C::kKeys, C::kSwizzle);
    }
  }
  if (!err) {
    err = sm90_host::make_map(&maps[3], o, D, lq, heads, b, strides + 9, C::kBoxCols, C::kRows,
                              C::kSwizzle);
  }
  if (err) return err;
  int device = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) cerr = wgmma_device<D>(device, &sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  // persistent: one CTA an SM, each taking work items (b*h, query tile) in
  // turn, so one item's loads overlap the last one's products and epilogue
  const int n_qtiles = (lq + C::kQTile - 1) / C::kQTile;
  const int n_items = bh * n_qtiles;
  flash_fwd_wgmma_kernel<D><<<std::min(n_items, sms), C::kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, q_seg, kv_seg, heads, lq, lkv, n_qtiles, n_items,
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                const int* q_seg, const int* kv_seg, int bh, int heads, int lq, int lkv,
                int causal, float sm_scale, cudaStream_t stream) {
  const int n_qtiles = (lq + kBlock - 1) / kBlock;
  constexpr size_t smem = tf32_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_tf32_kernel<D><<<bh * n_qtiles, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, q_seg, kv_seg, heads, lq, lkv, n_qtiles, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const int* q_seg,
           const int* kv_seg, const long long* strides, int bh, int heads, int lq, int lkv,
           int is_bf16, int causal, float sm_scale, cudaStream_t stream) {
  if (is_bf16) {
    return launch_wgmma<D>(q, k, v, o, lse, q_seg, kv_seg, strides, bh, heads, lq, lkv, causal,
                           sm_scale, stream);
  }
  return launch_tf32<D>(q, k, v, o, lse, q_seg, kv_seg, bh, heads, lq, lkv, causal, sm_scale,
                        stream);
}

}  // namespace

// q [bh, lq, d], k and v [bh, lkv, d], o [bh, lq, d] (16-byte aligned, f32
// when is_bf16 == 0 else bf16); lse [bh, lq] f32 (contiguous); q_seg
// [bh/heads, lq] and kv_seg [bh/heads, lkv] int32 (contiguous), both null or
// both set. f32 tensors are contiguous and `strides` is unread; bf16 ones are
// read and written by their byte strides, `strides` holding those of L, H
// and B for q, k, v and o in turn (12 values, each a multiple of 16; the last
// dim is contiguous). d is 32, 64 or 128. Both tiers run on the tensor cores:
// bf16 in one pass (wgmma), f32 in three TF32 passes (mma.sync). Launches on
// `stream` without synchronising and returns the cudaGetLastError() code of
// the launch, or of a refused shared-memory opt-in or tensor map (0 on
// success).
extern "C" int moc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int* q_seg, const int* kv_seg, const long long* strides,
                             int bh, int heads, int lq, int lkv, int d, int is_bf16, int causal,
                             float sm_scale, cudaStream_t stream) {
  if (bh <= 0 || lq <= 0) return 0;
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, lse, q_seg, kv_seg, strides, bh, heads, lq, lkv, is_bf16,
                        causal, sm_scale, stream);
    case 64:
      return launch<64>(q, k, v, o, lse, q_seg, kv_seg, strides, bh, heads, lq, lkv, is_bf16,
                        causal, sm_scale, stream);
    case 128:
      return launch<128>(q, k, v, o, lse, q_seg, kv_seg, strides, bh, heads, lq, lkv, is_bf16,
                         causal, sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
