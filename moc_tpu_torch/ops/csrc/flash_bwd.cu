// K3 and K4: the flash-attention backward, dq and (dk, dv).
//
// Replace the Pallas TPU kernels moc_tpu/ops/flash_attention.py:188
// (_bwd_dq_kernel) and :238 (_bwd_dkv_kernel), both launched by _bwd (:297).
// For q, do [BH, Lq, D], k, v [BH, Lkv, D] (f32 row-major; bf16 read by
// their strides), the forward's lse [BH, Lq] (f32) and delta = rowsum(do * o)
// [BH, Lq] (f32, computed by the caller as _bwd does outside its kernels):
//
//   s  = (q . k) * sm_scale, set to MASK (-0.7 * f32max) where the forward
//        masked it (top-left causal, or another segment);
//   p  = exp(s - lse)                 (recomputed, never stored in memory);
//   dp = do . v;  ds = p * (dp - delta) * sm_scale;
//   K3: dq = ds . k                   (ds rounded to the input type first);
//   K4: dv = p^T . do, dk = ds^T . q  (p and ds rounded to the input type).
//
// Keys at index >= Lkv and queries at index >= Lq (the ragged edges of the
// last tiles) count for nothing. A row whose segment matches no key has
// lse = MASK, so p = exp(0) = 1 for every key of the tiles that run: like
// the TPU kernels, and unlike the dense vjp (1/L), which is the point of
// matching them. The products are summed in f32; dq, dk and dv are stored in
// the input type. Both tiers sum on the tensor cores in another order than
// the plain version, so they agree with it within a tolerance, not bit for
// bit. In bf16 the products are exact, as on the MXU under
// preferred_element_type=f32 (2e-2 of the largest |grad|, from rounding p
// and ds). In f32 every product is taken in three TF32 passes (flash_mma.cuh)
// within a few units in 2^-22 of f32: within the JAX package's f32
// tolerance (5e-4) and within 1e-5 of the largest |grad| of the plain
// version (2e-6 on an H100 at the pretraining shape); one TF32 pass would
// be about 5e-4 off.
//
// Bound at the pretraining shape ([32 * 12, 512, 64]): K3 does three
// products of 2 * L^2 * D per head (s, dp, ds . k), 38.7 GFLOP, and K4 four
// (s, dp, p^T . do, ds^T . q), 51.5 GFLOP. In f32 that is three TF32 passes
// of each at the H100's 495 TFLOP/s, 0.2345 and 0.312 ms, against
// 0.08-0.09 ms for their bytes at 3.35 TB/s, so both are compute-bound (on
// the CUDA cores, 67 TFLOP/s, it would be 0.58 and 0.77 ms). On an H100,
// mma.sync reaches 222-236 TFLOP/s of TF32 in this kernel's pattern of
// three passes and an f32 add (scripts/mma_tf32_rate.py), so 0.49 and
// 0.65 ms is the floor of this design. In bf16 the bound is the operations
// at 989 TFLOP/s, 0.0391 and 0.0521 ms, against 0.038 and 0.046 ms for the
// bytes (q, k, v, do and the gradients once each, lse and delta): both
// bounds are close, so the bf16 kernels must keep the tensor cores fed from
// shared memory and never wait on device memory.
//
// Design: the TPU's split, which needs no atomics. K3 owns query rows and
// loops over the key tiles of K and V; K4 owns key rows and loops over the
// query tiles. Causal tiles above the diagonal are skipped as should_run does
// on the TPU, at 64-row tiles in both tiers: a (query, key) pair runs when
// the key's 64-row tile is not after the query's, which decides what a row
// that matches no key counts. K3 stops at its diagonal key tile, and K4
// starts its query loop at the tile that holds its first key.
//
// f32 (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel): one CTA of four
// warps (16 rows each, mma.sync with flash_mma.cuh's pieces) per (b*h, 64-row
// tile). Q and dO (K3) or K and V (K4) are loaded once, and the other pair's
// tiles (with the segment ids, and K4's lse and delta) stream through a
// two-stage cp.async ring. The tiles are f32 with rows padded to D + 4 floats
// (104 KB of shared memory at D = 64, two CTAs an SM; 203 KB at D = 128), every
// product in three m16n8k8 TF32 passes of operands split as cvt.rna rounds.
// The untransposed operands (Q, dO, K, V of S and dP) are read by ldmatrix;
// there is no 32-bit ldmatrix.trans, so the transposed operands (K of
// ds . K, dO and Q of K4's gradients) are read as scalar pairs from the same
// padded tile, on 32 distinct banks. The accumulator holds columns 2t and
// 2t + 1 where a TF32 A fragment wants t and t + 4: each 8-wide k-step takes
// its k index in the order 0, 2, 4, 6, 1, 3, 5, 7 on both operands, so p and
// ds pass on as A fragments with no shuffle. The tensor core rounds its sums
// toward zero, so two k-steps at a time go into a fresh accumulator that an
// f32 add takes into the running sum. For the register budget: K3 takes a key
// tile in passes of 64 keys at D = 64 (32 at D = 32, 16 at D = 128); K4 takes
// a query tile in passes of 32 queries (16 at D = 128), makes p^T and dv
// before it forms dp^T, and at D = 128 sweeps the query tiles twice, once for
// dv and once for dk (recomputing s^T), so that a warp holds one [16, 128]
// accumulator at a time. No register spills at D = 32, 64 or 128. Left: the
// f32 tier splits its B operands once per warp rather than once per tile,
// and spends an f32 add per accumulator element every two k-steps.
//
// bf16 (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel), built for
// Hopper (flash_sm90.cuh) in the pattern of K2's flash_fwd_wgmma_kernel:
// persistent kernels, one CTA of three warpgroups an SM, each CTA taking work
// items in turn. An item is (b*h, 128-row tile): 128 query rows for K3, 128
// keys for K4, 64 of them for each of the two consumer warpgroups.
// - Warpgroup 0 produces: its first warp issues every copy by TMA (4-D
//   tensor maps over q, k, v, do and the gradients, encoded on the host from
//   their byte strides, so the [B, H, L, D] views of [B, L, H, D] projections
//   are read and written without a copy; rows past L are zero-filled on a
//   load and dropped on a store). The item's own rows (K3: Q and dO; K4: K and
//   V) come once an item into one of two buffers; the other pair streams
//   through a ring of full and empty mbarriers that runs on across items (K3:
//   K and V apart, 128-key tiles, 64 at D = 128; K4: Q and dO together,
//   64-query tiles, 32 at D = 128). Its lanes copy what TMA cannot take (rows
//   of Lq * 4 bytes break its 16-byte stride rule at odd lengths) by
//   cp.async, each lane arriving on the stage's full barrier once its copies
//   land: the key segment ids beside K (K3), and each query tile's lse, delta
//   and segment ids (K4; zero past Lq, where Q and dO are zero-filled, so that
//   such a query adds nothing). It also stores each item's gradients, which the
//   consumers stage in that item's own buffers, before the buffer is loaded
//   again. It keeps 40 registers a thread (setmaxnreg) and gives the rest to
//   the consumers.
// - K3's consumers: S = Q.K^T and dP = dO.V^T are wgmma with both operands in
//   swizzled shared memory, K-major; p and ds are formed in registers (one
//   FFMA and one ex2 a probability, the mask only on tiles that need it), and
//   dq += ds.K is wgmma with ds rounded to bf16 in registers as the A operand
//   and K read MN-major, as K2 takes V in P.V. lse, delta and the segment ids
//   of the warpgroup's 64 rows are read once an item.
// - K4's consumers, the same with keys as rows: S^T = K.Q^T and dP^T =
//   V.dO^T from shared memory, then dv += p^T.dO and dk += ds^T.Q with p^T and
//   ds^T from registers and dO and Q MN-major (the Q tile is read through two
//   descriptors, K-major and MN-major).
// - Both: the products of tile t + 1's scores are issued with tile t's
//   gradient products, so the tensor cores run the one while p and ds of the
//   other wait only for their scores; the two warpgroups take turns to issue
//   (named barriers), so one's elementwise work runs while the other's
//   products hold the tensor cores. The steady loop has no branch around the
//   products. The tile sizes keep every accumulator in registers without a
//   spill: K3 holds S, dP, ds and dq (192 registers a thread at D = 64), K4
//   S^T, dP^T, p^T, ds^T, dk and dv (160 at D = 64; 32 queries a tile at D =
//   128, where dk and dv alone take 128).
// - K4 as first built wrote p^T over S^T in f32 and packed it after the
//   wait for its products, as K2 writes P over S; there ptxas serialised
//   every wgmma of the kernel (its note C7511, "insufficient register
//   resources for the wgmma pipeline") at each D, and K4 took 1.6-1.8 times
//   as long. Probes lifted the note when p^T was not written over S^T, or
//   when no statistic was read from shared memory
//   (scripts/flash_bwd_wgmma_variants.py). So K4 only reads S^T, as K3 only
//   reads S: p^T is rounded straight into its bf16 operand, and the steady
//   loop issues dv of tile t, then tile t + 1's scores, then dk of tile t, in
//   three groups; p^T of tile t + 1 waits for the first two (dv has then
//   released the operand), and ds^T runs beside dk.
// - Causal: K3 stops each item at its last row's diagonal, and each
//   warpgroup's keys at its own 64-row tile's (kv_end; past it, within a
//   running key tile, keys count for nothing, as past Lkv). K4 starts each
//   item at the query tile that holds its first key, and each warpgroup counts
//   queries from its own first key. A warpgroup none of whose rows exists
//   (the last item's second half) computes nothing and keeps the ring and the
//   turns in step.
// - Epilogue: the gradients in bf16 into the warpgroup's own tiles (K3: Q;
//   K4: K for dk and V for dv), swizzled as the output map's boxes lay them
//   out, stored by the producer, one TMA store a box.

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "flash_mma.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;

// --- f32: three TF32 passes on the tensor cores ---

template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // Q and dO; two stages of K and V (f32 rows padded to D + 4); two of the key segment ids
  return sizeof(float) * 6 * Layout<D>::kTile + 2 * kBlock * sizeof(int);
}

// At least one CTA an SM, not the default, under which ptxas holds the
// kernel to 168 registers at D = 32 and it spills there.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, const int* __restrict__ q_seg,
                         const int* __restrict__ kv_seg, int heads, int lq, int lkv, int n_qtiles,
                         int causal, float sm_scale) {
  // keys per pass: the register budget
  constexpr int kKeyChunk = D == 128 ? 16 : D == 64 ? 64 : 32;
  constexpr int kKeyTiles = kKeyChunk / 8;       // n-tiles of S and dP in a pass
  constexpr int kTile = Layout<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kTile;
  float* ks = dos + kTile;     // [2][64, kStride]
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

  // this lane's two query rows, g and g + 8 of the warp's 16, with their
  // lse, delta and segment ids
  const int wrow = 16 * warp;
  const int row0 = q0 + wrow + (lane >> 2);
  const int row1 = row0 + 8;
  float lse0 = 0.f, lse1 = 0.f, delta0 = 0.f, delta1 = 0.f;
  int seg0 = 0, seg1 = 0;
  if (row0 < lq) {
    lse0 = lse[q_off + row0];
    delta0 = delta[q_off + row0];
    if (segments) seg0 = q_seg[static_cast<size_t>(b) * lq + row0];
  }
  if (row1 < lq) {
    lse1 = lse[q_off + row1];
    delta1 = delta[q_off + row1];
    if (segments) seg1 = q_seg[static_cast<size_t>(b) * lq + row1];
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
  load_tile_f32_async<D>(dos, dout + q_off * D, q0, lq, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
      // S and dP for the warp's 16 queries and keys kc .. kc + kKeyChunk
      float s[kKeyTiles][4], dp[kKeyTiles][4];
      tf32_scores<D>(s, qs, wrow, kt, kc, lane);
      tf32_scores<D>(dp, dos, wrow, vt, kc, lane);

      // p and ds in place; the lane holds keys kv0 + kc + 8j + 2 * t4 + (e & 1)
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc + 8 * j + 2 * t4 + (e & 1);
          const int key = kv0 + col;
          const int row = e < 2 ? row0 : row1;
          float x = s[j][e] * sm_scale;
          if (masked(causal, segments, row, key, e < 2 ? seg0 : seg1,
                     segments ? segs[col] : 0)) {
            x = kMaskValue;
          }
          // zero-filled K rows past Lkv give s = 0, not -inf: p is forced
          // there. A difference, not a fused x * log2e - lse * log2e: MASK *
          // log2e overflows
          const float p =
              (row < lq && key < lkv) ? exp2f((x - (e < 2 ? lse0 : lse1)) * kLog2e) : 0.f;
          dp[j][e] = p * (dp[j][e] - (e < 2 ? delta0 : delta1)) * sm_scale;
        }
      }

      // dq += ds . K, the 8 keys of a step as its k index in acc_to_a_tf32's order
      tf32_grads<D>(acc, dp, kt, kc, lane);
    }
  }

  cp_async_wait<0>();  // no copy is left in flight (also when no key tile ran)
  store_acc_f32<D>(dq + q_off * D, acc, q0 + wrow, lq, lane);
}

template <int D>
constexpr size_t dkv_tf32_smem_bytes() {
  // K and V; two stages of Q and dO (f32 rows padded to D + 4); two of lse,
  // delta and the q segment ids
  return sizeof(float) * 6 * Layout<D>::kTile + 2 * kBlock * (2 * sizeof(float) + sizeof(int));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                          int heads, int lq, int lkv, int n_ktiles, int causal, float sm_scale) {
  constexpr int kQChunk = D == 128 ? 16 : 32;  // queries per pass (register budget)
  constexpr int kQTiles = kQChunk / 8;        // n-tiles of s^T and dp^T in a pass
  constexpr int kTile = Layout<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTile;
  float* qs = vs + kTile;        // [2][64, kStride]
  float* dos = qs + 2 * kTile;   // [2][64, kStride]
  float* lse_s = dos + 2 * kTile;                              // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                         // [2][64]
  int* q_segs = reinterpret_cast<int*>(delta_s + 2 * kBlock);  // [2][64]

  const int bh = blockIdx.x / n_ktiles;
  const int kv0 = (blockIdx.x % n_ktiles) * kBlock;
  const int b = bh / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const bool segments = q_seg != nullptr;
  const size_t q_off = static_cast<size_t>(bh) * lq;
  const size_t kv_off = static_cast<size_t>(bh) * lkv;
  const int* q_seg_b = segments ? q_seg + static_cast<size_t>(b) * lq : nullptr;

  // this lane's two keys: rows g and g + 8 of the warp's 16
  const int wrow = 16 * warp;
  const int key0 = kv0 + wrow + (lane >> 2);
  const int key1 = key0 + 8;
  int kseg0 = 0, kseg1 = 0;
  if (segments) {
    if (key0 < lkv) kseg0 = kv_seg[static_cast<size_t>(b) * lkv + key0];
    if (key1 < lkv) kseg1 = kv_seg[static_cast<size_t>(b) * lkv + key1];
  }

  // query tiles wholly above the diagonal see none of these keys: the first
  // tile to run is the one that holds query kv0
  const int q_begin = causal ? kv0 : 0;
  const int n_tiles = q_begin < lq ? (lq - q_begin + kBlock - 1) / kBlock : 0;
  auto load_q = [&](int t) {
    const int stage = t & 1;
    const int q0 = q_begin + t * kBlock;
    load_tile_f32_async<D>(qs + stage * kTile, q + q_off * D, q0, lq, tid);
    load_tile_f32_async<D>(dos + stage * kTile, dout + q_off * D, q0, lq, tid);
    load_vec_async(lse_s + stage * kBlock, lse + q_off, q0, lq, tid);
    load_vec_async(delta_s + stage * kBlock, delta + q_off, q0, lq, tid - kBlock);
    if (segments) load_vec_async(q_segs + stage * kBlock, q_seg_b, q0, lq, tid);
  };

  // One sweep over the query tiles: dv += p^T . dO (kPart & 1) and dk +=
  // ds^T . Q (kPart & 2). At D = 128 dv and dk take a sweep each, so that a
  // warp holds one [16, 128] accumulator and not two; the second sweep
  // recomputes s^T (a fifth product) and reads Q and dO again.
  auto sweep = [&](auto part, float (&dv_acc)[D / 8][4], float (&dk_acc)[D / 8][4]) {
    constexpr int kPart = decltype(part)::value;
    if (n_tiles > 0) load_q(0);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      const int q0 = q_begin + t * kBlock;
      const int stage = t & 1;
      cp_async_wait<0>();
      __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
      if (t + 1 < n_tiles) load_q(t + 1);  // into the stage tile t - 1 used
      cp_async_commit();
      const float* qt = qs + stage * kTile;
      const float* dot = dos + stage * kTile;
      const float* lse_t = lse_s + stage * kBlock;
      const float* delta_t = delta_s + stage * kBlock;
      const int* seg_t = q_segs + stage * kBlock;

#pragma unroll
      for (int qc = 0; qc < kBlock; qc += kQChunk) {
        // p^T for the warp's 16 keys and queries qc .. qc + kQChunk, then
        // dv += p^T . dO; only then dp^T, ds^T and dk += ds^T . Q, so that
        // dp^T is not live beside p^T during the first product. The lane
        // holds queries qc + 8j + 2 * t4 + (e & 1); the queries of a step
        // are its k index in acc_to_a_tf32's order.
        float st[kQTiles][4];
        tf32_scores<D>(st, ks, wrow, qt, qc, lane);
#pragma unroll
        for (int j = 0; j < kQTiles; ++j) {
          const int col = qc + 8 * j + 2 * t4;
          const float2 row_lse = *reinterpret_cast<const float2*>(lse_t + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = q0 + col + (e & 1);
            const int key = e < 2 ? key0 : key1;
            float x = st[j][e] * sm_scale;
            if (masked(causal, segments, query, key, segments ? seg_t[col + (e & 1)] : 0,
                       e < 2 ? kseg0 : kseg1)) {
              x = kMaskValue;
            }
            st[j][e] = (query < lq && key < lkv)
                           ? exp2f((x - ((e & 1) ? row_lse.y : row_lse.x)) * kLog2e)
                           : 0.f;
          }
        }
        if constexpr ((kPart & 1) != 0) tf32_grads<D>(dv_acc, st, dot, qc, lane);

        if constexpr ((kPart & 2) != 0) {
          float dpt[kQTiles][4];
          tf32_scores<D>(dpt, vs, wrow, dot, qc, lane);
#pragma unroll
          for (int j = 0; j < kQTiles; ++j) {
            const float2 row_delta =
                *reinterpret_cast<const float2*>(delta_t + qc + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? row_delta.y : row_delta.x)) *
                          sm_scale;
            }
          }
          tf32_grads<D>(dk_acc, dpt, qt, qc, lane);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before it is loaded again
  };

  load_tile_f32_async<D>(ks, k + kv_off * D, kv0, lkv, tid);  // committed with q tile 0
  load_tile_f32_async<D>(vs, v + kv_off * D, kv0, lkv, tid);
  if constexpr (D == 128) {
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    sweep(std::integral_constant<int, 1>{}, acc, acc);
    store_acc_f32<D>(dv + kv_off * D, acc, kv0 + wrow, lkv, lane);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    sweep(std::integral_constant<int, 2>{}, acc, acc);
    store_acc_f32<D>(dk + kv_off * D, acc, kv0 + wrow, lkv, lane);
  } else {
    float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    }
    sweep(std::integral_constant<int, 3>{}, dv_acc, dk_acc);
    store_acc_f32<D>(dv + kv_off * D, dv_acc, kv0 + wrow, lkv, lane);
    store_acc_f32<D>(dk + kv_off * D, dk_acc, kv0 + wrow, lkv, lane);
  }
}


// --- bf16 on Hopper: wgmma, TMA into an mbarrier ring, a producer warp ---

// What K3's and K4's wgmma kernels share: two consumer warpgroups of 64 rows
// an item, the TMA box geometry and the register split.
constexpr int kWgRows = 64;  // rows a consumer warpgroup owns

template <int D>
struct Sm90Bwd {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kConsumers = 2;
  static constexpr int kRows = kWgRows;
  static constexpr int kItem = kRows * kConsumers;     // rows of a work item
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kSwizzle = D == 32 ? 64 : 128;  // bytes: one box row
  static constexpr int kBoxCols = kSwizzle / 2;        // columns of a TMA box
  static constexpr int kRowBytes = kSwizzle;
  static constexpr int kOwnBytes = kRows * D * 2;      // a warpgroup's rows of one tensor
  // setmaxnreg moves registers within what the CTA was launched with (a
  // multiple of 8 a thread, at most 65536 / kThreads): the producer
  // warpgroup keeps 40 a thread, the consumers share the rest
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= kLaunchRegs * kThreads,
                "setmaxnreg asks for more registers than the CTA holds");
};

// K3's plan: Q and dO an item (two buffers; dq is staged in Q), K and V tiles
// of kKeys through a ring, with the key segment ids beside K
template <int D>
struct Sm90Dq : Sm90Bwd<D> {
  using B = Sm90Bwd<D>;
  static constexpr int kKeys = D == 128 ? 64 : 128;  // keys a tile: the register budget
  static constexpr int kStages = D == 128 ? 2 : 3;   // of the K/V ring: shared memory
  static constexpr int kKVBytes = kKeys * D * 2;     // one stage of K or of V
  static constexpr int kDoOff = 2 * B::kConsumers * B::kOwnBytes;
  static constexpr int kKOff = 2 * kDoOff;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kSegOff = kVOff + kStages * kKVBytes;
  static constexpr int kBarOff = kSegOff + kStages * kKeys * 4;
  // q_full, dq_full a buffer; k_full, k_empty, v_full, v_empty a stage
  static constexpr int kBars = 4 + 4 * kStages;
  static constexpr size_t kSmem = kBarOff + 8 * kBars + 1024;  // + alignment to 1024 bytes
};

// K4's plan: K and V an item (two buffers; dk and dv are staged in them), Q
// and dO tiles of kQ queries through a ring, with each tile's lse, delta and
// segment ids
template <int D>
struct Sm90Dkv : Sm90Bwd<D> {
  using B = Sm90Bwd<D>;
  static constexpr int kQ = D == 128 ? 32 : 64;  // queries a tile: the register budget
  static constexpr int kStages = D == 128 ? 4 : 6;  // of the Q/dO ring: shared memory
  static constexpr int kQBytes = kQ * D * 2;     // one stage of Q or of dO
  static constexpr int kVOff = 2 * B::kConsumers * B::kOwnBytes;
  static constexpr int kQOff = 2 * kVOff;
  static constexpr int kDoOff = kQOff + kStages * kQBytes;
  static constexpr int kStatOff = kDoOff + kStages * kQBytes;
  static constexpr int kBarOff = kStatOff + kStages * 3 * kQ * 4;
  // kv_full, out_full a buffer; full, empty a stage
  static constexpr int kBars = 4 + 2 * kStages;
  static constexpr size_t kSmem = kBarOff + 8 * kBars + 1024;
};

// named barriers: 0 is __syncthreads; from 1 a consumer warpgroup's epilogue
// each, from 4 its turn at the tensor cores
constexpr int kEpilogueBarrier = 1, kTurnBarrier = 4;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc = A . B^T over the D columns for A [64, D] and B [N, D], both K-major in
// shared memory as TMA lays them out (boxes of kBoxCols columns, a box's rows
// apart); k-step ks reads 32 bytes further into a box row, past it the next box
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_tile, uint32_t b_tile) {
  using C = Sm90Bwd<D>;
  constexpr int kStepsPerBox = C::kBoxCols / 16;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t in_row = (ks % kStepsPerBox) * 32;
    const uint32_t box = ks / kStepsPerBox;
    const uint64_t a = sm90::smem_desc<C::kSwizzle>(
        a_tile + box * C::kRows * C::kRowBytes + in_row, 16, 8 * C::kRowBytes);
    const uint64_t b = sm90::smem_desc<C::kSwizzle>(b_tile + box * N * C::kRowBytes + in_row,
                                                    16, 8 * C::kRowBytes);
    sm90::wgmma_ss<N>(acc, a, b, ks > 0);
  }
}

// acc += A . B for A [64, K] in registers (bf16, as pack_a lays it out) and
// B [K, D] MN-major in shared memory (a row of the tile is one k index; boxes
// of kBoxCols columns lie K rows apart)
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b_tile) {
  using C = Sm90Bwd<D>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t b = sm90::smem_desc<C::kSwizzle>(b_tile + kk * 16 * C::kRowBytes,
                                                    K * C::kRowBytes, 8 * C::kRowBytes);
    sm90::wgmma_rs<D>(acc, a[kk], b, 1);
  }
}

// an accumulator of N columns, rounded to bf16, as the A operand of a
// register product (the m16n8k16 A fragment of each warp, as acc_to_a packs it)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// A consumer warpgroup's [64, D] accumulator in bf16 into its tile at `tile`,
// swizzled as the output map's boxes lay it out (the producer stores it)
template <int D>
__device__ __forceinline__ void stage_out(unsigned char* tile, const float (&acc)[D / 2], int wt,
                                          int lane) {
  using C = Sm90Bwd<D>;
  const int t4 = lane & 3;
  const int r0 = 16 * (wt >> 5) + (lane >> 2);
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t4;
    const uint32_t box = (col / C::kBoxCols) * C::kRows * C::kRowBytes;
    const uint32_t c = (col % C::kBoxCols) * 2;
    *reinterpret_cast<uint32_t*>(tile + box + sm90::swizzle<C::kSwizzle>(r0 * C::kRowBytes + c)) =
        pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
    *reinterpret_cast<uint32_t*>(tile + box +
                                 sm90::swizzle<C::kSwizzle>((r0 + 8) * C::kRowBytes + c)) =
        pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// The probability of a score from its row's -lse * log2e (nl): one FFMA and
// one ex2, exp(s * scale - lse) in base 2. A masked score stands for MASK,
// whose probability beside a real lse is 0 and, in a row whose keys are all
// masked (lse = MASK, nl = +inf), exp(MASK - MASK) = 1.
__device__ __forceinline__ float prob(float s, float scale_log2, float nl) {
  return ex2(fmaf(s, scale_log2, nl));
}

__device__ __forceinline__ float masked_prob(float nl) { return nl == INFINITY ? 1.f : 0.f; }

// one K3 consumer thread's two query rows: rows g and g + 8 of its warp's 16
struct DqRows {
  int row0, row1, seg0, seg1;
  float nl0, nl1;  // -lse * log2e (+inf where lse is the mask value)
  float nd0, nd1;  // -delta * sm_scale
};

// p and then ds = p * (dp - delta) * scale of K3's key tile at kv0, in place of
// dp; the lane holds keys kv0 + 8j + 2t + (e & 1). kMask: keys at kv_end or
// past count for nothing, masked ones take the mask value
template <int N, bool kMask>
__device__ __forceinline__ void dq_tile(const float (&s)[N / 2], float (&dp)[N / 2],
                                        const DqRows& r, int kv0, int kv_end, bool causal,
                                        bool segments, const int* segs, int t4, float scale_log2,
                                        float sm_scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float nl = e < 2 ? r.nl0 : r.nl1;
      float p = prob(s[i], scale_log2, nl);
      if (kMask) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int key = kv0 + col;
        if (key >= kv_end) {
          p = 0.f;
        } else if (masked(causal, segments, e < 2 ? r.row0 : r.row1, key,
                          e < 2 ? r.seg0 : r.seg1, segments ? segs[col] : 0)) {
          p = masked_prob(nl);
        }
      }
      dp[i] = p * fmaf(dp[i], sm_scale, e < 2 ? r.nd0 : r.nd1);
    }
  }
}

// p and ds of K3's key tile at kv0 for the warpgroup whose first row is qw,
// masked only where a key of the tile is at kv_end or past, or after a row,
// or segments are given
template <int N>
__device__ __forceinline__ void dq_grads(const float (&s)[N / 2], float (&dp)[N / 2],
                                         const DqRows& r, int kv0, int kv_end, int qw,
                                         bool causal, bool segments, const int* segs, int t4,
                                         float scale_log2, float sm_scale) {
  if (segments || kv0 + N > kv_end || (causal && kv0 + N - 1 > qw)) {
    dq_tile<N, true>(s, dp, r, kv0, kv_end, causal, segments, segs, t4, scale_log2, sm_scale);
  } else {
    dq_tile<N, false>(s, dp, r, kv0, kv_end, causal, segments, segs, t4, scale_log2, sm_scale);
  }
}

// A consumer warpgroup's part in a K3 item none of whose rows exists: every
// K/V tile waited for and released, and the turns taken, as in the item's
// products (n_tiles + 1 turns: the first tile's scores, then each next tile's
// scores with the last one's dq, then the last dq), so that the ring and the
// turns stay in step.
template <int kStages>
__device__ __forceinline__ void idle_dq(int g, int n_tiles, uint32_t k_full, uint32_t k_empty,
                                        uint32_t v_full, uint32_t v_empty, int my_turn,
                                        int their_turn, bool signal) {
  for (int t = 0; t <= n_tiles && n_tiles > 0; ++t) {
    if (t < n_tiles) {
      const int stage = (g + t) % kStages;
      const uint32_t parity = ((g + t) / kStages) & 1;
      sm90::mbar_wait(k_full + 8 * stage, parity);
      sm90::mbar_wait(v_full + 8 * stage, parity);
      if (signal) {
        sm90::mbar_arrive(k_empty + 8 * stage);
        sm90::mbar_arrive(v_empty + 8 * stage);
      }
    }
    sm90::named_barrier(my_turn, 256);
    sm90::named_arrive(their_turn, 256);
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90Bwd<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                          int heads, int lq, int lkv, int n_qtiles, int n_items, int causal,
                          float sm_scale) {
  using C = Sm90Dq<D>;
  constexpr int kKeys = C::kKeys, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles (and wgmma's descriptors) need 1024-byte aligned addresses
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  int* seg_smem = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kSegOff);
  const uint32_t bars = base + C::kBarOff;
  const uint32_t q_full = bars;                 // [2]: a Q/dO buffer each
  const uint32_t dq_full = q_full + 16;         // [2]
  const uint32_t k_full = dq_full + 16;         // [kStages]
  const uint32_t k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool segments = q_seg != nullptr;
  // the work item (b*h, 128-row query tile) and its key tiles: those wholly
  // above the diagonal of the item's last row contribute nothing
  auto item_of = [&](int item, int& bh, int& q0, int& n_tiles) {
    bh = item / n_qtiles;
    q0 = (item % n_qtiles) * C::kItem;
    const int kv_stop = causal ? min(lkv, q0 + C::kItem) : lkv;
    n_tiles = (kv_stop + kKeys - 1) / kKeys;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(q_full + 8 * i, 1);
      sm90::mbar_init(dq_full + 8 * i, 128 * C::kConsumers);  // every consumer thread
    }
    for (int s = 0; s < kStages; ++s) {
      // the producer warp's lanes (segment ids) and its first lane's byte count
      sm90::mbar_init(k_full + 8 * s, 33);
      sm90::mbar_init(k_empty + 8 * s, 4 * C::kConsumers);  // every consumer warp
      sm90::mbar_init(v_full + 8 * s, 1);
      sm90::mbar_init(v_empty + 8 * s, 4 * C::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: every load and store of every item of this CTA, in order ----
    sm90::reg_dealloc<C::kProducerRegs>();
    if (warp != 0) return;
    if (lane == 0) {
      sm90::tma_prefetch(&q_map);
      sm90::tma_prefetch(&k_map);
      sm90::tma_prefetch(&v_map);
      sm90::tma_prefetch(&do_map);
    }
    // the dq that the consumers staged in Q buffer jj & 1 for item jj (rows
    // past Lq dropped), stored before the buffer takes another Q
    auto store_dq = [&](int jj) {
      int bh, q0, n_tiles;
      item_of(blockIdx.x + jj * gridDim.x, bh, q0, n_tiles);
      sm90::mbar_wait(dq_full + 8 * (jj & 1), (jj >> 1) & 1);
      if (lane == 0) {
        const uint32_t src = base + (jj & 1) * C::kConsumers * C::kOwnBytes;
        for (int w = 0; w < C::kConsumers && q0 + w * C::kRows < lq; ++w) {
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_store(&dq_map, src + w * C::kOwnBytes + box * C::kRows * C::kRowBytes,
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
      // Q and dO of both consumers into buffer j & 1, once the dq of item j - 2 left it
      if (j >= 2) store_dq(j - 2);
      if (lane == 0) {
        const uint32_t q_dst = base + (j & 1) * C::kConsumers * C::kOwnBytes;
        const uint32_t bar = q_full + 8 * (j & 1);
        sm90::mbar_arrive_tx(bar, 2 * C::kConsumers * C::kOwnBytes);
        for (int w = 0; w < C::kConsumers; ++w) {
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            const uint32_t off = w * C::kOwnBytes + box * C::kRows * C::kRowBytes;
            sm90::tma_load(q_dst + off, &q_map, bar, box * C::kBoxCols, q0 + w * C::kRows, h, b);
            sm90::tma_load(q_dst + C::kDoOff + off, &do_map, bar, box * C::kBoxCols,
                           q0 + w * C::kRows, h, b);
          }
        }
      }
      for (int t = 0; t < n_tiles; ++t, ++g) {
        const int s = g % kStages;
        const uint32_t parity = ((g / kStages) & 1) ^ 1;  // the first round passes
        sm90::mbar_wait(k_empty + 8 * s, parity);
        // every lane arrives once: with segments once its ids (cp.async, zero
        // past Lkv, where keys count for nothing) have landed
        if (segments) {
#pragma unroll
          for (int i = 0; i < kKeys / 32; ++i) {
            const int col = 32 * i + lane, key = t * kKeys + col;
            const bool real = key < lkv;
            cp_async4(seg_smem + s * kKeys + col,
                      kv_seg + static_cast<size_t>(b) * lkv + (real ? key : 0), real);
          }
          sm90::cp_async_mbar_arrive(k_full + 8 * s);
        } else {
          sm90::mbar_arrive(k_full + 8 * s);
        }
        if (lane == 0) {
          sm90::mbar_arrive_tx(k_full + 8 * s, C::kKVBytes);
          const uint32_t dst = base + C::kKOff + s * C::kKVBytes;
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_load(dst + box * kKeys * C::kRowBytes, &k_map, k_full + 8 * s,
                           box * C::kBoxCols, t * kKeys, h, b);
          }
        }
        sm90::mbar_wait(v_empty + 8 * s, parity);
        if (lane == 0) {
          sm90::mbar_arrive_tx(v_full + 8 * s, C::kKVBytes);
          const uint32_t dst = base + C::kVOff + s * C::kKVBytes;
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_load(dst + box * kKeys * C::kRowBytes, &v_map, v_full + 8 * s,
                           box * C::kBoxCols, t * kKeys, h, b);
          }
        }
      }
    }
    for (int jj = j < 2 ? 0 : j - 2; jj < j; ++jj) store_dq(jj);
  } else {
    // ---- consumers: 64 query rows of every item each ----
    sm90::reg_alloc<C::kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int wt = threadIdx.x & 127;  // thread in the warpgroup
    const int t4 = lane & 3;
    const bool signal = lane == 0;  // one arrival a warp on the empty barriers
    const float scale_log2 = sm_scale * kLog2e;
    // The consumer warpgroups take turns to issue their products (a named
    // barrier each, passed round): one's elementwise work runs while the
    // other's products hold the tensor cores. Warpgroup 0 goes first.
    const int my_turn = kTurnBarrier + wg;
    const int their_turn = kTurnBarrier + (wg + 1) % C::kConsumers;
    if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);

    float dq[D / 2];
    float s[kKeys / 2], dp[kKeys / 2];
    uint32_t ds[kKeys / 16][4];
    int g = 0;  // K/V tiles consumed so far, over all items
    for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, q0, n_tiles;
      item_of(item, bh, q0, n_tiles);
      const int b = bh / heads;
      const int qw = q0 + wg * C::kRows;  // the warpgroup's first query row
      // a causal row's keys end at its 64-row tile's diagonal: past it, within
      // a running tile, keys count for nothing, as past Lkv
      const int kv_end = causal ? min(lkv, qw + C::kRows) : lkv;
      const uint32_t q_tile = base + ((j & 1) * C::kConsumers + wg) * C::kOwnBytes;
      const uint32_t do_tile = q_tile + C::kDoOff;
      if (qw >= lq) {
        // no row of this warpgroup exists (the last query tile's second half):
        // keep the ring and the turns in step, and compute nothing
        idle_dq<kStages>(g, n_tiles, k_full, k_empty, v_full, v_empty, my_turn, their_turn,
                         signal);
        g += n_tiles;
        sm90::mbar_arrive(dq_full + 8 * (j & 1));
        continue;
      }
      DqRows r;
      r.row0 = qw + 16 * (wt >> 5) + (lane >> 2);
      r.row1 = r.row0 + 8;
      r.seg0 = r.seg1 = 0;
      r.nl0 = r.nl1 = r.nd0 = r.nd1 = 0.f;  // rows past Lq: their dq is dropped
      const size_t stat0 = static_cast<size_t>(bh) * lq;
      if (r.row0 < lq) {
        r.nl0 = -lse[stat0 + r.row0] * kLog2e;
        r.nd0 = -delta[stat0 + r.row0] * sm_scale;
        if (segments) r.seg0 = q_seg[static_cast<size_t>(b) * lq + r.row0];
      }
      if (r.row1 < lq) {
        r.nl1 = -lse[stat0 + r.row1] * kLog2e;
        r.nd1 = -delta[stat0 + r.row1] * sm_scale;
        if (segments) r.seg1 = q_seg[static_cast<size_t>(b) * lq + r.row1];
      }
      sm90::mbar_wait(q_full + 8 * (j & 1), (j >> 1) & 1);
      zero(dq);
      if (n_tiles > 0) {
        const int stage0 = g % kStages;
        const uint32_t parity0 = (g / kStages) & 1;
        sm90::mbar_wait(k_full + 8 * stage0, parity0);
        sm90::mbar_wait(v_full + 8 * stage0, parity0);
        sm90::named_barrier(my_turn, 256);
        sm90::wgmma_fence();
        issue_ss<D, kKeys>(s, q_tile, base + C::kKOff + stage0 * C::kKVBytes);
        issue_ss<D, kKeys>(dp, do_tile, base + C::kVOff + stage0 * C::kKVBytes);
        sm90::wgmma_commit();
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (signal) sm90::mbar_arrive(v_empty + 8 * stage0);
        dq_grads<kKeys>(s, dp, r, 0, kv_end, qw, causal, segments, seg_smem + stage0 * kKeys,
                        t4, scale_log2, sm_scale);
        pack_a<kKeys>(ds, dp);
        // the steady state, free of branches around the products: the scores
        // of tile t + 1 run beside dq += ds . K of tile t, and p and ds of
        // tile t + 1 wait only for their scores
        for (int t = 0; t + 1 < n_tiles; ++t) {
          const int gt = g + t;
          const int stage = gt % kStages, stage1 = (gt + 1) % kStages;
          const uint32_t parity1 = ((gt + 1) / kStages) & 1;
          sm90::mbar_wait(k_full + 8 * stage1, parity1);
          sm90::mbar_wait(v_full + 8 * stage1, parity1);
          sm90::named_barrier(my_turn, 256);
          sm90::wgmma_fence();
          issue_ss<D, kKeys>(s, q_tile, base + C::kKOff + stage1 * C::kKVBytes);
          issue_ss<D, kKeys>(dp, do_tile, base + C::kVOff + stage1 * C::kKVBytes);
          sm90::wgmma_commit();
          issue_rs<D, kKeys>(dq, ds, base + C::kKOff + stage * C::kKVBytes);
          sm90::wgmma_commit();
          sm90::named_arrive(their_turn, 256);
          sm90::wgmma_wait<1>();  // the scores of tile t + 1 are done; dq runs on
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          if (signal) sm90::mbar_arrive(v_empty + 8 * stage1);
          dq_grads<kKeys>(s, dp, r, (t + 1) * kKeys, kv_end, qw, causal, segments,
                          seg_smem + stage1 * kKeys, t4, scale_log2, sm_scale);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dq);
          sm90::fence_regs(ds);
          if (signal) sm90::mbar_arrive(k_empty + 8 * stage);
          pack_a<kKeys>(ds, dp);
        }
        const int last = g + n_tiles - 1, stage = last % kStages;
        sm90::named_barrier(my_turn, 256);
        sm90::wgmma_fence();
        issue_rs<D, kKeys>(dq, ds, base + C::kKOff + stage * C::kKVBytes);
        sm90::wgmma_commit();
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        sm90::fence_regs(ds);
        if (signal) sm90::mbar_arrive(k_empty + 8 * stage);
      }
      g += n_tiles;
      // dq in bf16 into the warpgroup's Q tile, once every product of the
      // warpgroup that reads it is done; the producer stores it
      sm90::named_barrier(kEpilogueBarrier + wg, 128);
      stage_out<D>(smem_raw + (q_tile - raw), dq, wt, lane);
      sm90::fence_async_smem();
      sm90::mbar_arrive(dq_full + 8 * (j & 1));
    }
  }
}

// one K4 consumer thread's two keys: rows g and g + 8 of its warp's 16
struct DkvKeys {
  int key0, key1, seg0, seg1;
};

// p^T and ds^T of K4's query tile at q0: p^T rounded to bf16 straight into
// `pt`, the A operand of dv += p^T . dO (as pack_a lays it out), and ds^T in
// f32 in place of dp^T; s^T is only read. The lane holds queries q0 + 8j + 2t
// + (e & 1), whose lse, delta and segment ids are in shared memory. kMask:
// queries before q_begin (a causal warpgroup's first key) count for nothing,
// masked scores take the mask value
template <int N, bool kMask>
__device__ __forceinline__ void dkv_tile(const float (&st)[N / 2], float (&dpt)[N / 2],
                                         uint32_t (&pt)[N / 16][4], const DkvKeys& r, int q0,
                                         int q_begin, bool causal, bool segments,
                                         const float* lse_s, const float* delta_s,
                                         const int* seg_s, int t4, float scale_log2,
                                         float sm_scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
    // -lse * log2e (+inf where lse is the mask value) and -delta * sm_scale
    const float2 nl = make_float2(-l.x * kLog2e, -l.y * kLog2e);
    const float2 nd = make_float2(-dl.x * sm_scale, -dl.y * sm_scale);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float nlq = (e & 1) ? nl.y : nl.x;
      p[e] = prob(st[i], scale_log2, nlq);
      if (kMask) {
        const int query = q0 + col + (e & 1);
        if (query < q_begin) {
          p[e] = 0.f;
        } else if (masked(causal, segments, query, e < 2 ? r.key0 : r.key1,
                          segments ? seg_s[col + (e & 1)] : 0, e < 2 ? r.seg0 : r.seg1)) {
          p[e] = masked_prob(nlq);
        }
      }
      dpt[i] = p[e] * fmaf(dpt[i], sm_scale, (e & 1) ? nd.y : nd.x);
    }
    // block j is k-step j / 2's columns 0-7 (j even) or 8-15 (j odd)
    pt[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pt[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

// p^T and ds^T of K4's query tile at q0, whose statistics are at `stats`
// (lse, delta, segment ids: N each), for the warpgroup whose first key is
// kw; masked only on the tiles that hold a query before a key of the
// warpgroup, or with segments
template <int N>
__device__ __forceinline__ void dkv_probs(const float (&st)[N / 2], float (&dpt)[N / 2],
                                          uint32_t (&pt)[N / 16][4], const DkvKeys& r, int q0,
                                          int kw, bool causal, bool segments, const float* stats,
                                          int t4, float scale_log2, float sm_scale) {
  const int* seg_s = reinterpret_cast<const int*>(stats + 2 * N);
  // a causal warpgroup counts queries from its own first key: the query tiles
  // before it run for the other warpgroup only
  const int q_begin = causal ? kw : 0;
  if (segments || (causal && q0 < kw + kWgRows)) {
    dkv_tile<N, true>(st, dpt, pt, r, q0, q_begin, causal, segments, stats, stats + N, seg_s,
                      t4, scale_log2, sm_scale);
  } else {
    dkv_tile<N, false>(st, dpt, pt, r, q0, q_begin, causal, segments, stats, stats + N, seg_s,
                       t4, scale_log2, sm_scale);
  }
}

// A consumer warpgroup's part in a K4 item none of whose keys exists, as
// idle_dq is K3's: every query tile waited for and released, n_q + 1 turns
template <int kStages>
__device__ __forceinline__ void idle_dkv(int g, int n_q, uint32_t full, uint32_t empty,
                                         int my_turn, int their_turn, bool signal) {
  for (int t = 0; t <= n_q && n_q > 0; ++t) {
    if (t < n_q) {
      const int stage = (g + t) % kStages;
      sm90::mbar_wait(full + 8 * stage, ((g + t) / kStages) & 1);
      if (signal) sm90::mbar_arrive(empty + 8 * stage);
    }
    sm90::named_barrier(my_turn, 256);
    sm90::named_arrive(their_turn, 256);
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90Bwd<D>::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap dk_map,
                           const __grid_constant__ CUtensorMap dv_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                           int heads, int lq, int lkv, int n_ktiles, int n_items, int causal,
                           float sm_scale) {
  using C = Sm90Dkv<D>;
  constexpr int kQ = C::kQ, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // a stage's lse, delta and segment ids, kQ each
  float* stat_smem = reinterpret_cast<float*>(smem_raw + (base - raw) + C::kStatOff);
  const uint32_t bars = base + C::kBarOff;
  const uint32_t kv_full = bars;         // [2]: a K/V buffer each
  const uint32_t out_full = kv_full + 16;  // [2]
  const uint32_t full = out_full + 16;   // [kStages]
  const uint32_t empty = full + 8 * kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool segments = q_seg != nullptr;
  // the work item (b*h, 128-key tile) and its query tiles: those wholly above
  // the diagonal see none of its keys, so a causal item starts at the tile
  // that holds its first key
  auto item_of = [&](int item, int& bh, int& k0, int& q_start, int& n_q) {
    bh = item / n_ktiles;
    k0 = (item % n_ktiles) * C::kItem;
    q_start = causal ? k0 : 0;
    n_q = q_start < lq ? (lq - q_start + kQ - 1) / kQ : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(kv_full + 8 * i, 1);
      sm90::mbar_init(out_full + 8 * i, 128 * C::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      // the producer warp's lanes (the statistics) and its first lane's byte count
      sm90::mbar_init(full + 8 * s, 33);
      sm90::mbar_init(empty + 8 * s, 4 * C::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer ----
    sm90::reg_dealloc<C::kProducerRegs>();
    if (warp != 0) return;
    if (lane == 0) {
      sm90::tma_prefetch(&k_map);
      sm90::tma_prefetch(&v_map);
      sm90::tma_prefetch(&q_map);
      sm90::tma_prefetch(&do_map);
    }
    // the dk and dv that the consumers staged in K/V buffer jj & 1 for item
    // jj (keys past Lkv dropped), stored before the buffer is loaded again
    auto store_out = [&](int jj) {
      int bh, k0, q_start, n_q;
      item_of(blockIdx.x + jj * gridDim.x, bh, k0, q_start, n_q);
      sm90::mbar_wait(out_full + 8 * (jj & 1), (jj >> 1) & 1);
      if (lane == 0) {
        const uint32_t src = base + (jj & 1) * C::kConsumers * C::kOwnBytes;
        for (int w = 0; w < C::kConsumers && k0 + w * C::kRows < lkv; ++w) {
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            const uint32_t off = w * C::kOwnBytes + box * C::kRows * C::kRowBytes;
            sm90::tma_store(&dk_map, src + off, box * C::kBoxCols, k0 + w * C::kRows,
                            bh % heads, bh / heads);
            sm90::tma_store(&dv_map, src + C::kVOff + off, box * C::kBoxCols,
                            k0 + w * C::kRows, bh % heads, bh / heads);
          }
        }
        sm90::tma_store_commit_and_wait();
      }
      __syncwarp();
    };
    int g = 0;  // query tiles loaded so far, over all items: the ring's position
    int j = 0;
    for (int item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, k0, q_start, n_q;
      item_of(item, bh, k0, q_start, n_q);
      const int b = bh / heads, h = bh % heads;
      if (j >= 2) store_out(j - 2);
      if (lane == 0) {
        const uint32_t k_dst = base + (j & 1) * C::kConsumers * C::kOwnBytes;
        const uint32_t bar = kv_full + 8 * (j & 1);
        sm90::mbar_arrive_tx(bar, 2 * C::kConsumers * C::kOwnBytes);
        for (int w = 0; w < C::kConsumers; ++w) {
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            const uint32_t off = w * C::kOwnBytes + box * C::kRows * C::kRowBytes;
            sm90::tma_load(k_dst + off, &k_map, bar, box * C::kBoxCols, k0 + w * C::kRows, h, b);
            sm90::tma_load(k_dst + C::kVOff + off, &v_map, bar, box * C::kBoxCols,
                           k0 + w * C::kRows, h, b);
          }
        }
      }
      const size_t stat0 = static_cast<size_t>(bh) * lq;
      for (int t = 0; t < n_q; ++t, ++g) {
        const int s = g % kStages;
        const int q0 = q_start + t * kQ;
        sm90::mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);  // the first round passes
        // lse, delta and the segment ids by cp.async, each lane arriving once
        // they have landed; zero past Lq, where TMA zero-fills Q and dO, so
        // that such a query adds nothing to dk or dv
        float* stats = stat_smem + s * 3 * kQ;
#pragma unroll
        for (int i = 0; i < kQ / 32; ++i) {
          const int col = 32 * i + lane, query = q0 + col;
          const bool real = query < lq;
          const size_t at = real ? query : 0;
          cp_async4(stats + col, lse + stat0 + at, real);
          cp_async4(stats + kQ + col, delta + stat0 + at, real);
          if (segments) {
            cp_async4(stats + 2 * kQ + col, q_seg + static_cast<size_t>(b) * lq + at, real);
          }
        }
        sm90::cp_async_mbar_arrive(full + 8 * s);
        if (lane == 0) {
          sm90::mbar_arrive_tx(full + 8 * s, 2 * C::kQBytes);
          const uint32_t q_dst = base + C::kQOff + s * C::kQBytes;
          const uint32_t do_dst = base + C::kDoOff + s * C::kQBytes;
#pragma unroll
          for (int box = 0; box < D / C::kBoxCols; ++box) {
            sm90::tma_load(q_dst + box * kQ * C::kRowBytes, &q_map, full + 8 * s,
                           box * C::kBoxCols, q0, h, b);
            sm90::tma_load(do_dst + box * kQ * C::kRowBytes, &do_map, full + 8 * s,
                           box * C::kBoxCols, q0, h, b);
          }
        }
      }
    }
    for (int jj = j < 2 ? 0 : j - 2; jj < j; ++jj) store_out(jj);
  } else {
    // ---- consumers: 64 keys of every item each ----
    sm90::reg_alloc<C::kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int wt = threadIdx.x & 127;
    const int t4 = lane & 3;
    const bool signal = lane == 0;
    const float scale_log2 = sm_scale * kLog2e;
    const int my_turn = kTurnBarrier + wg;
    const int their_turn = kTurnBarrier + (wg + 1) % C::kConsumers;
    if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);

    float dk[D / 2], dv[D / 2];
    float st[kQ / 2], dpt[kQ / 2];
    uint32_t pt[kQ / 16][4], dst[kQ / 16][4];
    int g = 0;  // query tiles consumed so far, over all items
    for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, k0, q_start, n_q;
      item_of(item, bh, k0, q_start, n_q);
      const int b = bh / heads;
      const int kw = k0 + wg * C::kRows;  // the warpgroup's first key
      const uint32_t k_tile = base + ((j & 1) * C::kConsumers + wg) * C::kOwnBytes;
      const uint32_t v_tile = k_tile + C::kVOff;
      if (kw >= lkv) {
        idle_dkv<kStages>(g, n_q, full, empty, my_turn, their_turn, signal);
        g += n_q;
        sm90::mbar_arrive(out_full + 8 * (j & 1));
        continue;
      }
      DkvKeys r;
      r.key0 = kw + 16 * (wt >> 5) + (lane >> 2);
      r.key1 = r.key0 + 8;
      r.seg0 = r.seg1 = 0;
      if (segments) {  // keys past Lkv: their dk and dv are dropped
        if (r.key0 < lkv) r.seg0 = kv_seg[static_cast<size_t>(b) * lkv + r.key0];
        if (r.key1 < lkv) r.seg1 = kv_seg[static_cast<size_t>(b) * lkv + r.key1];
      }
      auto q_at = [&](int stage) { return base + C::kQOff + stage * C::kQBytes; };
      auto do_at = [&](int stage) { return base + C::kDoOff + stage * C::kQBytes; };
      sm90::mbar_wait(kv_full + 8 * (j & 1), (j >> 1) & 1);
      zero(dk);
      zero(dv);
      if (n_q > 0) {
        const int stage0 = g % kStages;
        sm90::mbar_wait(full + 8 * stage0, (g / kStages) & 1);
        sm90::named_barrier(my_turn, 256);
        sm90::wgmma_fence();
        issue_ss<D, kQ>(st, k_tile, q_at(stage0));
        issue_ss<D, kQ>(dpt, v_tile, do_at(stage0));
        sm90::wgmma_commit();
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        dkv_probs<kQ>(st, dpt, pt, r, q_start, kw, causal, segments, stat_smem + stage0 * 3 * kQ,
                      t4, scale_log2, sm_scale);
        pack_a<kQ>(dst, dpt);
        // the steady state, free of branches around the products: dv of tile
        // t, the scores of tile t + 1 and dk of tile t, in that order, so that
        // p^T and ds^T of tile t + 1 wait for their scores and for dv (whose
        // operand p^T they overwrite) while dk runs on
        for (int t = 0; t + 1 < n_q; ++t) {
          const int gt = g + t;
          const int stage = gt % kStages, stage1 = (gt + 1) % kStages;
          sm90::mbar_wait(full + 8 * stage1, ((gt + 1) / kStages) & 1);
          sm90::named_barrier(my_turn, 256);
          sm90::wgmma_fence();
          issue_rs<D, kQ>(dv, pt, do_at(stage));
          sm90::wgmma_commit();
          issue_ss<D, kQ>(st, k_tile, q_at(stage1));
          issue_ss<D, kQ>(dpt, v_tile, do_at(stage1));
          sm90::wgmma_commit();
          issue_rs<D, kQ>(dk, dst, q_at(stage));
          sm90::wgmma_commit();
          sm90::named_arrive(their_turn, 256);
          sm90::wgmma_wait<1>();  // dv of tile t and the scores of tile t + 1 are done
          sm90::fence_regs(st);
          sm90::fence_regs(dpt);
          sm90::fence_regs(dv);
          sm90::fence_regs(pt);
          dkv_probs<kQ>(st, dpt, pt, r, q_start + (t + 1) * kQ, kw, causal, segments,
                        stat_smem + stage1 * 3 * kQ, t4, scale_log2, sm_scale);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dk);
          sm90::fence_regs(dst);
          if (signal) sm90::mbar_arrive(empty + 8 * stage);
          pack_a<kQ>(dst, dpt);
        }
        const int last = g + n_q - 1, stage = last % kStages;
        sm90::named_barrier(my_turn, 256);
        sm90::wgmma_fence();
        issue_rs<D, kQ>(dv, pt, do_at(stage));
        issue_rs<D, kQ>(dk, dst, q_at(stage));
        sm90::wgmma_commit();
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dk);
        sm90::fence_regs(dv);
        sm90::fence_regs(pt);
        sm90::fence_regs(dst);
        if (signal) sm90::mbar_arrive(empty + 8 * stage);
      }
      g += n_q;
      // dk and dv in bf16 into the warpgroup's K and V tiles (also where no
      // query tile ran: zeros), once every product that reads them is done
      sm90::named_barrier(kEpilogueBarrier + wg, 128);
      stage_out<D>(smem_raw + (k_tile - raw), dk, wt, lane);
      stage_out<D>(smem_raw + (v_tile - raw), dv, wt, lane);
      sm90::fence_async_smem();
      sm90::mbar_arrive(out_full + 8 * (j & 1));
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *q_seg, *kv_seg;
  // bf16: the byte strides of L, H and B of q, k, v, do and then the
  // gradients (dq; or dk, dv), as the tensor maps take them
  const long long* strides;
  int bh, heads, lq, lkv, causal;
  float sm_scale;
  cudaStream_t stream;
};

// bf16 K3: tensor maps over q, do, k, v and dq by their byte strides, then one
// launch of the persistent kernel (one CTA an SM over the (b*h, 128-row) items)
template <int D>
int launch_dq_wgmma(const Args& a, void* dq) {
  using C = Sm90Dq<D>;
  const int b = a.bh / a.heads;
  const long long* st = a.strides;
  CUtensorMap maps[5] = {};  // q, k, v, do, dq
  auto map = [&](int i, const void* p, int len, const long long* strides, int rows) {
    return sm90_host::make_map(&maps[i], sm90_host::kBf16, p, D, len, a.heads, b, strides,
                               C::kBoxCols, rows, C::kSwizzle);
  };
  int err = map(0, a.q, a.lq, st, C::kRows);
  if (!err && a.lkv > 0) {  // no key: no K or V tile is loaded
    err = map(1, a.k, a.lkv, st + 3, C::kKeys);
    if (!err) err = map(2, a.v, a.lkv, st + 6, C::kKeys);
  }
  if (!err) err = map(3, a.dout, a.lq, st + 9, C::kRows);
  if (!err) err = map(4, dq, a.lq, st + 12, C::kRows);
  if (err) return err;
  static std::atomic<int> known[sm90_host::kDevices];
  int sms = 0;
  const cudaError_t cerr =
      sm90_host::persistent_sms(flash_bwd_dq_wgmma_kernel<D>, C::kSmem, known, &sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_qtiles = (a.lq + C::kItem - 1) / C::kItem;
  const int n_items = a.bh * n_qtiles;
  flash_bwd_dq_wgmma_kernel<D><<<std::min(n_items, sms), C::kThreads, C::kSmem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a.lse, a.delta, a.q_seg, a.kv_seg, a.heads,
      a.lq, a.lkv, n_qtiles, n_items, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 K4: tensor maps over k, v, q, do, dk and dv by their byte strides,
// then one launch over the (b*h, 128-key) items
template <int D>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  using C = Sm90Dkv<D>;
  const int b = a.bh / a.heads;
  const long long* st = a.strides;
  CUtensorMap maps[6] = {};  // k, v, q, do, dk, dv
  auto map = [&](int i, const void* p, int len, const long long* strides, int rows) {
    return sm90_host::make_map(&maps[i], sm90_host::kBf16, p, D, len, a.heads, b, strides,
                               C::kBoxCols, rows, C::kSwizzle);
  };
  int err = map(0, a.k, a.lkv, st + 3, C::kRows);
  if (!err) err = map(1, a.v, a.lkv, st + 6, C::kRows);
  if (!err && a.lq > 0) {  // no query: no Q or dO tile is loaded
    err = map(2, a.q, a.lq, st, C::kQ);
    if (!err) err = map(3, a.dout, a.lq, st + 9, C::kQ);
  }
  if (!err) err = map(4, dk, a.lkv, st + 12, C::kRows);
  if (!err) err = map(5, dv, a.lkv, st + 15, C::kRows);
  if (err) return err;
  static std::atomic<int> known[sm90_host::kDevices];
  int sms = 0;
  const cudaError_t cerr =
      sm90_host::persistent_sms(flash_bwd_dkv_wgmma_kernel<D>, C::kSmem, known, &sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_ktiles = (a.lkv + C::kItem - 1) / C::kItem;
  const int n_items = a.bh * n_ktiles;
  flash_bwd_dkv_wgmma_kernel<D><<<std::min(n_items, sms), C::kThreads, C::kSmem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.lse, a.delta, a.q_seg, a.kv_seg,
      a.heads, a.lq, a.lkv, n_ktiles, n_items, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, int is_bf16, void* dq) {
  if (is_bf16) return launch_dq_wgmma<D>(a, dq);
  const int n_qtiles = (a.lq + kBlock - 1) / kBlock;
  constexpr size_t smem = dq_tf32_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_tf32_kernel<D><<<a.bh * n_qtiles, kMmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(dq), a.q_seg, a.kv_seg, a.heads, a.lq, a.lkv, n_qtiles, a.causal,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, int is_bf16, void* dk, void* dv) {
  if (is_bf16) return launch_dkv_wgmma<D>(a, dk, dv);
  const int n_ktiles = (a.lkv + kBlock - 1) / kBlock;
  constexpr size_t smem = dkv_tf32_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_tf32_kernel<D><<<a.bh * n_ktiles, kMmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(dk), static_cast<float*>(dv), a.q_seg, a.kv_seg, a.heads, a.lq,
      a.lkv, n_ktiles, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dq(const Args& a, int d, int is_bf16, void* dq) {
  switch (d) {
    case 32: return launch_dq<32>(a, is_bf16, dq);
    case 64: return launch_dq<64>(a, is_bf16, dq);
    case 128: return launch_dq<128>(a, is_bf16, dq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_dkv(const Args& a, int d, int is_bf16, void* dk, void* dv) {
  switch (d) {
    case 32: return launch_dkv<32>(a, is_bf16, dk, dv);
    case 64: return launch_dkv<64>(a, is_bf16, dk, dv);
    case 128: return launch_dkv<128>(a, is_bf16, dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both entry points take q, do [bh, lq, d] and k, v [bh, lkv, d] (16-byte
// aligned, f32 when is_bf16 == 0 else bf16), lse and delta [bh, lq] f32
// (contiguous), and q_seg [bh/heads, lq] and kv_seg [bh/heads, lkv] int32
// (contiguous), both null or both set; d is 32, 64 or 128. f32 tensors are
// contiguous and `strides` is unread; bf16 ones are read and written by
// their byte strides, `strides` holding those of L, H and B for q, k, v, do
// and then the gradients in turn (15 values for dq, 18 for dk and dv, each a
// multiple of 16; the last dim is contiguous). They write dq [bh, lq, d]
// (K3), or dk and dv [bh, lkv, d] (K4), in the input type, launch on
// `stream` without synchronising and return the cudaGetLastError() code of
// the launch, or of a refused shared-memory opt-in or tensor map (0 on
// success). Both tiers run on the tensor cores: bf16 in one pass (wgmma),
// f32 in three TF32 passes (mma.sync).
extern "C" int moc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq,
                                const int* q_seg, const int* kv_seg, const long long* strides,
                                int bh, int heads, int lq, int lkv, int d, int is_bf16,
                                int causal, float sm_scale, cudaStream_t stream) {
  if (bh <= 0 || lq <= 0) return 0;
  const Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, strides, bh, heads, lq, lkv, causal,
               sm_scale, stream};
  return dispatch_dq(a, d, is_bf16, dq);
}

extern "C" int moc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 const int* q_seg, const int* kv_seg, const long long* strides,
                                 int bh, int heads, int lq, int lkv, int d, int is_bf16,
                                 int causal, float sm_scale, cudaStream_t stream) {
  if (bh <= 0 || lkv <= 0) return 0;
  const Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, strides, bh, heads, lq, lkv, causal,
               sm_scale, stream};
  return dispatch_dkv(a, d, is_bf16, dk, dv);
}
