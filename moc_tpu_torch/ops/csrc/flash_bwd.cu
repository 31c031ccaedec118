// K3 and K4: the flash-attention backward, dq and (dk, dv).
//
// Replace the Pallas TPU kernels moc_tpu/ops/flash_attention.py:188
// (_bwd_dq_kernel) and :238 (_bwd_dkv_kernel), both launched by _bwd (:297).
// For q, do [BH, Lq, D], k, v [BH, Lkv, D] (row-major, f32 or bf16), the
// forward's lse [BH, Lq] (f32) and delta = rowsum(do * o) [BH, Lq] (f32,
// computed by the caller as _bwd does outside its kernels):
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
// 0.65 ms is the floor of this design. In bf16 the tensor-core bound is
// 0.0391 and 0.0521 ms, about level with the bytes.
//
// Design: the TPU's split, which needs no atomics. K3 runs one CTA per (b*h,
// 64-row query tile) and loops over the 64-key tiles of K and V; K4 runs one
// CTA per (b*h, 64-key tile) and loops over the query tiles. Causal tiles
// above the diagonal are skipped as should_run does on the TPU: K3 stops at
// its diagonal key tile, and K4 starts its query loop at the tile that holds
// its first key.
//
// Both tiers: four warps of 16 rows each on the tensor cores by mma.sync,
// with flash_mma.cuh's pieces; p and ds never touch shared memory.
//
// f32 (flash_bwd_dq_tf32_kernel, flash_bwd_dkv_tf32_kernel): the bf16
// kernels' loop on f32 tiles (rows padded to D + 4 floats: 104 KB of shared
// memory at D = 64, two CTAs an SM; 203 KB at D = 128), every product in
// three m16n8k8 TF32 passes of operands split as cvt.rna rounds. The
// untransposed operands (Q, dO, K, V of S and dP) are read by ldmatrix;
// there is no 32-bit ldmatrix.trans, so the operands that the bf16 kernels
// read transposed (K of ds . K, dO and Q of K4's gradients) are read as scalar
// pairs from the same padded tile, on 32 distinct banks. The accumulator
// holds columns 2t and 2t + 1 where a TF32 A fragment wants t and t + 4:
// each 8-wide k-step takes its k index in the order 0, 2, 4, 6, 1, 3, 5, 7
// on both operands, so p and ds pass on as A fragments with no shuffle. The
// tensor core rounds its sums toward zero, so two k-steps at a time go into
// a fresh accumulator that an f32 add takes into the running sum. For the
// register budget: K3 takes a key tile in passes of 64 keys at D = 64 (32
// at D = 32, 16 at D = 128); K4 takes a query tile in passes of 32 queries
// (16 at D = 128), makes p^T and dv before it forms dp^T, and at D = 128
// sweeps the query tiles twice, once for dv and once for dk (recomputing
// s^T), so that a warp holds one [16, 128] accumulator at a time. No
// register spills at D = 32, 64 or 128.
//
// bf16 (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel):
// - K3 is K2's bf16 forward with K4's gradient arithmetic. The Q and dO
//   tiles are loaded once; the K and V tiles (with the key segment ids)
//   stream through a two-stage cp.async ring. S = Q.K^T and dP = dO.V^T land
//   in accumulator fragments whose rows are the warp's queries, with Q and dO
//   read by ldmatrix as the A operands and K and V as B. p and ds are made in
//   place; ds, rounded to bf16 and repacked in registers, is the A operand of
//   dq += ds . K, with K read by ldmatrix.trans. Q and dO are read from
//   shared memory at every k-step rather than held in registers, and at
//   D = 128 a key tile is taken in two passes of 32 keys, so that the f32
//   accumulators fit in registers without spilling.
// - K4 holds the K and V tiles in shared memory for the whole loop, and the
//   Q and dO tiles (with the tile's lse, delta and segment ids) stream
//   through the ring. Its products are taken with keys as the rows, s^T =
//   K.Q^T and dp^T = V.dO^T, so that p^T and ds^T land in accumulator
//   fragments whose rows are the warp's keys: rounded and repacked, they are
//   the A operands of dv += p^T . dO and dk += ds^T . Q, with dO and Q read by
//   ldmatrix.trans. At D = 128 a q tile is taken in four passes of 16
//   queries, for the same register budget.
// Left for wgmma: the same as K2's (flash_fwd.cu); K3 reads K and V, and K4
// reads Q and dO, from device memory once per 64 rows of its own tile. The
// f32 tier also splits its B operands once per warp rather than once per
// tile, and spends an f32 add per accumulator element every two k-steps.

#include <type_traits>

#include "flash_mma.cuh"

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

// --- bf16: one pass on the tensor cores ---

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K and V; two stages of Q and dO; two of lse, delta and the q segment ids
  return 6 * Tile<D>::kBytes + 2 * kBlock * (2 * sizeof(float) + sizeof(int));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int heads,
                         int lq, int lkv, int n_ktiles, int causal, float sm_scale) {
  constexpr int kSteps = D / 16;                 // k-steps of s^T = K.Q^T and dp^T = V.dO^T
  constexpr int kDTiles = D / 8;                 // n-tiles of dk and dv
  constexpr int kQChunk = D == 128 ? 16 : 64;    // queries per pass (register budget)
  constexpr int kQTiles = kQChunk / 8;           // n-tiles of s^T and dp^T in a pass
  constexpr int kTileElems = Tile<D>::kElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTileElems;
  bf16* qs = vs + kTileElems;        // [2][64, D]
  bf16* dos = qs + 2 * kTileElems;   // [2][64, D]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileElems);  // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                            // [2][64]
  int* q_segs = reinterpret_cast<int*>(delta_s + 2 * kBlock);     // [2][64]

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
    load_tile_async<D>(qs + stage * kTileElems, q + q_off * D, q0, lq, tid);
    load_tile_async<D>(dos + stage * kTileElems, dout + q_off * D, q0, lq, tid);
    load_vec_async(lse_s + stage * kBlock, lse + q_off, q0, lq, tid);
    load_vec_async(delta_s + stage * kBlock, delta + q_off, q0, lq, tid - kBlock);
    if (segments) load_vec_async(q_segs + stage * kBlock, q_seg_b, q0, lq, tid);
  };
  load_tile_async<D>(ks, k + kv_off * D, kv0, lkv, tid);
  load_tile_async<D>(vs, v + kv_off * D, kv0, lkv, tid);
  if (n_tiles > 0) load_q(0);
  cp_async_commit();

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kBlock;
    const int stage = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_q(t + 1);  // into the stage tile t - 1 used
    cp_async_commit();
    const bf16* qt = qs + stage * kTileElems;
    const bf16* dot = dos + stage * kTileElems;
    const float* lse_t = lse_s + stage * kBlock;
    const float* delta_t = delta_s + stage * kBlock;
    const int* seg_t = q_segs + stage * kBlock;

#pragma unroll
    for (int qc = 0; qc < kBlock; qc += kQChunk) {
      // s^T and dp^T for the warp's 16 keys and queries qc .. qc + kQChunk
      float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kstep = 0; kstep < kSteps; ++kstep) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, a_addr<D>(ks, wrow, kstep, lane));
        ldsm_x4(vf, a_addr<D>(vs, wrow, kstep, lane));
#pragma unroll
        for (int jj = 0; jj < kQTiles / 2; ++jj) {
          uint32_t qf[4], df[4];
          ldsm_x4(qf, b_addr<D>(qt, qc + 16 * jj, kstep, lane));
          mma_bf16(st[2 * jj], kf, qf[0], qf[1]);
          mma_bf16(st[2 * jj + 1], kf, qf[2], qf[3]);
          ldsm_x4(df, b_addr<D>(dot, qc + 16 * jj, kstep, lane));
          mma_bf16(dpt[2 * jj], vf, df[0], df[1]);
          mma_bf16(dpt[2 * jj + 1], vf, df[2], df[3]);
        }
      }

      // p^T and ds^T in place; the lane holds queries qc + 8j + 2 * t4 + (e & 1)
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
        const int col = qc + 8 * j + 2 * t4;
        const float2 row_lse = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 row_delta = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + col + (e & 1);
          const int key = e < 2 ? key0 : key1;
          float x = st[j][e] * sm_scale;
          if (masked(causal, segments, query, key, segments ? seg_t[col + (e & 1)] : 0,
                     e < 2 ? kseg0 : kseg1)) {
            x = kMaskValue;
          }
          // a difference, not a fused x * log2e - lse * log2e: MASK * log2e overflows
          const float p = (query < lq && key < lkv)
                              ? exp2f((x - ((e & 1) ? row_lse.y : row_lse.x)) * kLog2e)
                              : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? row_delta.y : row_delta.x)) * sm_scale;
        }
      }

      // dv += bf16(p^T) . dO and dk += bf16(ds^T) . Q, queries as the k dimension
#pragma unroll
      for (int kk = 0; kk < kQChunk / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < kDTiles / 2; ++dd) {
          uint32_t df[4], qf[4];
          ldsm_x4_trans(df, bt_addr<D>(dot, qc + 16 * kk, dd, lane));
          mma_bf16(dv_acc[2 * dd], pa, df[0], df[1]);
          mma_bf16(dv_acc[2 * dd + 1], pa, df[2], df[3]);
          ldsm_x4_trans(qf, bt_addr<D>(qt, qc + 16 * kk, dd, lane));
          mma_bf16(dk_acc[2 * dd], da, qf[0], qf[1]);
          mma_bf16(dk_acc[2 * dd + 1], da, qf[2], qf[3]);
        }
      }
    }
  }

  // every copy has landed and no warp reads K or V again: each warp stages
  // its dk and dv rows in its own 16 rows of the K and V tiles
  cp_async_wait<0>();
  __syncthreads();
  stage_rows<D>(ks, dk_acc, 1.f, 1.f, wrow, lane);
  stage_rows<D>(vs, dv_acc, 1.f, 1.f, wrow, lane);
  __syncwarp();
  store_rows_16<D>(dk + kv_off * D, ks, wrow, kv0, lkv, lane);
  store_rows_16<D>(dv + kv_off * D, vs, wrow, kv0, lkv, lane);
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q and dO; two stages of K and V; two of the key segment ids
  return 6 * Tile<D>::kBytes + 2 * kBlock * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg, int heads, int lq, int lkv, int n_qtiles,
                        int causal, float sm_scale) {
  constexpr int kSteps = D / 16;                 // k-steps of S = Q.K^T and dP = dO.V^T
  constexpr int kDTiles = D / 8;                 // n-tiles of dq
  constexpr int kKeyChunk = D == 128 ? 32 : 64;  // keys per pass (register budget)
  constexpr int kKeyTiles = kKeyChunk / 8;       // n-tiles of S and dP in a pass
  constexpr int kTileElems = Tile<D>::kElems;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTileElems;
  bf16* ks = dos + kTileElems;     // [2][64, D]
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
  const size_t q_off = static_cast<size_t>(bh) * lq;
  const bf16* kb = k + static_cast<size_t>(bh) * lkv * D;
  const bf16* vb = v + static_cast<size_t>(bh) * lkv * D;
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
    load_tile_async<D>(ks + stage * kTileElems, kb, t * kBlock, lkv, tid);
    load_tile_async<D>(vs + stage * kTileElems, vb, t * kBlock, lkv, tid);
    if (segments) load_vec_async(kv_segs + stage * kBlock, kv_seg_b, t * kBlock, lkv, tid);
  };
  load_tile_async<D>(qs, q + q_off * D, q0, lq, tid);
  load_tile_async<D>(dos, dout + q_off * D, q0, lq, tid);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBlock;
    const int stage = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1);  // into the stage tile t - 1 used
    cp_async_commit();
    const bf16* kt = ks + stage * kTileElems;
    const bf16* vt = vs + stage * kTileElems;
    const int* segs = kv_segs + stage * kBlock;

#pragma unroll
    for (int kc = 0; kc < kBlock; kc += kKeyChunk) {
      // S and dP for the warp's 16 queries and keys kc .. kc + kKeyChunk
      float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kstep = 0; kstep < kSteps; ++kstep) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, a_addr<D>(qs, wrow, kstep, lane));
        ldsm_x4(df, a_addr<D>(dos, wrow, kstep, lane));
#pragma unroll
        for (int jj = 0; jj < kKeyTiles / 2; ++jj) {
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, b_addr<D>(kt, kc + 16 * jj, kstep, lane));
          mma_bf16(s[2 * jj], qf, kf[0], kf[1]);
          mma_bf16(s[2 * jj + 1], qf, kf[2], kf[3]);
          ldsm_x4(vf, b_addr<D>(vt, kc + 16 * jj, kstep, lane));
          mma_bf16(dp[2 * jj], df, vf[0], vf[1]);
          mma_bf16(dp[2 * jj + 1], df, vf[2], vf[3]);
        }
      }

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

      // dq += bf16(ds) . K, keys as the k dimension
#pragma unroll
      for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
        uint32_t da[4];
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < kDTiles / 2; ++dd) {
          uint32_t kf[4];
          ldsm_x4_trans(kf, bt_addr<D>(kt, kc + 16 * kk, dd, lane));
          mma_bf16(acc[2 * dd], da, kf[0], kf[1]);
          mma_bf16(acc[2 * dd + 1], da, kf[2], kf[3]);
        }
      }
    }
  }

  // the Q tile has landed (also when no key tile ran) and no warp reads it
  // again: each warp stages its dq rows in its own 16 rows of it
  cp_async_wait<0>();
  __syncthreads();
  stage_rows<D>(qs, acc, 1.f, 1.f, wrow, lane);
  __syncwarp();
  store_rows_16<D>(dq + q_off * D, qs, wrow, q0, lq, lane);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *q_seg, *kv_seg;
  int bh, heads, lq, lkv, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a, int is_bf16, void* dq) {
  const int n_qtiles = (a.lq + kBlock - 1) / kBlock;
  if (is_bf16) {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_mma_kernel<D><<<a.bh * n_qtiles, kMmaThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(dq), a.q_seg, a.kv_seg, a.heads, a.lq, a.lkv, n_qtiles, a.causal,
        a.sm_scale);
  } else {
    constexpr size_t smem = dq_tf32_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_bwd_dq_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_tf32_kernel<D><<<a.bh * n_qtiles, kMmaThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dq), a.q_seg, a.kv_seg, a.heads, a.lq, a.lkv, n_qtiles, a.causal,
        a.sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a, int is_bf16, void* dk, void* dv) {
  const int n_ktiles = (a.lkv + kBlock - 1) / kBlock;
  if (is_bf16) {
    constexpr size_t smem = dkv_mma_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_mma_kernel<D><<<a.bh * n_ktiles, kMmaThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.q_seg, a.kv_seg, a.heads, a.lq, a.lkv,
        n_ktiles, a.causal, a.sm_scale);
  } else {
    constexpr size_t smem = dkv_tf32_smem_bytes<D>();
    cudaError_t err = allow_smem(flash_bwd_dkv_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_tf32_kernel<D><<<a.bh * n_ktiles, kMmaThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(dk), static_cast<float*>(dv), a.q_seg, a.kv_seg, a.heads, a.lq,
        a.lkv, n_ktiles, a.causal, a.sm_scale);
  }
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

// Both entry points take q, do [bh, lq, d] and k, v [bh, lkv, d] (contiguous,
// 16-byte aligned, f32 when is_bf16 == 0 else bf16), lse and delta [bh, lq]
// f32, and q_seg [bh/heads, lq] and kv_seg [bh/heads, lkv] int32, both null
// or both set; d is 32, 64 or 128. They write dq [bh, lq, d] (K3), or dk and
// dv [bh, lkv, d] (K4), in the input type, launch on `stream` without
// synchronising and return the cudaGetLastError() code of the launch, or of
// a refused shared-memory opt-in (0 on success). Both tiers run on the
// tensor cores: bf16 in one pass, f32 in three TF32 passes.
extern "C" int moc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq,
                                const int* q_seg, const int* kv_seg, int bh, int heads, int lq,
                                int lkv, int d, int is_bf16, int causal, float sm_scale,
                                cudaStream_t stream) {
  if (bh <= 0 || lq <= 0) return 0;
  const Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, bh, heads, lq, lkv, causal, sm_scale,
               stream};
  return dispatch_dq(a, d, is_bf16, dq);
}

extern "C" int moc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 const int* q_seg, const int* kv_seg, int bh, int heads, int lq,
                                 int lkv, int d, int is_bf16, int causal, float sm_scale,
                                 cudaStream_t stream) {
  if (bh <= 0 || lkv <= 0) return 0;
  const Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, bh, heads, lq, lkv, causal, sm_scale,
               stream};
  return dispatch_dkv(a, d, is_bf16, dk, dv);
}
