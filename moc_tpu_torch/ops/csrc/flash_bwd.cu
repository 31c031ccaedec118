// K3 and K4: the flash-attention backward, dq and (dk, dv).
//
// Replace the Pallas TPU kernels moc_tpu/ops/flash_attention.py:188
// (_bwd_dq_kernel) and :238 (_bwd_dkv_kernel), both launched by _bwd (:297).
// For q, do [BH, Lq, D], k, v [BH, Lkv, D] (f32 or bf16, read by their
// strides), the forward's lse [BH, Lq] (f32) and delta = rowsum(do * o)
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
// and ds). In f32 every product is taken in three TF32 passes (flash_mma.cuh,
// flash_tf32.cuh) within a few units in 2^-22 of f32: within the JAX package's f32
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
// mma.sync reaches 222-236 TFLOP/s of TF32 in a pattern of three passes and
// an f32 add (scripts/mma_tf32_rate.py): 0.49 and 0.65 ms at the least,
// which only wgmma gets below. In bf16 the bound is the operations
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
//
// f32 (flash_bwd_dq_tf32_wgmma_kernel, flash_bwd_dkv_tf32_wgmma_kernel), in
// the pattern of K2's flash_fwd_tf32_wgmma_kernel: persistent, one CTA an SM,
// a producer warpgroup and consumer warpgroups of 64 rows, every product in
// three TF32 passes on wgmma m64nNk8 (lo.hi, hi.lo, then hi.hi). wgmma takes
// 32-bit operands from shared memory K-major only, and every operand is
// needed twice, hi and lo: an f32 [64, 64] tile is 16 KB, and shared memory
// decides the tiles.
// - The producer warpgroup: warp 0 issues every load by TMA (f32 maps by
//   byte stride, 32 columns a box) into rings of full and empty mbarriers
//   that run on across items; warps 1-3 (the splitters) split each landed
//   tile. The tensor core drops the low 13 bits of an f32 operand, so a
//   landed tile serves as its own hi and the split writes lo alone, x less
//   its hi, rounded as cvt.rna rounds (flash_tf32.cuh's split_lo_tile; the
//   probe `trunc` of scripts/flash_bwd_tf32_wgmma_variants.py showed the
//   rule). The products whose reduction index is a tile's row (dS.K over
//   keys, K4's gradients over queries) read the tile's transpose in hi and
//   lo (transpose_tile), each 8 rows in the order 0, 2, 4, 6, 1, 3, 5, 7 so
//   that p or ds passes from the score accumulator to an A fragment with no
//   shuffle. The producer warpgroup keeps 64 registers a thread
//   (setmaxnreg; with 56, ptxas spilled in K3's splitters), the consumers
//   216.
// - The tensor core rounds its sums toward zero, so each tile's gradient
//   product goes into a fresh accumulator that an f32 add takes into the
//   running sum (kTf32FreshGrads: summed in the accumulator over every
//   tile, the gradients drifted to 6.2e-5 of the largest |grad| at 8192
//   keys); the consumers store the gradients from their registers by
//   stride, two floats a store.
// - K3 (dq): an item is 128 query rows, 64 for each of two consumer
//   warpgroups, whose Q and dO land once an item and are split by their own
//   warpgroup. K and V stream in tiles of 64 or 32 keys (D = 32, 64) with
//   the key segment ids; the splitters split both and, once dq of the tile
//   kStages back is done with the slot, transpose K into K^T (a ring of its
//   own, so that the scores of tile t + 1 wait only for the split). S = Q.K^T
//   and dP = dO.V^T read both operands from shared memory; dq += dS.K takes
//   dS from the registers and K^T from shared memory. The steady loop issues
//   the scores of tile t + 1 with dq of tile t, and the two warpgroups take
//   turns at the tensor cores, as in bf16 K3. Shared memory at D = 64: Q and
//   dO in hi and lo 128 KB, two stages of K, V and K^T in hi and lo 96 KB.
// - K4 (dk, dv): an item is 64 keys, and its two consumer warpgroups split
//   the gradients between them, not the keys: warpgroup 1 forms S^T = K.Q^T
//   and p^T, and dv += p^T.dO; warpgroup 2 forms dP^T = V.dO^T, takes p^T
//   from warpgroup 1 through two buffers in shared memory (full and empty
//   mbarriers), and dk += ds^T.Q. So a consumer holds one [64, D] gradient
//   and its fresh accumulator, not two (at D = 128 two would take every
//   register), and the K and V of an item, in hi and lo, are 64 KB at D =
//   64. Q and dO stream in tiles of 32 queries with each tile's lse, delta
//   and segment ids (cp.async, as in bf16 K4); the splitters split both, and
//   each consumer warpgroup transposes its own gradient operand (dO for dv,
//   Q for dk) into two slots of its own: tile t + 1's while the products of
//   tiles t and t + 1 run, when its threads would only wait. (Transposed by
//   the splitters, as first built, K4 took 0.85-0.92 ms at the pretraining
//   shape on an H100, of it 0.2 ms the transposes.) p^T and ds^T are written
//   to registers of their own: written over the scores' accumulator, they
//   had ptxas serialise every product of the kernel (C7511), as in bf16 K4.
//   At D <= 64 the scores' hi passes take K (dv) or V (dk) from registers,
//   the landed values loaded once an item (x itself is hi), and only the lo
//   pass reads its A operand from shared memory: 0.70 ms against 0.77 at
//   the pretraining shape (`k4_ss_scores`); with lo in registers too it
//   spilled at D = 64, and with more consumer registers ptxas 12.8 crashed.
//   Shared memory at D = 64: K and V 64 KB, two stages of Q and dO in hi and
//   lo 64 KB, the transposed slots 64 KB, two p^T buffers 16 KB.
// - D = 128: one consumer warpgroup in K3 (Q and dO alone take 128 KB) and
//   key and query tiles of 16, 64 bytes wide once transposed (64-byte
//   swizzle); the gradient products in two halves of 64 columns (a fresh
//   [64, 128] accumulator beside the sum would not fit the registers); K4
//   with one stage and one transposed slot a warpgroup, each tile's scores
//   before its gradients, and every tile masked (ptxas 12.8 crashed on the
//   unmasked copy beside the masked one there).
// What bounds them (an H100 80GB HBM3 at 700 W, the probes of
// scripts/flash_bwd_tf32_wgmma_variants.py at [32, 12, 512, 64]): the
// products and the latency between them. K3 takes about 0.52 ms, 2.2 times
// its bound; without the scores 0.33, without dq 0.26, without the splits
// 0.46. K4 takes about 0.70 ms, 2.2 times its bound (0.79 before its
// scores took K or V from registers: without the scores 0.59, without the
// gradients 0.56, without the splits 0.68). K3's scores read A and B from
// shared memory (m64n32k8: 3 KB a 16-clock product, more than shared memory
// gives), and a warpgroup's elementwise work, and K4's hand-off of p^T, sit
// between its products.

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "flash_mma.cuh"
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace flash;

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

// --- f32 on Hopper: three TF32 passes on wgmma ---

// The tiles and rings of the f32 kernels (the design note at the top). Every
// tile lies as TMA lands it (flash_tf32.cuh): boxes of 32 f32 columns, a
// row of a box 128 bytes, 128-byte swizzled; a transposed tile as
// transpose_tile writes it.
template <int Consumers, int ProducerRegs>
struct Sm90Tf32Bwd {
  static constexpr int kConsumers = Consumers;
  static constexpr int kRows = kWgRows;  // rows of a consumer warpgroup's own tile
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kSplitters = 96;  // warps 1-3 of the producer warpgroup
  // setmaxnreg as in Sm90Bwd, the producer warpgroup keeping what its
  // splitter warps need; with one consumer warpgroup every thread may hold
  // 255 and none is moved
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = ProducerRegs;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static_assert(kConsumers == 1 ||
                    128 * (kProducerRegs + kConsumers * kConsumerRegs) <= kLaunchRegs * kThreads,
                "setmaxnreg asks for more registers than the CTA holds");
};

// K3's plan: the item's Q and dO, hi and lo (one buffer; the landed tile is
// its own hi), and rings of K and V (hi and lo: the scores) and
// of K^T (hi and lo: dq += dS.K) of kKeys keys, with the key segment ids
// beside K. At D = 128 one consumer warpgroup: Q and dO of 64 rows alone
// take 128 KB.
template <int D>
struct Sm90Tf32Dq : Sm90Tf32Bwd<D == 128 ? 1 : 2, 64> {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  using B = Sm90Tf32Bwd<D == 128 ? 1 : 2, 64>;
  static constexpr int kItem = B::kRows * B::kConsumers;  // query rows a work item
  static constexpr int kKeys = D == 32 ? 64 : D == 64 ? 32 : 16;  // keys a tile
  static constexpr int kStages = D == 32 ? 3 : 2;
  static constexpr int kOwnBytes = B::kRows * D * 4;  // a warpgroup's Q or dO, hi or lo
  static constexpr int kTileBytes = kKeys * D * 4;    // a K, V or K^T tile, hi or lo
  // Q hi, Q lo, dO hi, dO lo, each kConsumers warpgroups' rows
  static constexpr int kQLoOff = B::kConsumers * kOwnBytes;
  static constexpr int kDoOff = 2 * B::kConsumers * kOwnBytes;
  static constexpr int kDoLoOff = 3 * B::kConsumers * kOwnBytes;
  // the rings, kStages tiles of each kind (K hi, K lo, V hi, V lo, K^T hi, K^T lo)
  static constexpr int kRingOff = 4 * B::kConsumers * kOwnBytes;
  static constexpr int kSegOff = kRingOff + 6 * kStages * kTileBytes;
  static constexpr int kBarOff = kSegOff + kStages * kKeys * 4;
  // q_full, q_empty; k_full, v_full, ready, empty, kt_ready, kt_empty a stage
  static constexpr int kBars = 2 + 6 * kStages;
  static constexpr size_t kSmem = kBarOff + 8 * kBars + 1024;  // + alignment to 1024 bytes
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// K4's plan: the item's K and V, hi and lo (one buffer), a ring of Q and dO
// (hi and lo: the scores, with each tile's lse, delta and segment ids),
// each consumer warpgroup's own slots of its transposed operand (dO^T for
// dv, Q^T for dk; hi and lo), and two buffers of p^T, which the dv
// warpgroup hands the dk warpgroup
template <int D>
struct Sm90Tf32Dkv : Sm90Tf32Bwd<2, 64> {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  using B = Sm90Tf32Bwd<2, 64>;
  static constexpr int kQ = D == 128 ? 16 : 32;  // queries a tile
  static constexpr int kStages = D == 32 ? 3 : D == 64 ? 2 : 1;
  // a warpgroup writes tile t + 1's transposed operand while the gradient of
  // tile t reads tile t's: two slots (one at D = 128, written after it)
  static constexpr int kTSlots = D == 128 ? 1 : 2;
  // the hi of the scores' A operand (K or V) in registers, D / 8 a thread,
  // where they fit beside the rest (with its lo too, K4 spilled at D = 64)
  static constexpr bool kRsScores = D <= 64;
  static constexpr int kOwnBytes = B::kRows * D * 4;  // K or V, hi or lo
  static constexpr int kTileBytes = kQ * D * 4;       // a Q, dO, Q^T or dO^T tile, hi or lo
  static constexpr int kPBytes = B::kRows * kQ * 4;   // a tile's p^T
  // K hi, K lo, V hi, V lo; the ring, kStages tiles of each kind (Q hi, Q lo,
  // dO hi, dO lo); the transposed slots, kTSlots of each kind (dO^T hi, dO^T
  // lo, Q^T hi, Q^T lo)
  static constexpr int kRingOff = 4 * kOwnBytes;
  static constexpr int kTOff = kRingOff + 4 * kStages * kTileBytes;
  static constexpr int kPOff = kTOff + 4 * kTSlots * kTileBytes;
  static constexpr int kStatOff = kPOff + 2 * kPBytes;
  static constexpr int kBarOff = kStatOff + kStages * 3 * kQ * 4;
  // kv_full, kv_empty; full, ready, empty a stage; p_full, p_empty a p^T
  // buffer
  static constexpr int kBars = 2 + 3 * kStages + 4;
  static constexpr size_t kSmem = kBarOff + 8 * kBars + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// the kinds of tile in the rings, kStages (K4's transposed ones kTSlots) of
// each in this order
enum { kKHi, kKLo, kVHi, kVLo, kKtHi, kKtLo };  // K3
enum { kQHi, kQLo, kDoHi, kDoLo };              // K4's ring
enum { kDotHi, kDotLo, kQtHi, kQtLo };          // K4's transposed slots

// acc = A . B^T in three tf32 passes (lo.hi, hi.lo, then hi.hi: the small
// terms first), each D / 8 k-steps of m64nNk8, into one accumulator: A [64,
// D] and B [N, D], hi and lo, K-major as TMA lands them (boxes of 32 columns,
// 64 and N rows apart); k-step ks reads 32 bytes further into a box row,
// past it the next box
template <int D, int N>
__device__ __forceinline__ void issue_scores_tf32(float (&acc)[N / 2], uint32_t a_hi,
                                                  uint32_t a_lo, uint32_t b_hi, uint32_t b_lo) {
  const uint64_t ah = kmajor_desc(a_hi), al = kmajor_desc(a_lo);
  const uint64_t bh = kmajor_desc(b_hi), bl = kmajor_desc(b_lo);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t box = (ks / 4) * 128, in_row = (ks % 4) * 32;
      const uint64_t a = (pass == 0 ? al : ah) + ((box * kWgRows + in_row) >> 4);
      const uint64_t b = (pass == 1 ? bl : bh) + ((box * N + in_row) >> 4);
      sm90::wgmma_ss_tf32<N>(acc, a, b, pass > 0 || ks > 0);
    }
  }
}

// A consumer warpgroup's rows of a landed [64, D] tile (boxes of 32 columns,
// 64 rows apart) as the register A operand of a product over D, x itself (the
// tensor core drops its low 13 bits: hi): k-step ks of warp w's lane 4g + t
// holds (row 16w + g, column 8ks + t), (+8, t), (g, t + 4), (+8, t + 4), the
// m16n8k8 fragment
template <int D>
__device__ __forceinline__ void load_a_hi(const unsigned char* tile, uint32_t (&hi)[D / 8][4],
                                          int wt) {
  const int lane = wt & 31, row0 = 16 * (wt >> 5) + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1), col = 8 * ks + t + 4 * (r >> 1);
      hi[ks][r] = *reinterpret_cast<const uint32_t*>(
          tile + (col / 32) * kWgRows * 128 + sm90::swizzle<128>(row * 128 + (col % 32) * 4));
    }
  }
}

// acc = A . B^T in three tf32 passes, as issue_scores_tf32, with A's hi from
// registers (load_a_hi) and its lo from shared memory
template <int D, int N>
__device__ __forceinline__ void issue_scores_rs_tf32(float (&acc)[N / 2],
                                                     const uint32_t (&a_hi)[D / 8][4],
                                                     uint32_t a_lo, uint32_t b_hi,
                                                     uint32_t b_lo) {
  const uint64_t al = kmajor_desc(a_lo);
  const uint64_t bh = kmajor_desc(b_hi), bl = kmajor_desc(b_lo);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {  // lo.hi from shared memory
    const uint32_t box = (ks / 4) * 128, in_row = (ks % 4) * 32;
    sm90::wgmma_ss_tf32<N>(acc, al + ((box * kWgRows + in_row) >> 4),
                           bh + ((box * N + in_row) >> 4), ks > 0);
  }
#pragma unroll
  for (int pass = 1; pass < 3; ++pass) {  // hi.lo, hi.hi with hi from registers
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t box = (ks / 4) * 128, in_row = (ks % 4) * 32;
      const uint64_t b = (pass == 1 ? bl : bh) + ((box * N + in_row) >> 4);
      sm90::wgmma_rs_tf32<N>(acc, a_hi[ks], b, 1);
    }
  }
}

// acc (+)= A . B in three tf32 passes, each N / 8 k-steps of m64nMk8: A
// [64, N] from registers (hi and lo, as acc_to_a_tf32 splits an
// accumulator) and B rows half * M .. half * M + M - 1 of the transposed
// tile [D, N] (hi and lo, transpose_tile); `fresh` overwrites acc first
template <int D, int N, int M = D>
__device__ __forceinline__ void issue_grads_tf32(float (&acc)[M / 2],
                                                 const uint32_t (&hi)[N / 8][4],
                                                 const uint32_t (&lo)[N / 8][4], uint32_t t_hi,
                                                 uint32_t t_lo, int half, bool fresh) {
  constexpr int kSwizzle = N == 16 ? 64 : 128;  // the bytes of a transposed row
  const uint32_t rows = half * M * kSwizzle;
  const uint64_t th = kmajor_desc<kSwizzle>(t_hi + rows), tl = kmajor_desc<kSwizzle>(t_lo + rows);
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      const uint32_t at = N == 16 ? kk * 32 : (kk / 4) * D * 128 + (kk % 4) * 32;
      const uint64_t b = (pass == 1 ? tl : th) + (at >> 4);
      sm90::wgmma_rs_tf32<M>(acc, pass == 0 ? lo[kk] : hi[kk], b,
                             !(fresh && pass == 0 && kk == 0));
    }
  }
}

// The tensor core rounds its sums toward zero: a gradient summed in the
// accumulator over every tile drifts (to 6.2e-5 of the largest |grad| at
// 8192 keys, `chained` in scripts/flash_bwd_tf32_wgmma_variants.py), so each
// tile's products go into a fresh accumulator that an f32 add takes into the
// running sum
constexpr bool kTf32FreshGrads = true;

// where a gradient goes: its pointer and element strides of L, H and B
struct F32Out {
  float* ptr;
  long long sl, sh, sb;
};

// A consumer warpgroup's [64, D] accumulator of rows row0 and row0 + 8 (rows
// g and g + 8 of its warp's 16, as a wgmma accumulator holds them) into
// `out` by its strides, two floats a store; rows at or past `len` dropped
template <int D>
__device__ __forceinline__ void store_rows_f32(F32Out out, int b, int h, int row0, int len,
                                               const float (&acc)[D / 2], int t4) {
  float* base = out.ptr + b * out.sb + h * out.sh;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t4;
    if (row0 < len) {
      *reinterpret_cast<float2*>(base + row0 * out.sl + col) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    }
    if (row0 + 8 < len) {
      *reinterpret_cast<float2*>(base + (row0 + 8) * out.sl + col) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
  }
}

// A K3 consumer warpgroup's part in an item none of whose rows exists: every
// tile waited for and released, and the turns taken, as in the item's
// products (n_tiles + 1 turns), so that the rings and the turns stay in step
template <int kStages>
__device__ __forceinline__ void idle_dq_tf32(int g, int n_tiles, uint32_t ready, uint32_t empty,
                                             uint32_t kt_ready, uint32_t kt_empty, int my_turn,
                                             int their_turn, bool signal) {
  for (int t = 0; t <= n_tiles && n_tiles > 0; ++t) {
    if (t < n_tiles) {
      const int stage = (g + t) % kStages;
      sm90::mbar_wait(ready + 8 * stage, ((g + t) / kStages) & 1);
      if (signal) sm90::mbar_arrive(empty + 8 * stage);
    }
    if (t > 0) {
      const int stage = (g + t - 1) % kStages;
      sm90::mbar_wait(kt_ready + 8 * stage, ((g + t - 1) / kStages) & 1);
      if (signal) sm90::mbar_arrive(kt_empty + 8 * stage);
    }
    sm90::named_barrier(my_turn, 256);
    sm90::named_arrive(their_turn, 256);
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90Tf32Dq<D>::kThreads, 1)
flash_bwd_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map, const F32Out dq_out,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                               int heads, int lq, int lkv, int n_qtiles, int n_items, int causal,
                               float sm_scale) {
  using C = Sm90Tf32Dq<D>;
  constexpr int kKeys = C::kKeys, kStages = C::kStages, kConsumers = C::kConsumers;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles (and wgmma's descriptors) need 1024-byte aligned addresses
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* seg_smem = reinterpret_cast<int*>(smem + C::kSegOff);
  const uint32_t bars = base + C::kBarOff;
  const uint32_t q_full = bars, q_empty = bars + 8;   // the Q/dO buffer
  const uint32_t k_full = bars + 16;                  // [kStages]: K landed
  const uint32_t v_full = k_full + 8 * kStages;       // V landed
  const uint32_t ready = v_full + 8 * kStages;        // K and V split, segment ids copied
  const uint32_t empty = ready + 8 * kStages;         // K, V and ids read, K transposed
  const uint32_t kt_ready = empty + 8 * kStages;      // K^T written
  const uint32_t kt_empty = kt_ready + 8 * kStages;   // K^T read
  auto at = [](int kind, int s) { return C::kRingOff + (kind * kStages + s) * C::kTileBytes; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool segments = q_seg != nullptr;
  // the work item (b*h, kItem-row query tile) and its key tiles: those
  // wholly above the diagonal of the item's last row contribute nothing
  auto item_of = [&](int item, int& bh, int& q0, int& n_tiles) {
    bh = item / n_qtiles;
    q0 = (item % n_qtiles) * C::kItem;
    const int kv_stop = causal ? min(lkv, q0 + C::kItem) : lkv;
    n_tiles = (kv_stop + kKeys - 1) / kKeys;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 4 * kConsumers);  // every consumer warp
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full + 8 * s, 1);
      sm90::mbar_init(v_full + 8 * s, 1);
      sm90::mbar_init(ready + 8 * s, C::kSplitters);
      sm90::mbar_init(empty + 8 * s, 4 * kConsumers + C::kSplitters);
      sm90::mbar_init(kt_ready + 8 * s, C::kSplitters);
      sm90::mbar_init(kt_empty + 8 * s, 4 * kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    if constexpr (kConsumers > 1) sm90::reg_dealloc<C::kProducerRegs>();
    if (warp == 0) {
      // ---- producer: every load of every item of this CTA, in order ----
      if (lane == 0) {
        sm90::tma_prefetch(&q_map);
        sm90::tma_prefetch(&do_map);
        if (lkv > 0) {  // no key: no K or V map
          sm90::tma_prefetch(&k_map);
          sm90::tma_prefetch(&v_map);
        }
      }
      int g = 0;  // K/V tiles loaded so far, over all items: the rings' position
      for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
        int bh, q0, n_tiles;
        item_of(item, bh, q0, n_tiles);
        const int b = bh / heads, h = bh % heads;
        auto load_kv = [&](int t) {
          const int s = g % kStages;
          sm90::mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);  // the first round passes
          if (lane == 0) {
            sm90::mbar_arrive_tx(k_full + 8 * s, C::kTileBytes);
            sm90::mbar_arrive_tx(v_full + 8 * s, C::kTileBytes);
#pragma unroll
            for (int box = 0; box < D / 32; ++box) {
              sm90::tma_load(base + at(kKHi, s) + box * kKeys * 128, &k_map, k_full + 8 * s,
                             box * 32, t * kKeys, h, b);
              sm90::tma_load(base + at(kVHi, s) + box * kKeys * 128, &v_map, v_full + 8 * s,
                             box * 32, t * kKeys, h, b);
            }
          }
          ++g;
        };
        // the item's first K/V tile, then its Q and dO once the last item's
        // scores are done with the buffer, then the rest of its tiles
        if (n_tiles > 0) load_kv(0);
        sm90::mbar_wait(q_empty, (j & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_tx(q_full, 2 * kConsumers * C::kOwnBytes);
          for (int w = 0; w < kConsumers; ++w) {
#pragma unroll
            for (int box = 0; box < D / 32; ++box) {
              const uint32_t off = w * C::kOwnBytes + box * C::kRows * 128;
              sm90::tma_load(base + off, &q_map, q_full, box * 32, q0 + w * C::kRows, h, b);
              sm90::tma_load(base + C::kDoOff + off, &do_map, q_full, box * 32,
                             q0 + w * C::kRows, h, b);
            }
          }
        }
        for (int t = 1; t < n_tiles; ++t) load_kv(t);
      }
    } else {
      // ---- splitters: each K and V tile split as it lands (the key segment
      // ids copied), then K transposed into K^T hi and lo ----
      const int i0 = threadIdx.x - 32;
      int g = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        int bh, q0, n_tiles;
        item_of(item, bh, q0, n_tiles);
        const int b = bh / heads;
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % kStages;
          const uint32_t parity = (g / kStages) & 1;
          sm90::mbar_wait(k_full + 8 * s, parity);
          split_lo_tile<C::kTileBytes, C::kSplitters>(smem + at(kKHi, s), smem + at(kKLo, s), i0);
          if (segments) {  // keys past Lkv count for nothing (id unread)
            for (int col = i0; col < kKeys; col += C::kSplitters) {
              const int key = t * kKeys + col;
              seg_smem[s * kKeys + col] =
                  key < lkv ? kv_seg[static_cast<size_t>(b) * lkv + key] : 0;
            }
          }
          sm90::mbar_wait(v_full + 8 * s, parity);
          split_lo_tile<C::kTileBytes, C::kSplitters>(smem + at(kVHi, s), smem + at(kVLo, s), i0);
          sm90::fence_async_smem();
          sm90::mbar_arrive(ready + 8 * s);
          // once dq of the tile kStages back is done with the K^T slot
          sm90::mbar_wait(kt_empty + 8 * s, parity ^ 1);
          transpose_tile<D, kKeys, C::kSplitters>(smem + at(kKHi, s), smem + at(kKtHi, s),
                                                  smem + at(kKtLo, s), i0);
          sm90::fence_async_smem();
          sm90::mbar_arrive(kt_ready + 8 * s);
          sm90::mbar_arrive(empty + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of every item each ----
    if constexpr (kConsumers > 1) sm90::reg_alloc<C::kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int wt = threadIdx.x & 127;  // thread in the warpgroup
    const int t4 = lane & 3;
    const bool signal = lane == 0;  // one arrival a warp on the consumers' barriers
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t q_hi = base + wg * C::kOwnBytes, q_lo = base + C::kQLoOff + wg * C::kOwnBytes;
    const uint32_t do_hi = base + C::kDoOff + wg * C::kOwnBytes;
    const uint32_t do_lo = base + C::kDoLoOff + wg * C::kOwnBytes;
    // with two consumer warpgroups, turns at the tensor cores as in
    // flash_bwd_dq_wgmma_kernel; warpgroup 0 goes first
    const int my_turn = kTurnBarrier + wg;
    const int their_turn = kTurnBarrier + (wg + 1) % kConsumers;
    auto take_turn = [&] {
      if constexpr (kConsumers > 1) sm90::named_barrier(my_turn, 256);
    };
    auto pass_turn = [&] {
      if constexpr (kConsumers > 1) sm90::named_arrive(their_turn, 256);
    };
    if (kConsumers > 1 && wg == kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);

    // at D = 128 (one consumer warpgroup, no setmaxnreg) a fresh [64, 128]
    // accumulator beside dq would not fit the registers: dq += dS.K is taken
    // in two halves of 64 columns, one after the other
    constexpr int kHalves = D == 128 ? 2 : 1, kGradN = D / kHalves;
    float dq[D / 2], dqt[kGradN / 2];  // dq, and a tile's dS.K (or half of it), taken fresh
    float s[kKeys / 2], dp[kKeys / 2];
    uint32_t ds_hi[kKeys / 8][4], ds_lo[kKeys / 8][4];
    auto scores = [&](int stage) {
      issue_scores_tf32<D, kKeys>(s, q_hi, q_lo, base + at(kKHi, stage), base + at(kKLo, stage));
      issue_scores_tf32<D, kKeys>(dp, do_hi, do_lo, base + at(kVHi, stage),
                                  base + at(kVLo, stage));
    };
    auto grads = [&](int stage, int half) {
      float(&part)[kGradN / 2] = *reinterpret_cast<float(*)[kGradN / 2]>(dq + half * kGradN / 2);
      issue_grads_tf32<D, kKeys, kGradN>(kTf32FreshGrads ? dqt : part, ds_hi, ds_lo,
                                         base + at(kKtHi, stage), base + at(kKtLo, stage), half,
                                         kTf32FreshGrads);
    };
    auto fold = [&](int half) {  // after a half's wait: dq updated
      sm90::fence_regs(dq);
      sm90::fence_regs(dqt);
      if (kTf32FreshGrads) {
#pragma unroll
        for (int i = 0; i < kGradN / 2; ++i) dq[half * kGradN / 2 + i] += dqt[i];
      }
    };
    // after the first half's wait: the other halves, then K^T released
    auto grads_done = [&](int stage) {
      fold(0);
#pragma unroll
      for (int half = 1; half < kHalves; ++half) {
        sm90::wgmma_fence();
        grads(stage, half);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        fold(half);
      }
      sm90::fence_regs(ds_hi);
      sm90::fence_regs(ds_lo);
      if (signal) sm90::mbar_arrive(kt_empty + 8 * stage);
    };
    int g = 0;  // K/V tiles consumed so far, over all items
    for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, q0, n_tiles;
      item_of(item, bh, q0, n_tiles);
      const int b = bh / heads;
      const int qw = q0 + wg * C::kRows;  // the warpgroup's first query row
      // a causal row's keys end at its 64-row tile's diagonal: past it, within
      // a running tile, keys count for nothing, as past Lkv
      const int kv_end = causal ? min(lkv, qw + C::kRows) : lkv;
      if constexpr (kConsumers > 1) {
        if (qw >= lq) {
          // no row of this warpgroup exists (the last query tile's second
          // half): keep the rings and the turns in step, compute nothing
          if (signal) sm90::mbar_arrive(q_empty);
          idle_dq_tf32<kStages>(g, n_tiles, ready, empty, kt_ready, kt_empty, my_turn, their_turn,
                                signal);
          g += n_tiles;
          continue;
        }
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
      zero(dq);
      // this warpgroup's Q and dO split, then visible to its products (split
      // by the splitter warps instead, K3 took 2-3% longer)
      sm90::mbar_wait(q_full, j & 1);
      split_lo_tile<C::kOwnBytes, 128>(smem + (q_hi - base), smem + (q_lo - base), wt);
      split_lo_tile<C::kOwnBytes, 128>(smem + (do_hi - base), smem + (do_lo - base), wt);
      sm90::fence_async_smem();
      sm90::named_barrier(kEpilogueBarrier + wg, 128);
      if (n_tiles == 0) {
        if (signal) sm90::mbar_arrive(q_empty);
      } else {
        const int stage0 = g % kStages;
        sm90::mbar_wait(ready + 8 * stage0, (g / kStages) & 1);
        take_turn();
        sm90::wgmma_fence();
        scores(stage0);
        sm90::wgmma_commit();
        pass_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (signal && n_tiles == 1) sm90::mbar_arrive(q_empty);  // the item's last scores
        dq_grads<kKeys>(s, dp, r, 0, kv_end, qw, causal, segments, seg_smem + stage0 * kKeys, t4,
                        scale_log2, sm_scale);
        if (signal) sm90::mbar_arrive(empty + 8 * stage0);
        acc_to_a_tf32<kKeys>(ds_hi, ds_lo, dp);
        // the steady state: the scores of tile t + 1 run beside dq of tile
        // t, and p and ds of tile t + 1 wait only for their scores
        for (int t = 0; t + 1 < n_tiles; ++t) {
          const int gt = g + t;
          const int stage = gt % kStages, stage1 = (gt + 1) % kStages;
          sm90::mbar_wait(ready + 8 * stage1, ((gt + 1) / kStages) & 1);
          sm90::mbar_wait(kt_ready + 8 * stage, (gt / kStages) & 1);
          take_turn();
          sm90::wgmma_fence();
          scores(stage1);
          sm90::wgmma_commit();
          grads(stage, 0);
          sm90::wgmma_commit();
          pass_turn();
          sm90::wgmma_wait<1>();  // the scores of tile t + 1 are done; dq runs on
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          if (signal && t + 2 == n_tiles) sm90::mbar_arrive(q_empty);
          dq_grads<kKeys>(s, dp, r, (t + 1) * kKeys, kv_end, qw, causal, segments,
                          seg_smem + stage1 * kKeys, t4, scale_log2, sm_scale);
          if (signal) sm90::mbar_arrive(empty + 8 * stage1);
          sm90::wgmma_wait<0>();
          grads_done(stage);
          acc_to_a_tf32<kKeys>(ds_hi, ds_lo, dp);
        }
        const int last = g + n_tiles - 1, stage = last % kStages;
        sm90::mbar_wait(kt_ready + 8 * stage, (last / kStages) & 1);
        take_turn();
        sm90::wgmma_fence();
        grads(stage, 0);
        sm90::wgmma_commit();
        pass_turn();
        sm90::wgmma_wait<0>();
        grads_done(stage);
      }
      g += n_tiles;
      store_rows_f32<D>(dq_out, b, bh % heads, r.row0, lq, dq, t4);
    }
  }
}

// p^T of K4's query tile at q0 from s^T; the lane holds queries q0 + 8j + 2t
// + (e & 1), whose lse and segment ids are in shared memory. kMask: masked
// scores take the mask value (a causal item's tiles start at its first key,
// so no query of a tile that runs is before every key of the item)
template <int N, bool kMask>
__device__ __forceinline__ void dkv_p_tile(float (&pt)[N / 2], const float (&st)[N / 2],
                                           const DkvKeys& r, int q0, bool causal, bool segments,
                                           const float* lse_s, const int* seg_s, int t4,
                                           float scale_log2) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
    // -lse * log2e (+inf where lse is the mask value)
    const float2 nl = make_float2(-l.x * kLog2e, -l.y * kLog2e);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float nlq = (e & 1) ? nl.y : nl.x;
      float p = prob(st[i], scale_log2, nlq);
      if (kMask && masked(causal, segments, q0 + col + (e & 1), e < 2 ? r.key0 : r.key1,
                          segments ? seg_s[col + (e & 1)] : 0, e < 2 ? r.seg0 : r.seg1)) {
        p = masked_prob(nlq);
      }
      pt[i] = p;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90Tf32Dkv<D>::kThreads, 1)
flash_bwd_dkv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap do_map, const F32Out dk_out,
                                const F32Out dv_out, const float* __restrict__ lse,
                                const float* __restrict__ delta, const int* __restrict__ q_seg,
                                const int* __restrict__ kv_seg, int heads, int lq, int lkv,
                                int n_ktiles, int n_items, int causal, float sm_scale) {
  using C = Sm90Tf32Dkv<D>;
  constexpr int kQ = C::kQ, kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // a stage's lse, delta and segment ids, kQ each
  float* stat_smem = reinterpret_cast<float*>(smem + C::kStatOff);
  float4* p_smem = reinterpret_cast<float4*>(smem + C::kPOff);
  const uint32_t bars = base + C::kBarOff;
  const uint32_t kv_full = bars, kv_empty = bars + 8;  // the K/V buffer
  const uint32_t full = bars + 16;               // [kStages]: Q, dO and statistics landed
  const uint32_t ready = full + 8 * kStages;     // Q and dO split
  const uint32_t empty = ready + 8 * kStages;    // Q, dO and statistics read, transposed
  const uint32_t p_full = empty + 8 * kStages;   // [2]: p^T written
  const uint32_t p_empty = p_full + 16;          // p^T read
  auto at = [](int kind, int s) { return C::kRingOff + (kind * kStages + s) * C::kTileBytes; };
  auto t_at = [](int kind, int slot) {
    return C::kTOff + (kind * C::kTSlots + slot) * C::kTileBytes;
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool segments = q_seg != nullptr;
  // the work item (b*h, 64-key tile) and its query tiles: those wholly above
  // the diagonal see none of its keys, so a causal item starts at the tile
  // that holds its first key
  auto item_of = [&](int item, int& bh, int& k0, int& q_start, int& n_q) {
    bh = item / n_ktiles;
    k0 = (item % n_ktiles) * C::kRows;
    q_start = causal ? k0 : 0;
    n_q = q_start < lq ? (lq - q_start + kQ - 1) / kQ : 0;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, 4 * C::kConsumers);
    for (int s = 0; s < kStages; ++s) {
      // the producer warp's lanes (the statistics) and its first lane's byte count
      sm90::mbar_init(full + 8 * s, 33);
      sm90::mbar_init(ready + 8 * s, C::kSplitters);
      sm90::mbar_init(empty + 8 * s, 4 * C::kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(p_full + 8 * i, 128);  // every thread of the dv warpgroup
      sm90::mbar_init(p_empty + 8 * i, 128);  // and of the dk warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    sm90::reg_dealloc<C::kProducerRegs>();
    if (warp == 0) {
      // ---- producer ----
      if (lane == 0) {
        sm90::tma_prefetch(&k_map);
        sm90::tma_prefetch(&v_map);
        if (lq > 0) {  // no query: no Q or dO map
          sm90::tma_prefetch(&q_map);
          sm90::tma_prefetch(&do_map);
        }
      }
      int g = 0;  // query tiles loaded so far, over all items: the rings' position
      for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
        int bh, k0, q_start, n_q;
        item_of(item, bh, k0, q_start, n_q);
        const int b = bh / heads, h = bh % heads;
        // K and V once the last item's scores are done with the buffer
        sm90::mbar_wait(kv_empty, (j & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_tx(kv_full, 2 * C::kOwnBytes);
#pragma unroll
          for (int box = 0; box < D / 32; ++box) {
            const uint32_t off = box * C::kRows * 128;
            sm90::tma_load(base + off, &k_map, kv_full, box * 32, k0, h, b);
            sm90::tma_load(base + 2 * C::kOwnBytes + off, &v_map, kv_full, box * 32, k0, h, b);
          }
        }
        const size_t stat0 = static_cast<size_t>(bh) * lq;
        for (int t = 0; t < n_q; ++t, ++g) {
          const int s = g % kStages;
          const int q0 = q_start + t * kQ;
          sm90::mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);  // the first round passes
          // lse, delta and the segment ids by cp.async, each lane arriving
          // once they have landed; zero past Lq, where TMA zero-fills Q and
          // dO, so that such a query adds nothing
          float* stats = stat_smem + s * 3 * kQ;
          if (lane < kQ) {
            const int query = q0 + lane;
            const bool real = query < lq;
            const size_t row = real ? query : 0;
            cp_async4(stats + lane, lse + stat0 + row, real);
            cp_async4(stats + kQ + lane, delta + stat0 + row, real);
            if (segments) {
              cp_async4(stats + 2 * kQ + lane, q_seg + static_cast<size_t>(b) * lq + row, real);
            }
          }
          sm90::cp_async_mbar_arrive(full + 8 * s);
          if (lane == 0) {
            sm90::mbar_arrive_tx(full + 8 * s, 2 * C::kTileBytes);
#pragma unroll
            for (int box = 0; box < D / 32; ++box) {
              sm90::tma_load(base + at(kQHi, s) + box * kQ * 128, &q_map, full + 8 * s, box * 32,
                             q0, h, b);
              sm90::tma_load(base + at(kDoHi, s) + box * kQ * 128, &do_map, full + 8 * s,
                             box * 32, q0, h, b);
            }
          }
        }
      }
    } else {
      // ---- splitters: each Q and dO tile split as it lands ----
      const int i0 = threadIdx.x - 32;
      int g = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        int bh, k0, q_start, n_q;
        item_of(item, bh, k0, q_start, n_q);
        for (int t = 0; t < n_q; ++t, ++g) {
          const int s = g % kStages;
          sm90::mbar_wait(full + 8 * s, (g / kStages) & 1);
          split_lo_tile<C::kTileBytes, C::kSplitters>(smem + at(kQHi, s), smem + at(kQLo, s), i0);
          split_lo_tile<C::kTileBytes, C::kSplitters>(smem + at(kDoHi, s), smem + at(kDoLo, s),
                                                      i0);
          sm90::fence_async_smem();
          sm90::mbar_arrive(ready + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: the item's 64 keys each, warpgroup 0 for dv, 1 for dk ----
    sm90::reg_alloc<C::kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int wt = threadIdx.x & 127;
    const int t4 = lane & 3;
    const bool signal = lane == 0;
    const float scale_log2 = sm_scale * kLog2e;
    const int my_turn = kTurnBarrier + wg;
    const int their_turn = kTurnBarrier + (wg + 1) % C::kConsumers;
    if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);

    // A warpgroup's whole part, one code path a role (no branch on the role
    // between a product's issue and its wait): dv, S^T = K.Q^T, then dv +=
    // p^T.dO (dO^T's tile); dk, dP^T = V.dO^T, then dk += ds^T.Q (Q^T's tile).
    // Each writes its own transposed operand, tile t + 1's while the
    // products of tiles t and t + 1 run.
    auto consume = [&](auto role) {
      constexpr bool kDv = decltype(role)::value;
      const uint32_t a_hi = base + (kDv ? 0 : 2 * C::kOwnBytes), a_lo = a_hi + C::kOwnBytes;
      constexpr int b_kind = kDv ? kQHi : kDoHi;  // the scores' B: Q or dO
      constexpr int x_kind = kDv ? kDoHi : kQHi;  // the tile transposed: dO or Q
      constexpr int t_kind = kDv ? kDotHi : kQtHi;
      // at D = 128 the gradient product in two halves of 64 columns, as in K3
      constexpr int kHalves = D == 128 ? 2 : 1, kGradN = D / kHalves;
      float acc[D / 2], acct[kGradN / 2];  // dv or dk, and a tile's product (or half), fresh
      // s^T and p^T (dv), or dp^T and ds^T (dk): the scores are only read, as
      // bf16 K4 reads them (written over, they had ptxas serialise the products)
      float sc[kQ / 2], pv[kQ / 2];
      uint32_t f_hi[kQ / 8][4], f_lo[kQ / 8][4];
      // the item's K (dv) or V (dk), the scores' A operand: its hi passes
      // from registers at D <= 64 (loaded once an item), its lo pass, and
      // every pass at D = 128, from shared memory
      constexpr bool kRsScores = C::kRsScores;
      uint32_t k_hi[kRsScores ? D / 8 : 1][4];
      auto scores = [&](int stage) {
        if constexpr (kRsScores) {
          issue_scores_rs_tf32<D, kQ>(sc, k_hi, a_lo, base + at(b_kind, stage),
                                      base + at(b_kind + 1, stage));
        } else {
          issue_scores_tf32<D, kQ>(sc, a_hi, a_lo, base + at(b_kind, stage),
                                   base + at(b_kind + 1, stage));
        }
      };
      auto grads = [&](int slot, int half) {
        float(&part)[kGradN / 2] =
            *reinterpret_cast<float(*)[kGradN / 2]>(acc + half * kGradN / 2);
        issue_grads_tf32<D, kQ, kGradN>(kTf32FreshGrads ? acct : part, f_hi, f_lo,
                                        base + t_at(t_kind, slot),
                                        base + t_at(t_kind + 1, slot), half, kTf32FreshGrads);
      };
      // the landed tile of this warpgroup's operand into its transposed slot,
      // then visible to its products (after the warpgroup's barrier)
      auto transpose = [&](int stage, int slot) {
        transpose_tile<D, kQ, 128>(smem + at(x_kind, stage), smem + t_at(t_kind, slot),
                                   smem + t_at(t_kind + 1, slot), wt);
        sm90::fence_async_smem();
      };
      auto grads_done = [&](int half) {  // after their wait: the sum updated
        sm90::fence_regs(acc);
        sm90::fence_regs(acct);
        sm90::fence_regs(f_hi);
        sm90::fence_regs(f_lo);
        if (kTf32FreshGrads) {
#pragma unroll
          for (int i = 0; i < kGradN / 2; ++i) acc[half * kGradN / 2 + i] += acct[i];
        }
      };
      int g = 0;  // query tiles consumed so far, over all items
      for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
        int bh, k0, q_start, n_q;
        item_of(item, bh, k0, q_start, n_q);
        const int b = bh / heads;
        DkvKeys r;
        r.key0 = k0 + 16 * (wt >> 5) + (lane >> 2);
        r.key1 = r.key0 + 8;
        r.seg0 = r.seg1 = 0;
        if (segments) {  // keys past Lkv: their dk and dv are dropped
          if (r.key0 < lkv) r.seg0 = kv_seg[static_cast<size_t>(b) * lkv + r.key0];
          if (r.key1 < lkv) r.seg1 = kv_seg[static_cast<size_t>(b) * lkv + r.key1];
        }
        // p^T (dv warpgroup: from s^T, handed to the dk warpgroup through a
        // buffer) or ds^T = p^T * (dp^T - delta) * scale (dk warpgroup) of the
        // item's query tile gt at q0, into pv
        auto elementwise = [&](int gt, int stage, int q0) {
          const float* stats = stat_smem + stage * 3 * kQ;
          const int slot = gt & 1;
          const uint32_t parity = (gt >> 1) & 1;
          float4* pbuf = p_smem + slot * (C::kPBytes / 16);
          if constexpr (kDv) {
            const int* seg_s = reinterpret_cast<const int*>(stats + 2 * kQ);
            // masked only where a query is before a key of the item, or with
            // segments; at D = 128 always (ptxas 12.8 crashed on the two
            // copies there)
            if (D == 128 || segments || (causal && q0 < k0 + C::kRows)) {
              dkv_p_tile<kQ, true>(pv, sc, r, q0, causal, segments, stats, seg_s, t4, scale_log2);
            } else {
              dkv_p_tile<kQ, false>(pv, sc, r, q0, causal, segments, stats, seg_s, t4,
                                    scale_log2);
            }
            sm90::mbar_wait(p_empty + 8 * slot, parity ^ 1);  // the first round passes
#pragma unroll
            for (int i = 0; i < kQ / 8; ++i) {
              pbuf[i * 128 + wt] =
                  make_float4(pv[4 * i], pv[4 * i + 1], pv[4 * i + 2], pv[4 * i + 3]);
            }
            sm90::mbar_arrive(p_full + 8 * slot);
          } else {
            float4 p[kQ / 8];
            sm90::mbar_wait(p_full + 8 * slot, parity);
#pragma unroll
            for (int i = 0; i < kQ / 8; ++i) p[i] = pbuf[i * 128 + wt];
            sm90::mbar_arrive(p_empty + 8 * slot);
#pragma unroll
            for (int i = 0; i < kQ / 8; ++i) {
              const float2 dl = *reinterpret_cast<const float2*>(stats + kQ + 8 * i + 2 * t4);
              const float nd0 = -dl.x * sm_scale, nd1 = -dl.y * sm_scale;  // -delta * sm_scale
              pv[4 * i] = p[i].x * fmaf(sc[4 * i], sm_scale, nd0);
              pv[4 * i + 1] = p[i].y * fmaf(sc[4 * i + 1], sm_scale, nd1);
              pv[4 * i + 2] = p[i].z * fmaf(sc[4 * i + 2], sm_scale, nd0);
              pv[4 * i + 3] = p[i].w * fmaf(sc[4 * i + 3], sm_scale, nd1);
            }
          }
        };
        // this warpgroup's K (dv) or V (dk) split, then visible to its
        // products (split by the splitter warps instead, K4 took 3% longer),
        // and its hi in registers
        sm90::mbar_wait(kv_full, j & 1);
        split_lo_tile<C::kOwnBytes, 128>(smem + (a_hi - base), smem + (a_lo - base), wt);
        sm90::fence_async_smem();
        sm90::named_barrier(kEpilogueBarrier + wg, 128);
        if constexpr (kRsScores) load_a_hi<D>(smem + (a_hi - base), k_hi, wt);
        zero(acc);
        if (n_q == 0) {
          if (signal) sm90::mbar_arrive(kv_empty);
        } else {
          // the scores of query tile gt (at q0) and their elementwise work,
          // this warpgroup's operand of the tile transposed beside the
          // products; then the tile's ring slot released (once both
          // warpgroups have read its statistics and transposed it) and p^T
          // or ds^T split as the A operand of the gradient
          auto scores_alone = [&](int gt, int q0, bool last_scores) {
            const int stage = gt % kStages;
            // the statistics landed (full), Q and dO split (ready)
            sm90::mbar_wait(full + 8 * stage, (gt / kStages) & 1);
            sm90::mbar_wait(ready + 8 * stage, (gt / kStages) & 1);
            sm90::named_barrier(my_turn, 256);
            sm90::wgmma_fence();
            scores(stage);
            sm90::wgmma_commit();
            sm90::named_arrive(their_turn, 256);
            transpose(stage, gt % C::kTSlots);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(sc);
            sm90::fence_regs(k_hi);
            if (signal && last_scores) sm90::mbar_arrive(kv_empty);  // the item's last scores
            elementwise(gt, stage, q0);
            sm90::named_barrier(kEpilogueBarrier + wg, 128);  // every thread's tile transposed
            if (signal) sm90::mbar_arrive(empty + 8 * stage);
            acc_to_a_tf32<kQ>(f_hi, f_lo, pv);
          };
          auto grads_alone = [&](int gt) {  // a turn a half
#pragma unroll
            for (int half = 0; half < kHalves; ++half) {
              sm90::named_barrier(my_turn, 256);
              sm90::wgmma_fence();
              grads(gt % C::kTSlots, half);
              sm90::wgmma_commit();
              sm90::named_arrive(their_turn, 256);
              sm90::wgmma_wait<0>();
              grads_done(half);
            }
          };
          static_assert(C::kTSlots == 2 || kHalves == 2, "the pipelined loop takes one half");
          if constexpr (C::kTSlots == 1) {
            // one transposed slot (D = 128): each tile's scores, then its gradient
            for (int t = 0; t < n_q; ++t) {
              scores_alone(g + t, q_start + t * kQ, t + 1 == n_q);
              grads_alone(g + t);
            }
          } else {
            scores_alone(g, q_start, n_q == 1);
            // the steady state: the scores of tile t + 1 run beside the
            // gradient of tile t, and the elementwise work of tile t + 1 waits
            // only for its scores
            for (int t = 0; t + 1 < n_q; ++t) {
              const int gt = g + t;
              const int stage1 = (gt + 1) % kStages;
              sm90::mbar_wait(full + 8 * stage1, ((gt + 1) / kStages) & 1);
              sm90::mbar_wait(ready + 8 * stage1, ((gt + 1) / kStages) & 1);
              sm90::named_barrier(my_turn, 256);
              sm90::wgmma_fence();
              scores(stage1);
              sm90::wgmma_commit();
              grads(gt % C::kTSlots, 0);
              sm90::wgmma_commit();
              sm90::named_arrive(their_turn, 256);
              transpose(stage1, (gt + 1) % C::kTSlots);
              sm90::wgmma_wait<1>();
              sm90::fence_regs(sc);
              sm90::fence_regs(k_hi);
              if (signal && t + 2 == n_q) sm90::mbar_arrive(kv_empty);
              elementwise(gt + 1, stage1, q_start + (t + 1) * kQ);
              sm90::wgmma_wait<0>();
              grads_done(0);
              sm90::named_barrier(kEpilogueBarrier + wg, 128);
              if (signal) sm90::mbar_arrive(empty + 8 * stage1);
              acc_to_a_tf32<kQ>(f_hi, f_lo, pv);
            }
            grads_alone(g + n_q - 1);
          }
        }
        g += n_q;
        // dv or dk from the registers by its strides (also where no query tile
        // ran: zeros); keys past Lkv dropped
        store_rows_f32<D>(kDv ? dv_out : dk_out, b, bh % heads,
                          k0 + 16 * (wt >> 5) + (lane >> 2), lkv, acc, t4);
      }
    };
    if (wg == 0) {
      consume(std::true_type{});
    } else {
      consume(std::false_type{});
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *q_seg, *kv_seg;
  // the byte strides of L, H and B of q, k, v, do and then the gradients
  // (dq; or dk, dv), as the tensor maps take them
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

// f32 K3: tensor maps over q, k, v and do by their byte strides, dq written
// by its element strides, then one launch of the persistent kernel
template <int D>
int launch_dq_tf32(const Args& a, void* dq) {
  using C = Sm90Tf32Dq<D>;
  const int b = a.bh / a.heads;
  const long long* st = a.strides;
  CUtensorMap maps[4] = {};  // q, k, v, do
  auto map = [&](int i, const void* p, int len, const long long* strides, int rows) {
    return sm90_host::make_map(&maps[i], sm90_host::kF32, p, D, len, a.heads, b, strides, 32,
                               rows, 128);
  };
  int err = map(0, a.q, a.lq, st, C::kRows);
  if (!err && a.lkv > 0) {  // no key: no K or V tile is loaded
    err = map(1, a.k, a.lkv, st + 3, C::kKeys);
    if (!err) err = map(2, a.v, a.lkv, st + 6, C::kKeys);
  }
  if (!err) err = map(3, a.dout, a.lq, st + 9, C::kRows);
  if (err) return err;
  static std::atomic<int> known[sm90_host::kDevices];
  int sms = 0;
  const cudaError_t cerr =
      sm90_host::persistent_sms(flash_bwd_dq_tf32_wgmma_kernel<D>, C::kSmem, known, &sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_qtiles = (a.lq + C::kItem - 1) / C::kItem;
  const int n_items = a.bh * n_qtiles;
  const F32Out out{static_cast<float*>(dq), st[12] / 4, st[13] / 4, st[14] / 4};
  flash_bwd_dq_tf32_wgmma_kernel<D><<<std::min(n_items, sms), C::kThreads, C::kSmem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], out, a.lse, a.delta, a.q_seg, a.kv_seg, a.heads, a.lq,
      a.lkv, n_qtiles, n_items, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 K4: tensor maps over k, v, q and do by their byte strides, dk and dv
// written by their element strides, then one launch over the (b*h, 64-key)
// items
template <int D>
int launch_dkv_tf32(const Args& a, void* dk, void* dv) {
  using C = Sm90Tf32Dkv<D>;
  const int b = a.bh / a.heads;
  const long long* st = a.strides;
  CUtensorMap maps[4] = {};  // k, v, q, do
  auto map = [&](int i, const void* p, int len, const long long* strides, int rows) {
    return sm90_host::make_map(&maps[i], sm90_host::kF32, p, D, len, a.heads, b, strides, 32,
                               rows, 128);
  };
  int err = map(0, a.k, a.lkv, st + 3, C::kRows);
  if (!err) err = map(1, a.v, a.lkv, st + 6, C::kRows);
  if (!err && a.lq > 0) {  // no query: no Q or dO tile is loaded
    err = map(2, a.q, a.lq, st, C::kQ);
    if (!err) err = map(3, a.dout, a.lq, st + 9, C::kQ);
  }
  if (err) return err;
  static std::atomic<int> known[sm90_host::kDevices];
  int sms = 0;
  const cudaError_t cerr =
      sm90_host::persistent_sms(flash_bwd_dkv_tf32_wgmma_kernel<D>, C::kSmem, known, &sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_ktiles = (a.lkv + C::kRows - 1) / C::kRows;
  const int n_items = a.bh * n_ktiles;
  const F32Out dk_out{static_cast<float*>(dk), st[12] / 4, st[13] / 4, st[14] / 4};
  const F32Out dv_out{static_cast<float*>(dv), st[15] / 4, st[16] / 4, st[17] / 4};
  flash_bwd_dkv_tf32_wgmma_kernel<D><<<std::min(n_items, sms), C::kThreads, C::kSmem,
                                       a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], dk_out, dv_out, a.lse, a.delta, a.q_seg, a.kv_seg,
      a.heads, a.lq, a.lkv, n_ktiles, n_items, a.causal, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, int is_bf16, void* dq) {
  return is_bf16 ? launch_dq_wgmma<D>(a, dq) : launch_dq_tf32<D>(a, dq);
}

template <int D>
int launch_dkv(const Args& a, int is_bf16, void* dk, void* dv) {
  return is_bf16 ? launch_dkv_wgmma<D>(a, dk, dv) : launch_dkv_tf32<D>(a, dk, dv);
}

template <int D>
long long smem_bytes(int is_bf16, int dkv) {
  if (is_bf16) return static_cast<long long>(dkv ? Sm90Dkv<D>::kSmem : Sm90Dq<D>::kSmem);
  return static_cast<long long>(dkv ? Sm90Tf32Dkv<D>::kSmem : Sm90Tf32Dq<D>::kSmem);
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
// (contiguous), both null or both set; d is 32, 64 or 128. The tensors are
// read and written by their byte strides, `strides` holding those of L, H
// and B for q, k, v, do and then the gradients in turn (15 values for dq, 18
// for dk and dv, each a multiple of 16; the last dim is contiguous). They
// write dq [bh, lq, d] (K3), or dk and dv [bh, lkv, d] (K4), in the input
// type, launch on `stream` without synchronising and return the
// cudaGetLastError() code of the launch, or of a refused shared-memory
// opt-in or tensor map (0 on success). Both tiers run on Hopper's tensor
// cores (wgmma): bf16 in one pass, f32 in three TF32 passes.
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

// The dynamic shared memory a CTA of K3 (dkv == 0) or K4 (dkv == 1) takes at
// head dim d (f32 when is_bf16 == 0), or 0 for another d
extern "C" long long moc_flash_bwd_smem_bytes(int d, int is_bf16, int dkv) {
  switch (d) {
    case 32: return smem_bytes<32>(is_bf16, dkv);
    case 64: return smem_bytes<64>(is_bf16, dkv);
    case 128: return smem_bytes<128>(is_bf16, dkv);
    default: return 0;
  }
}
