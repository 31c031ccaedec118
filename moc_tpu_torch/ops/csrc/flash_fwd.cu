// K2: flash-attention forward with log-sum-exp output.
//
// Replaces the Pallas TPU kernel moc_tpu/ops/flash_attention.py:68
// (_fwd_kernel, launched by _fwd). For q [BH, Lq, D] and k, v [BH, Lkv, D]
// (f32 or bf16, read by their strides) it writes o [BH, Lq, D] in the input
// type and lse [BH, Lq] in f32:
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
// TF32 passes, hi.hi + hi.lo + lo.hi of operands split in the kernel as hi =
// tf32(x), lo = tf32(x - hi), both rounded as cvt.rna.tf32.f32 rounds (by
// integer ops), with no process-global TF32 flag read or set: within the JAX
// package's f32 forward tolerance (2e-5) and within 1e-5 of the largest |O|
// of the plain version; one TF32 pass is about 5e-4 off.
//
// Bound: operations, 4 * BH * Lq * Lkv * D. At the extraction shape
// ([64 * 12, 785, 64]) that is 121.2 GFLOP: in f32, three TF32 passes of it
// at the H100's 495 TFLOP/s, 0.7343 ms (its bytes, q, k, v and o at 154 MB
// each, take 0.18 ms at 3.35 TB/s); in bf16 0.1225 ms at 989 TFLOP/s. At the
// pretraining shape ([32 * 12, 512, 64]) f32 takes 0.1562 ms by its
// operations and bf16 0.0303 ms by its bytes.
//
// Both tiers are built for Hopper (flash_sm90.cuh) in one shape: a
// persistent kernel, one CTA of three warpgroups an SM, each CTA taking work
// items (b*h, 128-row query tile) in turn.
// - Warpgroup 0 produces: its first warp issues every copy by TMA (4-D
//   tensor maps over q, k and v, encoded on the host from their byte
//   strides, so the [B, H, L, D] view of a [B, L, H, D] projection is read
//   without a copy; rows past L are zero-filled). It keeps few registers a
//   thread (setmaxnreg) and gives the rest to the consumers.
// - Warpgroups 1 and 2 consume, 64 query rows of each item each. S = Q.K^T
//   is a wgmma with Q and K both read K-major from 128-byte-swizzled shared
//   memory through descriptors; O += P.V is a wgmma with P from registers
//   (the score accumulator, whose layout is mma.sync's, repacked in place)
//   and V from shared memory. The online softmax is kept in base 2 (one FFMA
//   and one ex2 a probability). Tile t + 1's S is issued with tile t's P.V,
//   so the tensor cores run the one while the softmax of the other waits
//   only for S; the two warpgroups take turns to issue (named barriers), so
//   one's softmax runs while the other's products hold the tensor cores. A
//   warpgroup none of whose rows is below Lq (the last tile's second half)
//   computes nothing and only keeps the ring and the turns in step.
// - Causal: an item's key tiles end at its last row's diagonal, and each
//   warpgroup's keys at its own 64-row tile's (kv_end), so which keys a row
//   that matches no key counts is what it was with 64-row tiles (as on the
//   TPU, whose tiles are larger, that depends on the tile); past kv_end
//   inside a running key tile, keys count for nothing.
//
// bf16 (flash_fwd_wgmma_kernel): K and V tiles of 128 keys stream through a
// two-stage ring that runs on across items, each stage with full and empty
// mbarriers, K and V apart so that S can start while V is in flight; the
// producer's lanes copy the key segment ids beside K. Q comes once an item
// into one of two buffers; the producer also stores each item's O, which the
// consumers stage in that item's Q buffer, before the buffer takes another
// Q. S is m64n128k16 (64-byte swizzle at D = 32), P.V m64nDk16 with P
// rounded to bf16 in registers and V read MN-major. What bounds it (an H100
// 80GB HBM3, PERF.md): at D = 64 the exponentials (64 x 128 a warpgroup a
// tile, 16 a clock an SM) take about as long as the products, and neither
// pipe is full: the K/V loads are not the limit (the kernel takes as long
// with them left out), the softmax of one warpgroup and the products of the
// other overlap only in part.
//
// f32 (flash_fwd_tf32_wgmma_kernel): wgmma takes tf32 operands K-major only
// (no transpose for 32-bit types), and each operand is needed split.
// - Tiles: 64 keys (32 at D = 128), for the registers (S 32, P hi and lo 64,
//   O and the tile's fresh P.V accumulator 32 each a thread at D = 64) and
//   for shared memory: a 64 x 64 f32 tile is 16 KB and every operand is
//   held twice, hi and lo. Two stages of K and of V^T (one at D = 128), two
//   landing buffers for V and one Q buffer of 128 rows, hi and lo: 226 KB of
//   the 227 at D = 64. An f32 TMA box is 32 columns (128 bytes): D / 32
//   boxes a tile, all 128-byte swizzled.
// - Splits, once a CTA: the consumers split their Q rows in place (hi over
//   the landed tile, lo beside it) when an item's Q lands. Warps 1-3 of the
//   producer warpgroup split each landed K tile in place the same way, a
//   third each, and copy its key segment ids (into a ring of their own, so
//   that K is released as soon as S is done), then transpose each landed V
//   tile into V^T hi and lo (keys contiguous, 32 to a 128-byte swizzled
//   row), since V's reduction index is the key: a 4 x 4 block of floats a
//   step, in 16-byte reads and writes free of bank conflicts. Each 8 keys
//   lie in the order 0, 2, 4, 6, 1, 3, 5, 7, the k index that P takes
//   straight from the score accumulator (acc_to_a_tf32), so P needs no
//   shuffle. The splitters' stores reach wgmma through an async-proxy fence
//   and an mbarrier (k_ready, vt_ready). P is split in registers. Splitting
//   in the kernel costs about a fifth of its time at D = 64 (the probes
//   without it), the split of K the larger part.
// - Products: S in three passes of D / 8 m64nKk8 steps (lo.hi, hi.lo, then
//   hi.hi: the small terms first, which left a third of the error of taking
//   each k-step's three passes in turn), into one accumulator; P.V likewise,
//   of kKeys / 8 steps, into a fresh accumulator each tile that an FFMA
//   folds into O (O = O * alpha + P.V). The tensor core rounds its sums
//   toward zero: O summed in the accumulator over every key drifted to 1.1e-5
//   of the largest |O| at 785 keys and 6.2e-5 at 8192, against 1.1e-6 with
//   the fresh accumulator (scripts/flash_fwd_tf32_wgmma_variants.py).
// - O is written from the registers to device memory by its strides (two
//   floats a store), lse from the lanes.
// What bounds it (an H100 80GB HBM3, PERF.md): at D = 64 it runs at about
// twice the bound of its operations; the products, the splits and the
// shared memory they all read and write share the SM, and none alone is the
// limit (the probes without S, without P.V or without the splits each took
// 0.78-0.82 of the time).

#include <algorithm>
#include <atomic>

#include "flash_mma.cuh"
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace {

using namespace flash;

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

// Scale and mask the scores of the N-key tile at `kv0` in place, fold them
// into the running max and sums, and leave exp(S - max) in s; returns in
// alpha0/1 the factors that rescale O. The lane holds keys kv0 + 8j + 2t +
// (e & 1).
// The max is kept in base 2 of the scaled scores, x = s * scale * log2e, so
// that a probability is one FFMA and one ex2. A masked key takes MASK itself
// (MASK * log2e would overflow): beside any visible key 2^(MASK - m) is 0,
// as exp(MASK - m) is, and a row whose keys are all masked has m = MASK and
// 2^(MASK - MASK) = 1 for each, as exp gives; its lse is MASK (see the end).
template <int N, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], RowState& st, int kv0, int kv_end,
                                             bool causal, bool segments, const int* segs, int t4,
                                             float scale_log2, float& alpha0, float& alpha1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if (kMask) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
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
    for (int j = 0; j < N / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 *= scale_log2;
    mx1 *= scale_log2;
  }
  // a tile wholly past kv_end (a causal warpgroup's last tile where tiles
  // are narrower than the item) leaves the max as it was: every row meets a
  // key below kv_end in its first tile, so the running max is finite
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
  for (int j = 0; j < N / 8; ++j) {
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

template <int N>
__device__ __forceinline__ void softmax(float (&s)[N / 2], RowState& st, int kv0, int kv_end,
                                        bool causal, bool segments, const int* segs, int t4,
                                        float scale_log2, float& alpha0, float& alpha1) {
  // the masked form also where a negative scale would turn the raw max into the min
  if (kv0 + N > kv_end || causal || segments || scale_log2 < 0.f) {
    softmax_tile<N, true>(s, st, kv0, kv_end, causal, segments, segs, t4, scale_log2, alpha0,
                          alpha1);
  } else {
    softmax_tile<N, false>(s, st, kv0, kv_end, causal, segments, segs, t4, scale_log2, alpha0,
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
// next, then the last P.V), so that the ring of `Stages` stages and the
// turns stay in step.
template <int Stages>
__device__ __forceinline__ void idle_item(int g, int n_tiles, uint32_t k_full, uint32_t k_empty,
                                          uint32_t v_full, uint32_t v_empty, int my_turn,
                                          int their_turn, bool signal) {
  for (int t = 0; t <= n_tiles && n_tiles > 0; ++t) {
    if (t < n_tiles) {
      const int stage = (g + t) % Stages;
      sm90::mbar_wait(k_full + 8 * stage, ((g + t) / Stages) & 1);
      if (signal) sm90::mbar_arrive(k_empty + 8 * stage);
    }
    sm90::named_barrier(my_turn, 256);
    sm90::named_arrive(their_turn, 256);
    if (t > 0) {
      const int stage = (g + t - 1) % Stages;
      sm90::mbar_wait(v_full + 8 * stage, ((g + t - 1) / Stages) & 1);
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
        idle_item<C::kStages>(g, n_tiles, k_full, k_empty, v_full, v_empty, my_turn, their_turn,
                              signal);
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
        softmax<C::kKeys>(s, st, 0, kv_end, causal, segments, seg_smem + stage0 * C::kKeys,
                          t4, scale_log2, alpha0, alpha1);
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
          softmax<C::kKeys>(s, st, (t + 1) * C::kKeys, kv_end, causal, segments,
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

// f32 on Hopper (the design note at the top): the tiles, the shared-memory
// plan and the register split of flash_fwd_tf32_wgmma_kernel. Every tile is
// laid out as TMA lands it: boxes of 32 f32 columns, a row of a box 128
// bytes, 128-byte swizzled; V^T's rows are V's columns, its boxes 32 keys.
template <int D>
struct Sm90Tf32Fwd {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static constexpr int kConsumers = 2;
  static constexpr int kRows = 64;                     // query rows a consumer warpgroup
  static constexpr int kQTile = kRows * kConsumers;    // query rows a CTA
  static constexpr int kKeys = D == 128 ? 32 : 64;     // keys a K/V tile
  static constexpr int kStages = D == 128 ? 1 : 2;     // of the K and V^T ring
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kSplitters = 96;  // warps 1-3: K split in place, V into V^T
  static constexpr int kBoxCols = 32;                  // f32 columns of a TMA box
  static constexpr int kRowBytes = 128;                // a row of a box
  static constexpr int kQBytes = kRows * D * 4;        // a warpgroup's Q, hi or lo
  static constexpr int kKVBytes = kKeys * D * 4;       // a K or V^T tile, hi or lo
  static constexpr int kQLoOff = kConsumers * kQBytes;  // Q hi (landed, split in place) at 0
  static constexpr int kKOff = 2 * kConsumers * kQBytes;    // K hi (landed, split in place)
  static constexpr int kKLoOff = kKOff + kStages * kKVBytes;
  static constexpr int kVtOff = kKLoOff + kStages * kKVBytes;
  static constexpr int kVtLoOff = kVtOff + kStages * kKVBytes;
  static constexpr int kLandings = 2;                  // V as it lands: two buffers
  static constexpr int kVOff = kVtLoOff + kStages * kKVBytes;
  // key segment ids a tile, in a ring of their own, twice the stages deep:
  // K is released as soon as S is done, the ids once the softmax is
  static constexpr int kSegSlots = 2 * kStages;
  static constexpr int kSegOff = kVOff + kLandings * kKVBytes;
  static constexpr int kBarOff = kSegOff + kSegSlots * kKeys * 4;
  // q_full, q_empty; v_full, v_free a landing buffer; k_full, k_ready,
  // k_empty, vt_ready, vt_empty a stage
  static constexpr int kBars = 2 + 2 * kLandings + 5 * kStages;
  static constexpr size_t kSmem = kBarOff + 8 * kBars + 1024;  // + alignment to 1024 bytes
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
  // setmaxnreg as in Sm90Fwd; the splitters need more than the producer alone
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= kLaunchRegs * kThreads,
                "setmaxnreg asks for more registers than the CTA holds");
};

// P.V into a fresh accumulator each tile, folded into O by an FFMA: the
// tensor core rounds its sums toward zero, so O kept in it over every key
// would drift (scripts/flash_fwd_tf32_wgmma_variants.py)
constexpr bool kTf32FreshPv = true;

// The landed V tile ([kKeys keys, D], boxes of 32 columns) as V^T hi and lo:
// D rows of kKeys keys, boxes of 32 keys, each 8 keys in the order 0, 2, 4,
// 6, 1, 3, 5, 7 (acc_to_a_tf32's k index), so keys 8a + par + 2m (m = 0..3)
// are the four floats of one 16-byte chunk of a V^T row. A task of a thread
// is such a quad of keys times four columns 4 c4 .. 4 c4 + 3: four 16-byte
// reads of V, a 4 x 4 transpose in registers, four 16-byte writes each of hi
// and lo. Lane 8r + i of a warp takes c4 = i (mod 8), par = (i >> 2) ^ (r &
// 1) and a = ((i >> 1) & 1) ^ (r >> 1) (mod 2), so that each 8-lane phase
// reads and writes 8 distinct bank groups under the 128-byte swizzle; the
// warps and their iterations take the rest of a (a / 2) and c4 (c4 / 8).
template <int D>
__device__ __forceinline__ void transpose_v_tile(const unsigned char* v, unsigned char* hi,
                                                 unsigned char* lo, int i0) {
  using C = Sm90Tf32Fwd<D>;
  constexpr int kBoxes = D / 32, kPairs = C::kKeys / 16;  // of c4 / 8, of a / 2
  constexpr int kWarps = C::kSplitters / 32;
  const int lane = i0 & 31, r = lane >> 3, i = lane & 7;
  const int par = (i >> 2) ^ (r & 1), a_lo = ((i >> 1) & 1) ^ (r >> 1);
#pragma unroll 1
  for (int combo = i0 >> 5; combo < kBoxes * kPairs; combo += kWarps) {
    const int cb = combo % kBoxes, a = 2 * (combo / kBoxes) + a_lo;
    const int c4 = 8 * cb + i;
    float4 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int key = 8 * a + par + 2 * m;
      x[m] = *reinterpret_cast<const float4*>(
          v + cb * C::kKeys * C::kRowBytes + sm90::swizzle<128>(key * C::kRowBytes + i * 16));
    }
    const float t[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x}, {x[0].y, x[1].y, x[2].y, x[3].y},
                           {x[0].z, x[1].z, x[2].z, x[3].z}, {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint4 h, l;
      split4(make_float4(t[e][0], t[e][1], t[e][2], t[e][3]), h, l);
      const uint32_t off =
          (a / 4) * D * C::kRowBytes +
          sm90::swizzle<128>((4 * c4 + e) * C::kRowBytes + (2 * (a % 4) + par) * 16);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = l;
    }
  }
}

// S = Q.K^T of a tile in three passes (lo.hi, hi.lo, hi.hi: the small terms
// first), each D / 8 k-steps of m64nKk8, Q and K K-major; k-step ks reads 32
// bytes further into a box row, past it the next box
template <int D>
__device__ __forceinline__ void issue_scores_tf32(float (&s)[Sm90Tf32Fwd<D>::kKeys / 2],
                                                  uint32_t q_hi, uint32_t q_lo, uint32_t k_hi,
                                                  uint32_t k_lo) {
  using C = Sm90Tf32Fwd<D>;
  const uint64_t qh = kmajor_desc(q_hi), ql = kmajor_desc(q_lo);
  const uint64_t kh = kmajor_desc(k_hi), kl = kmajor_desc(k_lo);
  sm90::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t box = (ks / 4) * C::kRowBytes, in_row = (ks % 4) * 32;
      const uint64_t a = (pass == 0 ? ql : qh) + ((box * C::kRows + in_row) >> 4);
      const uint64_t b = (pass == 1 ? kl : kh) + ((box * C::kKeys + in_row) >> 4);
      sm90::wgmma_ss_tf32<C::kKeys>(s, a, b, pass > 0 || ks > 0);
    }
  }
  sm90::wgmma_commit();
}

// O (+)= P.V of a tile in three passes, each kKeys / 8 k-steps of m64nDk8, P
// from registers (hi and lo) and V^T K-major; `fresh` overwrites o first
template <int D>
__device__ __forceinline__ void issue_pv_tf32(float (&o)[D / 2],
                                              const uint32_t (&p_hi)[Sm90Tf32Fwd<D>::kKeys / 8][4],
                                              const uint32_t (&p_lo)[Sm90Tf32Fwd<D>::kKeys / 8][4],
                                              uint32_t vt_hi, uint32_t vt_lo, bool fresh) {
  using C = Sm90Tf32Fwd<D>;
  const uint64_t vh = kmajor_desc(vt_hi), vl = kmajor_desc(vt_lo);
  sm90::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
    for (int kk = 0; kk < C::kKeys / 8; ++kk) {
      const uint32_t at = (kk / 4) * D * C::kRowBytes + (kk % 4) * 32;
      const uint64_t b = (pass == 1 ? vl : vh) + (at >> 4);
      sm90::wgmma_rs_tf32<D>(o, pass == 0 ? p_lo[kk] : p_hi[kk], b,
                             !(fresh && pass == 0 && kk == 0));
    }
  }
  sm90::wgmma_commit();
}

// o = o * alpha + t, alpha0 for the lane's first row and alpha1 for its second
template <int N>
__device__ __forceinline__ void fold(float (&o)[N], const float (&t)[N], float alpha0,
                                     float alpha1) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    o[i] = fmaf(o[i], alpha0, t[i]);
    o[i + 1] = fmaf(o[i + 1], alpha0, t[i + 1]);
    o[i + 2] = fmaf(o[i + 2], alpha1, t[i + 2]);
    o[i + 3] = fmaf(o[i + 3], alpha1, t[i + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(Sm90Tf32Fwd<D>::kThreads, 1)
flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                            long long o_sl, long long o_sh, long long o_sb,
                            float* __restrict__ lse, const int* __restrict__ q_seg,
                            const int* __restrict__ kv_seg, int heads, int lq, int lkv,
                            int n_qtiles, int n_items, int causal, float sm_scale) {
  using C = Sm90Tf32Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles (and wgmma's descriptors) need 1024-byte aligned addresses
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  int* seg_smem = reinterpret_cast<int*>(smem + C::kSegOff);
  const uint32_t bars = base + C::kBarOff;
  const uint32_t q_full = bars, q_empty = bars + 8;     // the Q buffer
  const uint32_t v_full = bars + 16;                    // [kLandings]: V landed
  const uint32_t v_free = v_full + 8 * C::kLandings;    // V read
  const uint32_t k_full = v_free + 8 * C::kLandings;    // [kStages]: K landed
  const uint32_t k_ready = k_full + 8 * C::kStages;     // K split, segment ids copied
  const uint32_t k_empty = k_ready + 8 * C::kStages;    // K hi and lo read
  const uint32_t vt_ready = k_empty + 8 * C::kStages;   // V^T written
  const uint32_t vt_empty = vt_ready + 8 * C::kStages;  // V^T read
  auto k_at = [&](int s) { return C::kKOff + s * C::kKVBytes; };   // K hi; lo kStages tiles on
  auto vt_at = [&](int s) { return C::kVtOff + s * C::kKVBytes; };  // V^T hi; lo likewise

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
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 4 * C::kConsumers);  // every consumer warp
    for (int i = 0; i < C::kLandings; ++i) {
      sm90::mbar_init(v_full + 8 * i, 1);
      sm90::mbar_init(v_free + 8 * i, C::kSplitters);
    }
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(k_full + 8 * s, 1);
      sm90::mbar_init(k_ready + 8 * s, C::kSplitters);
      sm90::mbar_init(k_empty + 8 * s, 4 * C::kConsumers);
      sm90::mbar_init(vt_ready + 8 * s, C::kSplitters);
      sm90::mbar_init(vt_empty + 8 * s, 4 * C::kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    sm90::reg_dealloc<C::kProducerRegs>();
    if (warp == 0) {
      // ---- producer: every load of every item of this CTA, in order ----
      if (lane == 0) {
        sm90::tma_prefetch(&q_map);
        if (lkv > 0) {  // no key: no K or V map
          sm90::tma_prefetch(&k_map);
          sm90::tma_prefetch(&v_map);
        }
      }
      int g = 0;  // K/V tiles loaded so far, over all items: the ring's position
      for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
        int bh, q0, n_tiles;
        item_of(item, bh, q0, n_tiles);
        const int b = bh / heads, h = bh % heads;
        auto load_kv = [&](int t) {
          const int s = g % C::kStages;
          sm90::mbar_wait(k_empty + 8 * s, ((g / C::kStages) & 1) ^ 1);  // the first round passes
          if (lane == 0) {
            sm90::mbar_arrive_tx(k_full + 8 * s, C::kKVBytes);
#pragma unroll
            for (int box = 0; box < D / C::kBoxCols; ++box) {
              sm90::tma_load(base + k_at(s) + box * C::kKeys * C::kRowBytes, &k_map,
                             k_full + 8 * s, box * C::kBoxCols, t * C::kKeys, h, b);
            }
          }
          const int l = g % C::kLandings;
          sm90::mbar_wait(v_free + 8 * l, ((g / C::kLandings) & 1) ^ 1);
          if (lane == 0) {
            sm90::mbar_arrive_tx(v_full + 8 * l, C::kKVBytes);
#pragma unroll
            for (int box = 0; box < D / C::kBoxCols; ++box) {
              sm90::tma_load(base + C::kVOff + l * C::kKVBytes + box * C::kKeys * C::kRowBytes,
                             &v_map, v_full + 8 * l, box * C::kBoxCols, t * C::kKeys, h, b);
            }
          }
          ++g;
        };
        // the item's first K/V tile, then its Q once the last item's products
        // are done with the Q buffer, then the rest of its tiles
        if (n_tiles > 0) load_kv(0);
        sm90::mbar_wait(q_empty, (j & 1) ^ 1);
        if (lane == 0) {
          sm90::mbar_arrive_tx(q_full, C::kConsumers * C::kQBytes);
          for (int w = 0; w < C::kConsumers; ++w) {
#pragma unroll
            for (int box = 0; box < D / C::kBoxCols; ++box) {
              sm90::tma_load(base + w * C::kQBytes + box * C::kRows * C::kRowBytes, &q_map,
                             q_full, box * C::kBoxCols, q0 + w * C::kRows, h, b);
            }
          }
        }
        for (int t = 1; t < n_tiles; ++t) load_kv(t);
      }
    } else {
      // ---- splitters: each K tile split in place (its segment ids copied),
      // then each V tile, as it lands, into V^T hi and lo ----
      const int i0 = threadIdx.x - 32;
      int g = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        int bh, q0, n_tiles;
        item_of(item, bh, q0, n_tiles);
        const int b = bh / heads;
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % C::kStages, l = g % C::kLandings;
          sm90::mbar_wait(k_full + 8 * s, (g / C::kStages) & 1);
          split_tile<C::kKVBytes, C::kSplitters>(smem + k_at(s),
                                                 smem + k_at(s) + C::kStages * C::kKVBytes, i0);
          if (segments) {  // keys past Lkv count for nothing (id unread)
            for (int col = i0; col < C::kKeys; col += C::kSplitters) {
              const int key = t * C::kKeys + col;
              seg_smem[(g % C::kSegSlots) * C::kKeys + col] =
                  key < lkv ? kv_seg[static_cast<size_t>(b) * lkv + key] : 0;
            }
          }
          sm90::fence_async_smem();
          sm90::mbar_arrive(k_ready + 8 * s);
          sm90::mbar_wait(v_full + 8 * l, (g / C::kLandings) & 1);
          sm90::mbar_wait(vt_empty + 8 * s, ((g / C::kStages) & 1) ^ 1);  // the first round passes
          transpose_v_tile<D>(smem + C::kVOff + l * C::kKVBytes, smem + vt_at(s),
                              smem + vt_at(s) + C::kStages * C::kKVBytes, i0);
          sm90::fence_async_smem();
          sm90::mbar_arrive(vt_ready + 8 * s);
          sm90::mbar_arrive(v_free + 8 * l);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of every item each ----
    sm90::reg_alloc<C::kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int wt = threadIdx.x & 127;  // thread in the warpgroup
    const int t4 = lane & 3;
    const bool signal = lane == 0;  // one arrival a warp on the empty barriers
    const float scale_log2 = sm_scale * kLog2e;
    const uint32_t q_hi = base + wg * C::kQBytes, q_lo = base + C::kQLoOff + wg * C::kQBytes;
    // turns at the tensor cores as in flash_fwd_wgmma_kernel
    const int my_turn = kTurnBarrier + wg;
    const int their_turn = kTurnBarrier + (wg + 1) % C::kConsumers;
    if (wg == C::kConsumers - 1) sm90::named_arrive(kTurnBarrier, 256);

    float o[D / 2], ot[D / 2];  // O, and a tile's P.V when it is taken fresh
    float s[C::kKeys / 2];
    uint32_t p_hi[C::kKeys / 8][4], p_lo[C::kKeys / 8][4];
    float alpha0, alpha1, prev0 = 0.f, prev1 = 0.f;  // prev: the alphas of the P.V in flight
    auto pv = [&](int stage) {
      issue_pv_tf32<D>(kTf32FreshPv ? ot : o, p_hi, p_lo, base + vt_at(stage),
                       base + vt_at(stage) + C::kStages * C::kKVBytes, kTf32FreshPv);
    };
    auto pv_done = [&](int stage) {  // after its wait: O updated, V^T released
      sm90::fence_regs(o);
      if (kTf32FreshPv) sm90::fence_regs(ot);
      sm90::fence_regs(p_hi);
      sm90::fence_regs(p_lo);
      if (signal) sm90::mbar_arrive(vt_empty + 8 * stage);
      if (kTf32FreshPv) fold(o, ot, prev0, prev1);
    };
    int g = 0;  // K/V tiles consumed so far, over all items
    for (int j = 0, item = blockIdx.x; item < n_items; ++j, item += gridDim.x) {
      int bh, q0, n_tiles;
      item_of(item, bh, q0, n_tiles);
      const int b = bh / heads, h = bh % heads;
      const int qw = q0 + wg * C::kRows;  // the warpgroup's first query row
      // a causal row's keys end at its 64-row tile's diagonal: past it, within
      // a running tile, keys count for nothing, as past Lkv
      const int kv_end = causal ? min(lkv, qw + C::kRows) : lkv;
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

      sm90::mbar_wait(q_full, j & 1);
      if (qw >= lq || n_tiles == 0) {
        // no row of this warpgroup is real (the last query tile's second
        // half), or no key: keep the ring and the turns in step, compute nothing
        if (signal) sm90::mbar_arrive(q_empty);
        idle_item<C::kStages>(g, n_tiles, k_ready, k_empty, vt_ready, vt_empty, my_turn,
                              their_turn, signal);
        g += n_tiles;
      } else {
        // this warpgroup's Q split in place, then visible to its products
        split_tile<C::kQBytes, 128>(smem + (q_hi - base), smem + (q_lo - base), wt);
        sm90::fence_async_smem();
        sm90::named_barrier(kEpilogueBarrier + wg, 128);
        const int stage0 = g % C::kStages;
        sm90::mbar_wait(k_ready + 8 * stage0, (g / C::kStages) & 1);
        sm90::named_barrier(my_turn, 256);
        issue_scores_tf32<D>(s, q_hi, q_lo, base + k_at(stage0),
                             base + k_at(stage0) + C::kStages * C::kKVBytes);
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        if (signal) {
          sm90::mbar_arrive(k_empty + 8 * stage0);
          if (n_tiles == 1) sm90::mbar_arrive(q_empty);  // the item's last S is done
        }
        softmax<C::kKeys>(s, st, 0, kv_end, causal, segments,
                          seg_smem + (g % C::kSegSlots) * C::kKeys, t4, scale_log2, alpha0,
                          alpha1);
        prev0 = alpha0;
        prev1 = alpha1;
        acc_to_a_tf32<C::kKeys>(p_hi, p_lo, s);
        // the steady state: S of tile t + 1 runs beside P.V of tile t, whose
        // softmax waits only for S
        for (int t = 0; t + 1 < n_tiles; ++t) {
          const int gt = g + t;
          const int stage = gt % C::kStages, stage1 = (gt + 1) % C::kStages;
          sm90::mbar_wait(k_ready + 8 * stage1, ((gt + 1) / C::kStages) & 1);
          sm90::mbar_wait(vt_ready + 8 * stage, (gt / C::kStages) & 1);
          sm90::named_barrier(my_turn, 256);
          issue_scores_tf32<D>(s, q_hi, q_lo, base + k_at(stage1),
                               base + k_at(stage1) + C::kStages * C::kKVBytes);
          pv(stage);
          sm90::named_arrive(their_turn, 256);
          sm90::wgmma_wait<1>();  // S of tile t + 1 is done; P.V of tile t runs on
          sm90::fence_regs(s);
          if (signal) {
            sm90::mbar_arrive(k_empty + 8 * stage1);
            if (t + 2 == n_tiles) sm90::mbar_arrive(q_empty);
          }
          softmax<C::kKeys>(s, st, (t + 1) * C::kKeys, kv_end, causal, segments,
                            seg_smem + ((gt + 1) % C::kSegSlots) * C::kKeys, t4, scale_log2,
                            alpha0, alpha1);
          sm90::wgmma_wait<0>();
          pv_done(stage);
          if (kTf32FreshPv) {
            prev0 = alpha0;
            prev1 = alpha1;
          } else {
            rescale(o, alpha0, alpha1);
          }
          acc_to_a_tf32<C::kKeys>(p_hi, p_lo, s);
        }
        const int last = g + n_tiles - 1, stage = last % C::kStages;
        sm90::mbar_wait(vt_ready + 8 * stage, (last / C::kStages) & 1);
        sm90::named_barrier(my_turn, 256);
        pv(stage);
        sm90::named_arrive(their_turn, 256);
        sm90::wgmma_wait<0>();
        pv_done(stage);
        g += n_tiles;
      }
      if (qw >= lq) continue;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        st.l0 += __shfl_xor_sync(kFull, st.l0, off);
        st.l1 += __shfl_xor_sync(kFull, st.l1, off);
      }
      const float inv0 = st.l0 == 0.f ? 1.f : 1.f / st.l0;
      const float inv1 = st.l1 == 0.f ? 1.f : 1.f / st.l1;
      // O from the registers by its strides, two floats a store
      float* ob = out + b * o_sb + h * o_sh;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t4;
        if (st.row0 < lq) {
          *reinterpret_cast<float2*>(ob + st.row0 * o_sl + col) =
              make_float2(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
        }
        if (st.row1 < lq) {
          *reinterpret_cast<float2*>(ob + st.row1 * o_sl + col) =
              make_float2(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
        }
      }
      if (t4 == 0) {
        float* lse_b = lse + static_cast<size_t>(bh) * lq;
        if (st.row0 < lq) lse_b[st.row0] = row_lse(st.m0, st.l0);
        if (st.row1 < lq) lse_b[st.row1] = row_lse(st.m1, st.l1);
      }
    }
  }
}

// bf16: TMA maps over q, k, v and o by their byte strides (`strides`: L, H
// and B of each of q, k, v, o), then one launch of the wgmma kernel
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 const int* q_seg, const int* kv_seg, const long long* strides, int bh, int heads,
                 int lq, int lkv, int causal, float sm_scale, cudaStream_t stream) {
  using C = Sm90Fwd<D>;
  const int b = bh / heads;
  CUtensorMap maps[4] = {};  // q, k, v, o
  auto map = [&](int i, const void* p, int len, const long long* st, int rows) {
    return sm90_host::make_map(&maps[i], sm90_host::kBf16, p, D, len, heads, b, st,
                               C::kBoxCols, rows, C::kSwizzle);
  };
  int err = map(0, q, lq, strides, C::kRows);
  if (!err && lkv > 0) {  // no key: no K or V tile is loaded
    err = map(1, k, lkv, strides + 3, C::kKeys);
    if (!err) err = map(2, v, lkv, strides + 6, C::kKeys);
  }
  if (!err) err = map(3, o, lq, strides + 9, C::kRows);
  if (err) return err;
  static std::atomic<int> known[sm90_host::kDevices];
  int sms = 0;
  const cudaError_t cerr =
      sm90_host::persistent_sms(flash_fwd_wgmma_kernel<D>, C::kSmem, known, &sms);
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

// f32: TMA maps over q, k and v by their byte strides, o written by its
// element strides (from strides[9..11]), then one launch of the wgmma kernel
template <int D>
int launch_tf32_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                      const int* q_seg, const int* kv_seg, const long long* strides, int bh,
                      int heads, int lq, int lkv, int causal, float sm_scale,
                      cudaStream_t stream) {
  using C = Sm90Tf32Fwd<D>;
  const int b = bh / heads;
  CUtensorMap maps[3] = {};  // q, k, v
  auto map = [&](int i, const void* p, int len, const long long* st, int rows) {
    return sm90_host::make_map(&maps[i], sm90_host::kF32, p, D, len, heads, b, st, C::kBoxCols,
                               rows, 128);
  };
  int err = map(0, q, lq, strides, C::kRows);
  if (!err && lkv > 0) {  // no key: no K or V tile is loaded
    err = map(1, k, lkv, strides + 3, C::kKeys);
    if (!err) err = map(2, v, lkv, strides + 6, C::kKeys);
  }
  if (err) return err;
  static std::atomic<int> known[sm90_host::kDevices];
  int sms = 0;
  const cudaError_t cerr =
      sm90_host::persistent_sms(flash_fwd_tf32_wgmma_kernel<D>, C::kSmem, known, &sms);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_qtiles = (lq + C::kQTile - 1) / C::kQTile;
  const int n_items = bh * n_qtiles;
  const long long* os = strides + 9;
  flash_fwd_tf32_wgmma_kernel<D><<<std::min(n_items, sms), C::kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), os[0] / 4, os[1] / 4, os[2] / 4, lse,
      q_seg, kv_seg, heads, lq, lkv, n_qtiles, n_items, causal, sm_scale);
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
  return launch_tf32_wgmma<D>(q, k, v, o, lse, q_seg, kv_seg, strides, bh, heads, lq, lkv,
                              causal, sm_scale, stream);
}

}  // namespace

// q [bh, lq, d], k and v [bh, lkv, d], o [bh, lq, d] (16-byte aligned, f32
// when is_bf16 == 0 else bf16); lse [bh, lq] f32 (contiguous); q_seg
// [bh/heads, lq] and kv_seg [bh/heads, lkv] int32 (contiguous), both null or
// both set. q, k, v and o are read and written by their byte strides,
// `strides` holding those of L, H and B for q, k, v and o in turn (12
// values, each a multiple of 16; the last dim is contiguous). d is 32, 64 or
// 128. Both tiers run on Hopper's tensor cores (wgmma): bf16 in one pass, f32
// in three TF32 passes. Launches on `stream` without synchronising and
// returns the cudaGetLastError() code of the launch, or of a refused
// shared-memory opt-in or tensor map (0 on success).
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

// The dynamic shared memory a CTA of K2 takes at head dim d (f32 when
// is_bf16 == 0), or 0 for another d
extern "C" long long moc_flash_fwd_smem_bytes(int d, int is_bf16) {
  switch (d) {
    case 32:
      return static_cast<long long>(is_bf16 ? Sm90Fwd<32>::kSmem : Sm90Tf32Fwd<32>::kSmem);
    case 64:
      return static_cast<long long>(is_bf16 ? Sm90Fwd<64>::kSmem : Sm90Tf32Fwd<64>::kSmem);
    case 128:
      return static_cast<long long>(is_bf16 ? Sm90Fwd<128>::kSmem : Sm90Tf32Fwd<128>::kSmem);
    default:
      return 0;
  }
}
