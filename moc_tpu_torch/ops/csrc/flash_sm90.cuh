// Hopper (sm_90a) building blocks of K2 (flash_fwd.cu), K3 and K4
// (flash_bwd.cu), in bf16 and in f32 (three tf32 passes, whose splits and
// transposes are in flash_tf32.cuh):
//
// - TMA: tensor maps over a bf16 or f32 [B, H, L, D] tensor read by its
//   strides (make_map, encoded on the host through the driver's
//   cuTensorMapEncodeTiled, taken through the runtime's driver entry
//   points so that nothing links libcuda), 4-D loads into shared memory that complete
//   on an mbarrier (tma_load) and 4-D stores from shared memory (tma_store);
//   a box is at most 128 bytes wide (64 bf16 or 32 f32 columns), laid out in
//   shared memory with the 128-byte swizzle (64-byte for bf16 at D = 32),
//   and rows past the tensor's end are zero-filled on a load and dropped on
//   a store;
// - mbarriers: init, arrive, arrive with an expected byte count, an arrival
//   once a thread's cp.async copies have landed, and a parity wait;
// - wgmma: the descriptor of a swizzled shared-memory operand (smem_desc),
//   fence / commit / wait, and products with f32 accumulators: m64nNk16 in
//   bf16, A from shared memory (wgmma_ss, N = 32, 64 or 128) or from
//   registers (wgmma_rs, N = 32, 64 or 128, B transposed: MN-major), and
//   m64nNk8 in tf32, both operands K-major (wgmma_ss_tf32, N = 16, 32 or 64;
//   wgmma_rs_tf32, N = 32, 64 or 128), plus fence_regs, which pins
//   registers in program order around the asynchronous products;
// - setmaxnreg (reg_alloc / reg_dealloc) and named barriers (wait, arrive).
//
// The accumulator of an m64nN product gives lane 4g + t of warp w of the
// warpgroup rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1 of
// each 8-column block j (elements 4j..4j+1 and 4j+2..4j+3): the layout of
// mma.sync's m16n8 fragments. A register A operand holds, per warp, an
// m16n8k16 (bf16) or m16n8k8 (tf32) A fragment, so P passes from the score
// accumulator to P.V as acc_to_a (bf16) or acc_to_a_tf32 packs it for
// mma.sync.

#pragma once

#include <atomic>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder is taken at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset `off` in a tile swizzled as TMA lays it out (Swizzle<3,4,3> at
// 128 bytes, Swizzle<2,4,3> at 64): the 16-byte chunk XOR the 128-byte line
template <int Swizzle>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = Swizzle == 128 ? 7 : 3;
  return off ^ (((off >> 7) & mask) << 4);
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// arrive on `bar` once every cp.async this thread issued before it has landed
// (noinc: the barrier's expected count includes this arrival)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA ----

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box at (column c0, row c1, head c2, batch c3) into shared memory at
// `dst`, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- warp specialisation ----

template <int Regs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

// wait at named barrier `id` until `threads` threads have arrived or waited
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at named barrier `id` without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----

// the descriptor of a shared-memory operand in a swizzled layout: `lbo`
// and `sbo` in bytes (K-major: sbo steps 8 rows, lbo is unused; MN-major:
// lbo steps 64 (128-byte swizzle) or 32 (64-byte) columns, sbo 8 rows)
template <int Swizzle>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = Swizzle == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous product owns across its issue and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// The N / 2 f32 accumulator registers a thread of an m64nN product: their
// places in the instruction (SM90_ACC_<N>) and their operands
// (SM90_OUT_<N>), which the asm statements below number first.
#define SM90_ACC_16 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define SM90_ACC_32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_ACC_64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_ACC_128                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_OUT_16(d)                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define SM90_OUT_32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15])
#define SM90_OUT_64(d)                                                                        \
  SM90_OUT_32(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),            \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_OUT_128(d)                                                                       \
  SM90_OUT_64(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),           \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),           \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),           \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),           \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// NAME<N>: d (+)= A . B^T for A [64, K] and B [N, K], both K-major in shared
// memory (K = 16 bf16 or 8 tf32); accumulate == 0 overwrites d. A, B and P
// are the operand numbers of the two descriptors and of `accumulate`; TAIL
// the immediates after scale-a and scale-b (bf16: trans-a, trans-b).
#define SM90_WGMMA_SS(NAME, N, SHAPE, TAIL, A, B, P)                                        \
  template <>                                                                               \
  __device__ __forceinline__ void NAME<N>(float(&d)[N / 2], uint64_t a, uint64_t b,         \
                                          int accumulate) {                                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                           \
                 "wgmma.mma_async.sync.aligned." SHAPE " " SM90_ACC_##N ", %" #A ", %" #B   \
                 ", p, 1, 1" TAIL ";\n}\n"                                                  \
                 : SM90_OUT_##N(d)                                                          \
                 : "l"(a), "l"(b), "r"(accumulate));                                        \
  }

// NAME<N>: d (+)= A . B for A [64, K] in registers (four 32-bit registers a
// thread: bf16 pairs or tf32) and B read from shared memory through its
// descriptor (bf16: MN-major; tf32: K-major, B [N, K] as wgmma takes tf32)
#define SM90_WGMMA_RS(NAME, N, SHAPE, TAIL, A0, A1, A2, A3, B, P)                               \
  template <>                                                                                   \
  __device__ __forceinline__ void NAME<N>(float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b,  \
                                          int accumulate) {                                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                               \
                 "wgmma.mma_async.sync.aligned." SHAPE " " SM90_ACC_##N ", {%" #A0 ", %" #A1    \
                 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1" TAIL ";\n}\n"                        \
                 : SM90_OUT_##N(d)                                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));        \
  }

// bf16: m64nNk16, A and B K-major from shared memory (wgmma_ss, N = 32, 64 or
// 128), or A from registers and B MN-major (wgmma_rs, N = 32, 64 or 128)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate);
SM90_WGMMA_SS(wgmma_ss, 32, "m64n32k16.f32.bf16.bf16", ", 0, 0", 16, 17, 18)
SM90_WGMMA_SS(wgmma_ss, 64, "m64n64k16.f32.bf16.bf16", ", 0, 0", 32, 33, 34)
SM90_WGMMA_SS(wgmma_ss, 128, "m64n128k16.f32.bf16.bf16", ", 0, 0", 64, 65, 66)
SM90_WGMMA_RS(wgmma_rs, 32, "m64n32k16.f32.bf16.bf16", ", 1", 16, 17, 18, 19, 20, 21)
SM90_WGMMA_RS(wgmma_rs, 64, "m64n64k16.f32.bf16.bf16", ", 1", 32, 33, 34, 35, 36, 37)
SM90_WGMMA_RS(wgmma_rs, 128, "m64n128k16.f32.bf16.bf16", ", 1", 64, 65, 66, 67, 68, 69)

// tf32: m64nNk8 with f32 accumulators. PTX has no transpose for 32-bit
// operands: B, and A from shared memory, are K-major (32 tf32 values to a
// 128-byte swizzled row; a k-step 32 bytes further into it). wgmma_ss for N
// = 16, 32 or 64, wgmma_rs (A a thread's m16n8k8 fragment of its warp's 16 rows:
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)) for N = 32, 64 or
// 128. The values are taken as tf32: a caller that wants f32 accuracy
// splits them (x = hi + lo, each rounded to tf32) and sums three products.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate);
SM90_WGMMA_SS(wgmma_ss_tf32, 16, "m64n16k8.f32.tf32.tf32", "", 8, 9, 10)
SM90_WGMMA_SS(wgmma_ss_tf32, 32, "m64n32k8.f32.tf32.tf32", "", 16, 17, 18)
SM90_WGMMA_SS(wgmma_ss_tf32, 64, "m64n64k8.f32.tf32.tf32", "", 32, 33, 34)
SM90_WGMMA_RS(wgmma_rs_tf32, 32, "m64n32k8.f32.tf32.tf32", "", 16, 17, 18, 19, 20, 21)
SM90_WGMMA_RS(wgmma_rs_tf32, 64, "m64n64k8.f32.tf32.tf32", "", 32, 33, 34, 35, 36, 37)
SM90_WGMMA_RS(wgmma_rs_tf32, 128, "m64n128k8.f32.tf32.tf32", "", 64, 65, 66, 67, 68, 69)

#undef SM90_WGMMA_SS
#undef SM90_WGMMA_RS
#undef SM90_ACC_16
#undef SM90_ACC_32
#undef SM90_ACC_64
#undef SM90_ACC_128
#undef SM90_OUT_16
#undef SM90_OUT_32
#undef SM90_OUT_64
#undef SM90_OUT_128

}  // namespace sm90

// ---- host: tensor maps ----

namespace sm90_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the element types of the maps
constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

// a 4-D map over (D, L, H, B) of the tensor at `ptr` of elements of `type`
// (bf16 or f32): `strides` the byte strides of L, H and B (multiples of 16),
// boxes of `box_cols` x `box_rows`; 0 on success, else a CUDA error code
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int d, int l,
                    int h, int b, const long long* strides, int box_cols, int box_rows,
                    int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(l),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[0]),
                               static_cast<cuuint64_t>(strides[1]),
                               static_cast<cuuint64_t>(strides[2])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, bytes, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The SM count of the current device, with `kernel` opted in to `smem` bytes
// of dynamic shared memory there: both asked of the runtime once a device
// (`known`, one per kernel: 0 until asked, then the SM count) and kept. A
// persistent kernel launches one CTA an SM.
constexpr int kDevices = 64;

template <typename Kernel>
cudaError_t persistent_sms(Kernel kernel, size_t smem, std::atomic<int> (&known)[kDevices],
                           int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  int n = known[device].load(std::memory_order_acquire);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return err;
    known[device].store(n, std::memory_order_release);
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace sm90_host
