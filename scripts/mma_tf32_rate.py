"""The rate of ``mma.sync.m16n8k8`` in TF32 on one GPU, the ceiling of the
f32 flash backward (K3, K4) in three TF32 passes.

    python scripts/mma_tf32_rate.py

Builds a small CUDA program with nvcc into ``moc_tpu_torch/build/`` and runs
it. Each warp keeps 8 independent accumulators and issues m16n8k8 TF32 mma
back to back, either as plain chains into the accumulators or as
``flash_mma.cuh`` takes a k-step: three passes into a fresh accumulator,
then an f32 add into the running sum. Grids of 4, 8 and 16 warps a CTA fill
every SM twice; CUDA events time the second of two launches. Prints one line
a configuration, in TFLOP/s of TF32 work (2048 operations an mma).
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from moc_tpu_torch.ops import cuda_build  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kThreePasses>
__global__ void chains(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kThreePasses) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma(t, a, i, j);
        mma(t, a, j, i);
        mma(t, a, i, i);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
      } else {
        mma(acc[j], a, i, j);
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sms * 2 * 16 * 32 * sizeof(float) * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4095;
  for (int warps : {4, 8, 16}) {
    for (int three : {0, 1}) {
      const int blocks = sms * 2 * (16 / warps);
      const int loop = three ? iters / 3 : iters;
      auto launch = [&] {
        if (three) chains<1><<<blocks, 32 * warps>>>(out, loop);
        else chains<0><<<blocks, 32 * warps>>>(out, loop);
      };
      launch();
      cudaEventRecord(e0);
      launch();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = double(blocks) * warps * 8 * loop * (three ? 3 : 1);
      printf("%d warps a CTA, %s: %.1f TFLOP/s of TF32 mma (%.3f ms)\n", warps,
             three ? "three passes into a fresh accumulator + f32 add" : "plain chains",
             mmas * 2048 / ms / 1e9, ms);
    }
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "mma_tf32_rate.cu")
    exe = os.path.join(cuda_build.BUILD_DIR, "mma_tf32_rate")
    with open(src, "w") as fh:
        fh.write(SOURCE)
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", exe, src], check=True)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
