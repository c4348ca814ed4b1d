// What rate the int8 tensor-core instruction that csrc/qconv.cu is built on,
// mma.sync.m16n8k32 (s8 x s8 -> s32), reaches on the card when nothing else
// is in its way: every warp runs it back to back on 16 independent
// accumulators, from registers, with no memory traffic. It is the ceiling to
// hold qconv.cu's measured rate against (PERF.md section 6).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_int8_rate scripts/mma_int8_rate.cu
//   ./mma_int8_rate
//
// Prints, per (warps a block, blocks), the time, the rate in TOPS (2 ops per
// multiply-add) and the clocks per instruction and SM at 1.755 GHz.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kAccumulators = 16;

__global__ void rate_kernel(int* out, int iters) {
  int acc[kAccumulators][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2, 3, 4};
  const uint32_t b0 = threadIdx.x * 7, b1 = 5;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kAccumulators; ++j) mma(acc[j], a, b0, b1);
  }
  int s = 0;
  for (int j = 0; j < kAccumulators; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* out;
  cudaMalloc(&out, 2 * sms * 1024 * sizeof(int));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 20000;
  for (int warps : {1, 2, 4, 8, 16}) {
    for (int blocks : {sms, 2 * sms}) {
      rate_kernel<<<blocks, warps * 32>>>(out, 10);
      cudaDeviceSynchronize();
      cudaEventRecord(e0);
      rate_kernel<<<blocks, warps * 32>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = static_cast<double>(blocks) * warps * iters * kAccumulators;
      printf("warps/block %2d blocks %3d: %.3f ms, %.1f TOPS, %.2f clk/MMA/SM at 1.755 GHz\n", warps, blocks,
             ms, mmas * 8192 / ms / 1e9, ms * 1e-3 * 1.755e9 / (mmas / sms));
    }
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
