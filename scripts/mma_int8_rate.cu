// What rate the int8 tensor-core instructions reach on the card when nothing
// else is in their way: the ceiling to hold csrc/qconv.cu's measured rate
// against (PERF.md section 6).
//
//  * mma.sync.m16n8k32 (s8 x s8 -> s32), the instruction of the kernel's
//    first tensor-core version: every warp runs it back to back on 16 independent
//    accumulators, from registers, with no memory traffic;
//  * wgmma.mma_async.m64n256k32.s32.s8.s8, the instruction csrc/qconv.cu is
//    built on now: each warpgroup issues it back to back on one 64 x 256
//    accumulator, both operands read from shared memory in the 128-byte
//    swizzled layout the kernel uses (4 per 128-byte K step, then commit;
//    one group left in flight), one block per SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_int8_rate scripts/mma_int8_rate.cu
//   ./mma_int8_rate
//
// Prints, per (warps or warpgroups a block, blocks), the time, the rate in
// TOPS (2 ops per multiply-add) and, for mma.sync, the clocks per
// instruction and SM at 1.755 GHz.

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

// ---- wgmma --------------------------------------------------------------------

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {  // K-major, 128-byte swizzle, 8-row groups 1 KB apart
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma256(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
    "}, %128, %129, p;\n}\n"
    :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
    : "l"(a), "l"(b), "r"(1));
}
template <int kWarpgroups>
__global__ void __launch_bounds__(kWarpgroups * 128, 1) wgmma_rate_kernel(int* out, int iters) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  uint8_t* tile = smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  for (int i = threadIdx.x; i < (kWarpgroups * 64 + 256) * 128; i += blockDim.x) tile[i] = static_cast<uint8_t>(i * 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const int wg = threadIdx.x / 128;
  const uint64_t a = smem_desc(base + wg * 64 * 128), b = smem_desc(base + kWarpgroups * 64 * 128);
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma256(acc, a + 2 * ks, b + 2 * ks);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  int s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kWarpgroups>
void wgmma_rate(int* out, int sms, cudaEvent_t e0, cudaEvent_t e1) {
  const int smem = (kWarpgroups * 64 + 256) * 128 + 1024;
  cudaFuncSetAttribute(wgmma_rate_kernel<kWarpgroups>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int iters = 20000;
  wgmma_rate_kernel<kWarpgroups><<<sms, kWarpgroups * 128, smem>>>(out, 10);
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  wgmma_rate_kernel<kWarpgroups><<<sms, kWarpgroups * 128, smem>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  const double macs = static_cast<double>(sms) * kWarpgroups * iters * 4 * 64 * 256 * 32;
  printf("wgmma m64n256k32 s8: warpgroups/block %d blocks %3d: %.3f ms, %.1f TOPS (%s)\n", kWarpgroups, sms, ms,
         2 * macs / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
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
  wgmma_rate<1>(out, sms, e0, e1);
  wgmma_rate<2>(out, sms, e0, e1);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
