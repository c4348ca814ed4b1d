// Where the time of one lone block of csrc/qconv.cu goes: the kernel is
// compiled into this program as it is, or with its copies, its mma, or both
// compiled out, and one small conv (9x15 map, 256 -> 256 filters, four
// blocks) is launched back to back for each of k = 1 (4 steps of K) and k = 3
// (36 steps) and each kind of output (0 int32 accumulators, 1 bfloat16,
// 2 int8). Differences between the variants are the parts' costs; the
// difference between k = 1 and k = 3 over 32 steps is the cost of a step.
//
//   for v in "" -DQCONV_SKIP_MMA -DQCONV_SKIP_COPIES "-DQCONV_SKIP_MMA -DQCONV_SKIP_COPIES"; do
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 $v -o qconv_step_cost scripts/qconv_step_cost.cu
//     echo "variant [$v]"; ./qconv_step_cost
//   done

#include "../playground3d_tpu_torch/csrc/qconv.cu"

#include <stdio.h>

int main() {
  const int N = 1, Cin = 256, Cout = 256, stride = 1, H = 9, W = 15;
  int8_t *x, *w, *out;
  float *scale, *offset, *xs;
  cudaMalloc(&x, static_cast<size_t>(N) * H * W * Cin);
  cudaMalloc(&w, static_cast<size_t>(Cout) * 9 * Cin);
  cudaMalloc(&out, static_cast<size_t>(N) * H * W * Cout * 4);
  cudaMalloc(&scale, Cout * 4);
  cudaMalloc(&offset, Cout * 4);
  cudaMalloc(&xs, 4);
  cudaMemset(x, 1, static_cast<size_t>(N) * H * W * Cin);
  cudaMemset(w, 1, static_cast<size_t>(Cout) * 9 * Cin);
  cudaMemset(scale, 0, Cout * 4);
  cudaMemset(offset, 0, Cout * 4);
  const float one = 1.0f;
  cudaMemcpy(xs, &one, 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int k : {1, 3}) {
    for (int store : {0, 1, 2}) {
      auto run = [&]() {
        return qconv(x, w, scale, offset, xs, out, N, H, W, Cin, Cout, k, stride, H, W, k / 2, k / 2, 1, store,
                     nullptr);
      };
      for (int i = 0; i < 3; ++i) run();
      cudaDeviceSynchronize();
      cudaEventRecord(e0);
      for (int i = 0; i < 50; ++i) run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0;
      cudaEventElapsedTime(&ms, e0, e1);
      printf("k=%d store=%d: %.2f us per launch (50 back to back), last error %d\n", k, store, ms * 1000 / 50,
             static_cast<int>(cudaGetLastError()));
    }
  }
  return 0;
}
