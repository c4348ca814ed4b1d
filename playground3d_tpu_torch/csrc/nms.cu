// Masked fixed-capacity greedy NMS on Hopper (sm_90a), plain C interface.
//
// Replaces the device loop of playground3d_tpu/ops/nms.py::nms (and, through
// it, batched_nms): a lax.while_loop that iterates
//     keep[i] <- not any_j (beats[j, i] and keep[j]) and mask[i]
// from keep = mask to its fixed point (at most n_iter rounds), then compacts
// the kept indices in lax.top_k's order. The port's plain version
// (ops/nms.py::nms_plain) runs the loop on the host and reads one flag a
// round; these kernels keep the whole loop on the card, so the caller never
// waits for it and a CUDA graph can hold it.
//
// What bounds it: neither bytes (a few KB of boxes) nor operations (n^2
// IoUs once, then n^2/32 word ANDs a round) but latency: the loop runs as
// many rounds as the longest suppression chain, each a few barriers of one
// block. Two launches:
//  - beats_kernel, a grid of a thread per (box i, word w): the 32 bits
//    beats[32w + b, i] as one word of a [words][n] table in device memory
//    (n^2/8 bytes: 32 KB at n 512, 2 MB at the default 4,096 candidates; it
//    stays in L2). A grid, because one block spent ~150 us on the IoUs alone
//    at n 512 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md);
//  - loop_kernel, one block: each thread owns up to kMaxPerThread boxes;
//    a round publishes keep as one ballot word per warp and box slot into
//    shared memory, each box ANDs its column of words against them, and
//    __syncthreads_or over "changed" decides the next round. Compaction in
//    the same block: a kept box's rank is the number of kept boxes ahead of
//    it in top_k's order (a higher score, or an equal score at a lower
//    index), and each kept box writes itself to its rank.
//
// Exactness: IoU > thr decides every bit, so the IoU is computed op for op
// as ops/iou.py::pairwise_iou does (each op rounded on its own: __fmul_rn,
// __fadd_rn, __fsub_rn, an IEEE __fdiv_rn; the file is also built with
// -fmad=false). Scores compare as the plain version compares them. Output,
// masks and the round count equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 8192;  // kMaxPerThread boxes for each of 1,024 threads
constexpr int kMaxPerThread = 8;
constexpr int kBeatsThreads = 256;
constexpr float kNegInf = -1e30f;  // NEG_INF of ops/nms.py: masked scores
constexpr float kKeptFloor = -5e29f;  // NEG_INF / 2: top_k scores above it are kept boxes

__host__ __device__ constexpr int words_for(int n) { return (n + 31) / 32; }
__host__ __device__ constexpr int threads_for(int n) { return n <= 32 ? 32 : n >= 1024 ? 1024 : ((n + 31) / 32) * 32; }
__host__ __device__ constexpr int per_thread_for(int n) { return n < 1 ? 1 : (n + threads_for(n) - 1) / threads_for(n); }

// ops/iou.py::pairwise_iou(a, b)[0, 0] for a = box j, b = box i
__device__ __forceinline__ float iou_of(float4 a, float4 b) {
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(iw < 0.0f ? 0.0f : iw, ih < 0.0f ? 0.0f : ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  uni = uni < 1e-8f ? 1e-8f : uni;
  return __fdiv_rn(inter, uni);
}

// beat[w * n + i], bit b = beats[32w + b, i] = (s_j > s_i, or equal and
// j < i) and IoU(j, i) > thr and both masked in
__global__ void __launch_bounds__(kBeatsThreads)
beats_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, const uint8_t* __restrict__ mask,
             int n, float thr, uint32_t* __restrict__ beat) {
  const long long e = static_cast<long long>(blockIdx.x) * kBeatsThreads + threadIdx.x;
  if (e >= static_cast<long long>(words_for(n)) * n) return;
  const int w = static_cast<int>(e / n), i = static_cast<int>(e % n);
  uint32_t word = 0;
  if (mask[i]) {
    const float4 bi = boxes[i];
    const float si = scores[i];
    const int j_end = min(32, n - 32 * w);
    for (int b = 0; b < j_end; ++b) {
      const int j = 32 * w + b;
      if (!mask[j]) continue;
      const float sj = scores[j];
      if (!(sj > si || (sj == si && j < i))) continue;
      if (iou_of(boxes[j], bi) > thr) word |= 1u << b;
    }
  }
  beat[e] = word;
}

__global__ void __launch_bounds__(1024)
loop_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ mask, const uint32_t* __restrict__ beat,
            int n, int n_iter, int max_keep, int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_mask,
            int32_t* __restrict__ rounds) {
  extern __shared__ uint32_t keep_words[];  // [words]: bit b of word w = keep[32w + b]
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, W = words_for(n);
  const int per = per_thread_for(n);  // box k of this thread: i = t + k * T (uniform over the block)
  bool keep[kMaxPerThread], prev[kMaxPerThread], m[kMaxPerThread];
  float s[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = t + k * T;
    m[k] = k < per && i < n && mask[i];
    s[k] = m[k] ? scores[i] : kNegInf;
    keep[k] = m[k];
    prev[k] = !m[k] && k < per && i < n;  // "changed" starts true for every real box
  }

  int it = 0, reads = 0;
  while (it < n_iter) {
    ++reads;
    bool changed = false;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) changed |= keep[k] != prev[k];
    if (!__syncthreads_or(changed)) break;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      if (k >= per) break;
      const uint32_t ballot = __ballot_sync(0xffffffffu, keep[k]);
      const int w = k * (T >> 5) + warp;
      if (lane == 0 && w < W) keep_words[w] = ballot;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int i = t + k * T;
      if (k >= per || i >= n) break;
      bool beaten = false;
      for (int w = 0; w < W && !beaten; ++w) beaten = (__ldg(beat + static_cast<long long>(w) * n + i) & keep_words[w]) != 0;
      prev[k] = keep[k];
      keep[k] = !beaten && m[k];
    }
    ++it;
  }

  // compaction in top_k's order: higher score first, lower index first on
  // ties; positions past the kept boxes are 0 / False
  __syncthreads();  // every thread is done reading keep_words
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    if (k >= per) break;
    const uint32_t ballot = __ballot_sync(0xffffffffu, keep[k]);
    const int w = k * (T >> 5) + warp;
    if (lane == 0 && w < W) keep_words[w] = ballot;
  }
  for (int p = t; p < max_keep; p += T) {
    keep_idx[p] = 0;
    keep_mask[p] = 0;
  }
  __syncthreads();  // the zeros land before any rank is written
  const int K = min(max_keep, n);
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = t + k * T;
    if (k >= per || i >= n) break;
    if (!keep[k] || !(s[k] > kKeptFloor)) continue;
    int rank = 0;
    for (int w = 0; w < W; ++w) {
      for (uint32_t bits = keep_words[w]; bits; bits &= bits - 1) {
        const int j = 32 * w + __ffs(bits) - 1;
        const float sj = __ldg(scores + j);
        rank += (sj > s[k] || (sj == s[k] && j < i)) ? 1 : 0;
      }
    }
    if (rank < K) {
      keep_idx[rank] = i;
      keep_mask[rank] = 1;
    }
  }
  if (t == 0 && rounds != nullptr) atomicAdd(rounds, reads);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the first launch that failed (0 = cudaSuccess).
// The wrapper (ops/nms.py) checks types, shapes and devices and passes the
// plan launch_plan computed (loop threads, beats workspace of words * n
// uint32), which must equal this file's rule. `rounds` (int32 on the card,
// or null) is increased by the loop's rounds, counted as the plain version
// counts its host reads.
int nms(const void* boxes, const void* scores, const void* mask, int n, float thr, int n_iter, int max_keep,
        void* keep_idx, void* keep_mask, void* rounds, void* beat, int threads, void* stream) {
  if (n < 0 || n > kMaxBoxes || max_keep < 0 || n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads != threads_for(n) || per_thread_for(n) > kMaxPerThread) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(words_for(n)) * n;
  if (cells > 0) {
    beats_kernel<<<static_cast<unsigned>((cells + kBeatsThreads - 1) / kBeatsThreads), kBeatsThreads, 0, s>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(scores), static_cast<const uint8_t*>(mask), n,
        thr, static_cast<uint32_t*>(beat));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  loop_kernel<<<1, threads, words_for(n) * 4 + 4, s>>>(
      static_cast<const float*>(scores), static_cast<const uint8_t*>(mask), static_cast<const uint32_t*>(beat), n,
      n_iter, max_keep, static_cast<int32_t*>(keep_idx), static_cast<uint8_t*>(keep_mask),
      static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
