// Float activations -> int8 at a per-tensor scale for Hopper (sm_90a), plain
// C interface.
//
// Replaces no TPU kernel: the JAX package quantizes each int8 conv's float
// input with array ops that XLA fuses into one pass
// (playground3d_tpu/models/quant.py:140, 197, 233, 248, 421):
//   int8(clip(round_half_even(float32(x) / xs), -127, 127))
// PyTorch runs that expression as five full-tensor launches (a cast, the
// division, round, clamp, a cast), some 35 bytes of traffic an element where
// 3 are needed (bfloat16 in, int8 out). This kernel is the one pass, and
// gives the same bits as those five ops (ops/quantize.py::quantize_plain):
// true division by the scale, which it reads from device memory (so a CUDA
// graph may capture the launch), half-to-even rounding, a NaN quotient to 0
// as the plain int8 cast gives it.
//
// Bound on this card: bytes. The tensor is contiguous or channels-last, so
// its elements are one run of memory, and the output (same strides) another: a thread takes 16
// elements at a step (two or four 16-byte loads, one 16-byte store), a grid
// of as many blocks as the SMs hold walks the run, and a tail loop takes the
// last elements (all of them where either run is not 16-byte aligned).
//
// The rounding is int8_round.cuh's, which qconv.cu's epilogue shares: a
// guess from the reciprocal, the exact division only where the guess may
// round otherwise, and for every value where xs or 1 / xs is not a normal
// number.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_round.cuh"  // requantize_guess, requantize_exact

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // elements a thread takes at a step
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int quantize_one(float v, float xs, float inv_xs, bool fast) {
  bool divide = true;
  int r = 0;
  if (fast) r = requantize_guess(v, inv_xs, divide);
  return divide ? requantize_exact(v, xs) : r;
}

template <bool kBf16>
__device__ __forceinline__ float load_one(const void* x, long long i) {
  if (kBf16) return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(x)[i]) << 16);
  return static_cast<const float*>(x)[i];
}

// 16 elements from 16-byte aligned memory: 16 bfloat16 in two loads or 16
// float32 in four
template <bool kBf16>
__device__ __forceinline__ void load_vec(const void* x, long long g, float (&v)[kVec]) {
  if (kBf16) {
    const uint4* p = static_cast<const uint4*>(x) + 2 * g;
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  } else {
    const float4* p = static_cast<const float4*>(x) + 4 * g;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 a = __ldg(p + k);
      v[4 * k] = a.x;
      v[4 * k + 1] = a.y;
      v[4 * k + 2] = a.z;
      v[4 * k + 3] = a.w;
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const void* __restrict__ x, int8_t* __restrict__ out, const float* __restrict__ xs_ptr,
                long long n, long long groups) {
  const float xs = __ldg(xs_ptr);
  const float inv_xs = __frcp_rn(xs);
  constexpr float kMinNormal = 1.17549435e-38f;
  const bool fast = fabsf(xs) >= kMinNormal && fabsf(inv_xs) >= kMinNormal && isfinite(inv_xs);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long g = first; g < groups; g += step) {
    float v[kVec];
    load_vec<kBf16>(x, g, v);
    int r[kVec];
    bool divide[kVec];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      divide[k] = true;
      r[k] = fast ? requantize_guess(v[k], inv_xs, divide[k]) : 0;
      any |= divide[k];
    }
    if (any) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (divide[k]) r[k] = requantize_exact(v[k], xs);
      }
    }
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = (r[4 * k] & 0xFFu) | ((r[4 * k + 1] & 0xFFu) << 8) | ((r[4 * k + 2] & 0xFFu) << 16) |
             (static_cast<uint32_t>(r[4 * k + 3]) << 24);
    }
    reinterpret_cast<uint4*>(out)[g] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (long long i = groups * kVec + first; i < n; i += step) {
    out[i] = static_cast<int8_t>(quantize_one(load_one<kBf16>(x, i), xs, inv_xs, fast));
  }
}

// blocks of kThreads that the card holds at once for this kernel, cached per device
template <bool kBf16>
cudaError_t resident_blocks(int device, int& blocks) {
  static int cached[kMaxDevices] = {0};
  const bool cache = device >= 0 && device < kMaxDevices;
  if (cache && cached[device] > 0) {
    blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_kernel<kBf16>, kThreads, 0);
  if (err != cudaSuccess) return err;
  blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (cache) cached[device] = blocks;
  return cudaSuccess;
}

template <bool kBf16>
int launch(const void* x, void* out, const float* xs, long long n, cudaStream_t stream) {
  int device = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = resident_blocks<kBf16>(device, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long groups = aligned ? n / kVec : 0;
  const long long work = groups > n - groups * kVec ? groups : n - groups * kVec;  // a thread a group or a tail value
  const long long wanted = (work + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(wanted < resident ? wanted : resident);
  quantize_kernel<kBf16><<<blocks, kThreads, 0, stream>>>(x, static_cast<int8_t*>(out), xs, n, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n bfloat16 (is_bf16 1) or float32 (0) values, one dense run; out: n
// int8, the same layout; xs: one float32 on the device. Launches on `stream`
// and returns the cudaError_t of the launch (0 = cudaSuccess).
int quantize_int8(const void* x, void* out, const void* xs, long long n, int is_bf16, void* stream) {
  if (n < 1 || x == nullptr || out == nullptr || xs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto scale = static_cast<const float*>(xs);
  return is_bf16 ? launch<true>(x, out, scale, n, s) : launch<false>(x, out, scale, n, s);
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
