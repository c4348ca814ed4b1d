// Planar YUV420 bytes -> uint8 space-to-depth-packed RGB for Hopper (sm_90a),
// plain C interface.
//
// Replaces the device op playground3d_tpu/pipeline/multi_cam.py::
// yuv420_flat_to_s2d, which the JAX package wrote as a chain of pointwise
// array ops for XLA to fuse. It computes that function: [N, H*W*3/2] bytes
// (the Y plane, then U and V at half resolution) become [N, H/4, W/4, 48]
// bytes (channel = (by, bx, colour)), BT.601 limited range, each float32
// operation rounded on its own in the order of the plain version
// (ops/yuv420.py::yuv420_flat_to_s2d_plain), "+ 0.5, clamp, truncate" at the
// end, so the two agree byte for byte.
//
// Bound on this card: bytes (1.5 in and 3 out per pixel; one pass). A thread
// owns one row of four pixels of one output cell: it reads four Y bytes as
// one 32-bit word and two U and two V bytes as 16-bit words, and writes its
// twelve output bytes as three 32-bit words. The four threads of a cell are
// neighbours, so a warp writes 384 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t to_byte(float x) {
  return static_cast<uint32_t>(fminf(fmaxf(__fadd_rn(x, 0.5f), 0.0f), 255.0f));  // truncates
}

__global__ void __launch_bounds__(kThreads)
yuv420_s2d_kernel(const uint8_t* __restrict__ buf, uint8_t* __restrict__ out, int N, int H, int W) {
  const int hc = H >> 2, wc = W >> 2;
  const long long total = static_cast<long long>(N) * hc * wc * 4;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int by = static_cast<int>(e & 3);
  long long cell = e >> 2;
  const int cx = static_cast<int>(cell % wc);
  cell /= wc;
  const int cy = static_cast<int>(cell % hc);
  const long long n = cell / hc;

  const long long plane = static_cast<long long>(H) * W;
  const uint8_t* frame = buf + n * (plane + plane / 2);
  const int y = cy * 4 + by, x = cx * 4;
  const uint32_t y4 = __ldg(reinterpret_cast<const uint32_t*>(frame + static_cast<long long>(y) * W + x));
  const long long coff = static_cast<long long>(y >> 1) * (W >> 1) + (x >> 1);
  const uint32_t u2 = __ldg(reinterpret_cast<const uint16_t*>(frame + plane + coff));
  const uint32_t v2 = __ldg(reinterpret_cast<const uint16_t*>(frame + plane + plane / 4 + coff));

  const float ky = static_cast<float>(255.0 / 219.0), kc = static_cast<float>(255.0 / 224.0);
  uint32_t bytes[12];
#pragma unroll
  for (int px = 0; px < 4; ++px) {
    const float yy = __fmul_rn(__fsub_rn(static_cast<float>((y4 >> (8 * px)) & 255u), 16.0f), ky);
    const float u = __fmul_rn(__fsub_rn(static_cast<float>((u2 >> (8 * (px >> 1))) & 255u), 128.0f), kc);
    const float v = __fmul_rn(__fsub_rn(static_cast<float>((v2 >> (8 * (px >> 1))) & 255u), 128.0f), kc);
    bytes[3 * px + 0] = to_byte(__fadd_rn(yy, __fmul_rn(1.402f, v)));
    bytes[3 * px + 1] = to_byte(__fsub_rn(__fsub_rn(yy, __fmul_rn(0.344136f, u)), __fmul_rn(0.714136f, v)));
    bytes[3 * px + 2] = to_byte(__fadd_rn(yy, __fmul_rn(1.772f, u)));
  }
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (e >> 2) * 48 + by * 12);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dst[k] = bytes[4 * k] | (bytes[4 * k + 1] << 8) | (bytes[4 * k + 2] << 16) | (bytes[4 * k + 3] << 24);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess). H and W are
// multiples of 4 and both pointers 4-byte aligned (the wrapper checks).
int yuv420_s2d(const void* buf, void* out, int N, int H, int W, void* stream) {
  if (N < 1 || H < 4 || W < 4 || (H & 3) || (W & 3)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(N) * (H >> 2) * (W >> 2) * 4;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  yuv420_s2d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(out), N, H, W);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
