// Batched bilinear crop-and-resize for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel playground3d_tpu/ops/pallas/crop_resize.py::
// crop_and_resize_pallas (body _crop_kernel). It computes that function:
// each of n boxes (xyxy, float32) is sampled at S x S bin centres with the
// half-pixel convention and a border-replicating clamp, from the frame
// frame_idx[b] of a [C,H,W,ch] NHWC stack, into [n,S,S,ch] float32.
//
// Frames are float32 or uint8. uint8 pixels are converted to float in
// registers, so the result equals cropping frames.float() (the cast is
// exact) without writing a float copy of the whole frame first.
//
// Bound on this card: bytes. Per output element the kernel reads four
// neighbours and does ~20 flops, so device memory traffic (the output plus
// the frame pixels the samples touch) bounds it, and at the tracker's shapes
// (32 crops of 112x112x3) that traffic is a few MB: the launch itself is a
// large share of the time. Design: one block per (crop, output row); the two
// source rows of that output row are read in place from the frame (nothing
// is pre-gathered into device memory, unlike the Pallas version's jnp.take
// row copy), threads walk (x, channel) so neighbouring threads read
// neighbouring bytes, and the output row is written coalesced. Faster forms
// (row windows in shared memory through TMA, several crops per block) are
// later work.
//
// Arithmetic: the reference's float32 formulas, rounded where XLA rounds
// them. XLA divides by the constant S as a multiply by its float32
// reciprocal, and contracts "x1 + (j + 0.5) * bw" and each blend
// "a * (1 - w) + b * w" into one multiply-add; at x ~ 1900 one ulp of a
// sample coordinate is ~1e-4 px, which moves a 0-255 output by up to 0.03.
// Those three sums are evaluated here in float64 (the product of two floats
// is exact there) and rounded to float32; every other op is an explicitly
// rounded float32 intrinsic. The plain version
// (ops/roi_align.py::crop_and_resize_plain) does the same ops in the same
// order, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_px(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_px(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

// lo + (j + 0.5) * ((hi - lo) * inv_s) - 0.5, clamped to [0, extent_max]
__device__ __forceinline__ float sample_coord(float lo, float hi, int j, float inv_s,
                                              float extent_max) {
  const float step = __fmul_rn(__fsub_rn(hi, lo), inv_s);
  const double prod = __dmul_rn(static_cast<double>(__fadd_rn(static_cast<float>(j), 0.5f)),
                                static_cast<double>(step));
  const float c = __fsub_rn(__double2float_rn(__dadd_rn(static_cast<double>(lo), prod)), 0.5f);
  return fminf(fmaxf(c, 0.0f), extent_max);
}

// a * (1 - w) + b * w, the sum rounded once (as XLA's multiply-add)
__device__ __forceinline__ float blend(float a, float b, float w) {
  const double aw = __dmul_rn(static_cast<double>(a), static_cast<double>(__fsub_rn(1.0f, w)));
  return __double2float_rn(__dadd_rn(aw, static_cast<double>(__fmul_rn(b, w))));
}

template <typename T>
__global__ void crop_resize_kernel(const T* __restrict__ frames,
                                   const float* __restrict__ boxes,
                                   const int* __restrict__ frame_idx,
                                   float* __restrict__ out, int C, int H, int W,
                                   int ch, int S) {
  const int i = blockIdx.x;  // output row
  const int b = blockIdx.y;  // crop
  const float bx1 = boxes[4 * b + 0], by1 = boxes[4 * b + 1];
  const float bx2 = boxes[4 * b + 2], by2 = boxes[4 * b + 3];
  const int f = min(max(frame_idx[b], 0), C - 1);  // XLA gather clamps
  const float inv_s = __fdiv_rn(1.0f, static_cast<float>(S));

  const float ys = sample_coord(by1, by2, i, inv_s, static_cast<float>(H - 1));
  const float y0f = floorf(ys);
  const float wy = __fsub_rn(ys, y0f);
  const int y0 = min(max(static_cast<int>(y0f), 0), H - 1);
  const int y1 = min(y0 + 1, H - 1);
  const size_t row_stride = static_cast<size_t>(W) * ch;
  const T* row0 = frames + (static_cast<size_t>(f) * H + y0) * row_stride;
  const T* row1 = frames + (static_cast<size_t>(f) * H + y1) * row_stride;
  float* orow = out + (static_cast<size_t>(b) * S + i) * static_cast<size_t>(S) * ch;

  const int row_elems = S * ch;
  for (int e = threadIdx.x; e < row_elems; e += blockDim.x) {
    const int j = e / ch;
    const int c = e - j * ch;
    const float xs = sample_coord(bx1, bx2, j, inv_s, static_cast<float>(W - 1));
    const float x0f = floorf(xs);
    const float wx = __fsub_rn(xs, x0f);
    const int x0 = min(max(static_cast<int>(x0f), 0), W - 1);
    const int x1 = min(x0 + 1, W - 1);
    const size_t o0 = static_cast<size_t>(x0) * ch + c;
    const size_t o1 = static_cast<size_t>(x1) * ch + c;
    const float top = blend(load_px(row0 + o0), load_px(row0 + o1), wx);
    const float bot = blend(load_px(row1 + o0), load_px(row1 + o1), wx);
    orow[e] = blend(top, bot, wy);
  }
}

constexpr int kThreads = 128;

template <typename T>
int launch(const void* frames, const void* boxes, const void* frame_idx, void* out,
           int C, int H, int W, int ch, int n, int S, void* stream) {
  const dim3 grid(S, n);
  crop_resize_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<const float*>(boxes),
      static_cast<const int*>(frame_idx), static_cast<float*>(out), C, H, W, ch, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both return the cudaError_t of the launch (0 = cudaSuccess).
int crop_and_resize_f32(const void* frames, const void* boxes, const void* frame_idx,
                        void* out, int C, int H, int W, int ch, int n, int S,
                        void* stream) {
  return launch<float>(frames, boxes, frame_idx, out, C, H, W, ch, n, S, stream);
}

int crop_and_resize_u8(const void* frames, const void* boxes, const void* frame_idx,
                       void* out, int C, int H, int W, int ch, int n, int S,
                       void* stream) {
  return launch<uint8_t>(frames, boxes, frame_idx, out, C, H, W, ch, n, S, stream);
}

const char* crop_and_resize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
