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
// Bound on this card: bytes (the output, plus each distinct pixel the
// samples touch, once), but the work is so small (32 crops of 112x112x3
// are 4.8 MB out) that the card's memory rate decides nothing. Measured on
// an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section 6), what did limit
// the first version of this kernel was, in order: type-conversion
// instructions (13 per output element, at an eighth of the float32 rate),
// then the chain of dependent trips to memory in each block and the number
// of blocks that chain was paid in. The design:
//
//  * One block per (crop, tile of output rows): the box, the frame index and
//    everything that depends only on the crop are read and computed once
//    per tile. Tiles of 8 rows make 448 blocks at the tracker's shape, all
//    resident at once on 132 SMs. The tile height comes from
//    ops/crop_resize.py::launch_plan (shapes only).
//  * A column table in shared memory: element offset of x0 and of x1 and the
//    weight wx (with 1 - wx already widened to double) for each of the S
//    columns, computed once per block by the warps 1..7, while warp 0
//    fills a row table likewise for the tile's rows. The blend loop does no
//    coordinate arithmetic.
//  * Wide stores: a thread produces four consecutive output floats and
//    writes them as one float4 where the output row is 16-byte aligned,
//    with scalar stores otherwise. A thread keeps its four columns in
//    registers and walks down the tile's rows.
//  * Pixels are read in place, through L1. Staging the row spans in shared
//    memory first (with cp.async.bulk on an mbarrier, and with 16-byte
//    cp.async from the whole block) was built and measured: it was slower at
//    every tile height, at 32 crops and at 2048, because the spans must be
//    sized for a whole frame row (93 KB a block, two blocks an SM) and, for
//    boxes much larger than the output, carry five times the bytes the
//    samples need. PERF.md section 6 keeps the measurement.
//  * Conversions: for uint8 frames the x blends need none (see blend_x).
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

constexpr int kThreads = 256;
constexpr int kMaxTileRows = 16;  // two source rows per output row, one lane of warp 0 each
// shared memory (bytes): the row table, then the column table. The same
// numbers are HEADER_BYTES and COLUMN_BYTES of ops/crop_resize.py.
constexpr int kOffOmwy = 0;                                    // 1 - wy as double
constexpr int kOffWy = kOffOmwy + kMaxTileRows * 8;            // wy
constexpr int kOffRowBase = kOffWy + kMaxTileRows * 4;         // element offset of y0's and y1's row
constexpr int kOffCols = kOffRowBase + 2 * kMaxTileRows * 4;  // 320
constexpr int kColBytes = 8 + 4 + 4 + 4;                       // 1 - wx (double), x0, x1, wx
constexpr int kMaxSmemBytes = 232448;  // 227 KB a block (MAX_SMEM_BYTES of ops/crop_resize.py)

// lo + (j + 0.5) * ((hi - lo) * inv_s) - 0.5, clamped to [0, extent_max]
__device__ __forceinline__ float sample_coord(float lo, float hi, int j, float inv_s,
                                              float extent_max) {
  const float step = __fmul_rn(__fsub_rn(hi, lo), inv_s);
  const double prod = __dmul_rn(static_cast<double>(__fadd_rn(static_cast<float>(j), 0.5f)),
                                static_cast<double>(step));
  const float c = __fsub_rn(__double2float_rn(__dadd_rn(static_cast<double>(lo), prod)), 0.5f);
  return fminf(fmaxf(c, 0.0f), extent_max);
}

struct Tap {
  int i0, i1;  // floor index and the next, both inside the frame
  float w;     // fractional weight of i1
};

__device__ __forceinline__ Tap sample_tap(float lo, float hi, int j, float inv_s, int extent) {
  const float p = sample_coord(lo, hi, j, inv_s, static_cast<float>(extent - 1));
  const float p0 = floorf(p);
  Tap t;
  t.w = __fsub_rn(p, p0);
  t.i0 = min(max(static_cast<int>(p0), 0), extent - 1);
  t.i1 = min(t.i0 + 1, extent - 1);
  return t;
}

// a * (1 - w) + b * w, the sum rounded once (as XLA's multiply-add);
// omw is (double)(1 - w), widened once where the weight is made
__device__ __forceinline__ float blend(float a, float b, float w, double omw) {
  const double aw = __dmul_rn(static_cast<double>(a), omw);
  return __double2float_rn(__dadd_rn(aw, static_cast<double>(__fmul_rn(b, w))));
}

// The x blend of two neighbouring pixels at `p`, o1 - o0 elements apart.
// float32 frames: blend() as it stands.
__device__ __forceinline__ float blend_x(const float* p, int o0, int o1, float w, double omw) {
  return blend(__ldg(p + o0), __ldg(p + o1), w, omw);
}
// uint8 frames: the same value without a conversion instruction. Every
// sample position is a multiple of 2^-24 (a float32 >= 0.5 less 0.5, clamped
// at 0 and at an integer), so w and 1 - w are too; a and b are integers
// below 256, so a * (1 - w) and the rounded b * w are multiples of 2^-24
// below 256 and their sum has at most 33 bits. The float64 sum of blend() is
// therefore exact, its one rounding is float32's, and that is what a single
// float32 multiply-add returns. A pixel becomes a float by dropping it into
// the mantissa of 2^23 and subtracting 2^23, which is exact. (The y blend's
// operands have 24 bits each, its float64 sum can round, and it stays as
// blend().)
__device__ __forceinline__ float blend_x(const uint8_t* p, int o0, int o1, float w, double) {
  const float a = __fsub_rn(__uint_as_float(0x4B000000u | __ldg(p + o0)), 8388608.0f);
  const float b = __fsub_rn(__uint_as_float(0x4B000000u | __ldg(p + o1)), 8388608.0f);
  return __fmaf_rn(a, __fsub_rn(1.0f, w), __fmul_rn(b, w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_resize_kernel(const T* __restrict__ frames, const float* __restrict__ boxes,
                   const int* __restrict__ frame_idx, float* __restrict__ out, int C, int H,
                   int W, int ch, int S, int tile_rows, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* omwy = reinterpret_cast<double*>(smem + kOffOmwy);
  float* wy = reinterpret_cast<float*>(smem + kOffWy);
  int* row_base = reinterpret_cast<int*>(smem + kOffRowBase);  // [2 * tile_rows]
  double* omwx = reinterpret_cast<double*>(smem + kOffCols);
  int* xe0 = reinterpret_cast<int*>(smem + kOffCols + 8 * S);
  int* xe1 = xe0 + S;
  float* wx = reinterpret_cast<float*>(xe1 + S);

  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles;                           // crop
  const int i_first = (blockIdx.x - b * tiles) * tile_rows;  // the tile's first output row
  const int nrows = min(tile_rows, S - i_first);
  const float inv_s = __fdiv_rn(1.0f, static_cast<float>(S));

  if (t < 32) {
    // Warp 0, the row table: lane k has output row k / 2, upper or lower source row.
    if (t < 2 * nrows) {
      const int f = min(max(frame_idx[b], 0), C - 1);  // XLA gather clamps
      const Tap ty = sample_tap(boxes[4 * b + 1], boxes[4 * b + 3], i_first + (t >> 1), inv_s, H);
      const int y = (t & 1) ? ty.i1 : ty.i0;
      row_base[t] = (f * H + y) * W * ch;  // below 2^31: the wrapper checks the frames' size
      if (!(t & 1)) {
        wy[t >> 1] = ty.w;
        omwy[t >> 1] = static_cast<double>(__fsub_rn(1.0f, ty.w));
      }
    }
  } else {
    // The other warps, the column table.
    const float bx1 = boxes[4 * b + 0], bx2 = boxes[4 * b + 2];
    for (int j = t - 32; j < S; j += kThreads - 32) {
      const Tap tx = sample_tap(bx1, bx2, j, inv_s, W);
      xe0[j] = tx.i0 * ch;
      xe1[j] = tx.i1 * ch;
      wx[j] = tx.w;
      omwx[j] = static_cast<double>(__fsub_rn(1.0f, tx.w));
    }
  }
  __syncthreads();

  // Blend: a thread owns four consecutive elements of the output row (one
  // float4) and walks down the tile's rows; row_lanes rows go side by side.
  const int row_elems = S * ch;
  const int groups = (row_elems + 3) >> 2;
  const int lanes = min(groups, kThreads);
  const int row_lanes = kThreads / lanes;
  const int rl = t / lanes, ql = t - rl * lanes;
  const bool wide = (row_elems & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  float* tile_out = out + (static_cast<size_t>(b) * S + i_first) * row_elems;
  if (rl >= row_lanes) return;
  for (int q = ql; q < groups; q += lanes) {
    const int e0 = q * 4;
    int o0[4], o1[4];
    float w[4];
    double omw[4];
    int j = e0 / ch, c = e0 - j * ch;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = min(j, S - 1);  // past the row's end: computed, never stored
      o0[u] = xe0[jj] + c;
      o1[u] = xe1[jj] + c;
      w[u] = wx[jj];
      omw[u] = omwx[jj];
      if (++c == ch) {
        c = 0;
        ++j;
      }
    }
    for (int r = rl; r < nrows; r += row_lanes) {
      const T* row0 = frames + row_base[2 * r];
      const T* row1 = frames + row_base[2 * r + 1];
      const float wyr = wy[r];
      const double omwyr = omwy[r];
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float top = blend_x(row0, o0[u], o1[u], w[u], omw[u]);
        const float bot = blend_x(row1, o0[u], o1[u], w[u], omw[u]);
        v[u] = blend(top, bot, wyr, omwyr);
      }
      float* orow = tile_out + static_cast<size_t>(r) * row_elems;
      if (wide) {
        *reinterpret_cast<float4*>(orow + e0) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (e0 + u < row_elems) orow[e0 + u] = v[u];
        }
      }
    }
  }
}

__global__ void noop_kernel() {}

// tile_rows is ops/crop_resize.py::launch_plan's; the grid and the
// shared-memory bytes follow from it here by launch_plan's rule.
template <typename T>
int launch(const void* frames, const void* boxes, const void* frame_idx, void* out, int C, int H,
           int W, int ch, int n, int S, int tile_rows, void* stream) {
  if (tile_rows < 1 || tile_rows > kMaxTileRows || n < 1 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = kOffCols + static_cast<long long>(kColBytes) * S;
  const long long tiles = (S + tile_rows - 1) / tile_rows;
  if (need > kMaxSmemBytes || n * tiles > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = static_cast<int>(need);
  auto kernel = crop_resize_kernel<T>;
  if (smem_bytes > 48 * 1024) {  // above the default limit of dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(n * tiles), kThreads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<const float*>(boxes),
      static_cast<const int*>(frame_idx), static_cast<float*>(out), C, H, W, ch, S, tile_rows,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All return the cudaError_t of the launch (0 = cudaSuccess).
int crop_and_resize_f32(const void* frames, const void* boxes, const void* frame_idx,
                        void* out, int C, int H, int W, int ch, int n, int S, int tile_rows,
                        void* stream) {
  return launch<float>(frames, boxes, frame_idx, out, C, H, W, ch, n, S, tile_rows, stream);
}

int crop_and_resize_u8(const void* frames, const void* boxes, const void* frame_idx,
                       void* out, int C, int H, int W, int ch, int n, int S, int tile_rows,
                       void* stream) {
  return launch<uint8_t>(frames, boxes, frame_idx, out, C, H, W, ch, n, S, tile_rows, stream);
}

// An empty kernel: what one launch costs on the card's clock, for timing.
int crop_and_resize_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
