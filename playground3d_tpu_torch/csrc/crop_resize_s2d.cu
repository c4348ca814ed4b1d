// Crop-and-resize over space-to-depth-packed frames for Hopper (sm_90a),
// plain C interface.
//
// Replaces the device op playground3d_tpu/ops/crop_mxu.py::crop_and_resize_s2d
// (with s2d_halve), which the JAX package built for the TPU's matrix unit out
// of a stride-2 convolution, one window copy per crop and two products
// against interpolation matrices. It computes that function: frames
// [C,Hs,Ws,48] (channel = (by, bx, colour), uint8 or float32) are box-filtered
// into a pyramid of half-resolution levels; each of n boxes picks the level
// at which its span fits a window of win_cells cells and is sampled
// bilinearly at S x S bin centres of that level, into float32 crops in one of
// three layouts. ops/crop_mxu.py states the roundings (every level, weight
// and row product is rounded to the compute type, bfloat16 or float32); this
// file does the same rounded operations in the same order as the plain
// version there, so for bfloat16 the two agree bit for bit.
//
// What is not carried over: no [n,win,win,48] window copy, no [n,S,4*win]
// weight matrices, no product against a matrix with two non-zeros a row.
// Each output element is four taps of one level. The window survives as a
// rule on the taps: a tap whose pixel lies outside the crop's window of
// 4*win_cells pixels has weight zero, as in the JAX function.
//
// Kernels, behind one launcher:
//
//  * pyramid_kernel builds levels 1 and 2 in one pass: a cell of level 1 is
//    four cells of level 0 and a quarter of a cell of level 2, so one thread
//    per level-1 cell reads its 192 values with 16-byte loads and writes its
//    cell whole. (A thread per level-0 cell, storing its scattered 2-byte
//    values, took 17.8 us on an H100, all of it in the load/store unit; this
//    layout is timed in PERF.md. Folding the pyramid into the sampling instead would cost 4 or 16
//    reads for each of the four taps, again for every crop that overlaps;
//    the whole pyramid of a 1080p frame is 6.2 MB read and 3.9 MB written
//    once.) halve_kernel builds any deeper level from the one below it.
//  * sample_kernel: one block per (crop, tile of 8 output rows). The block
//    derives the crop's level, window origin and the tap tables (offsets of
//    both taps and the two rounded weights, per output column and per row of
//    the tile) once, in shared memory. A warp then owns one output row and
//    its lanes walk the columns, each producing the pixel's three colours,
//    with no division in the loop.
//  * Normalization of a tap is "/ 255, - mean, / std", each rounded to the
//    compute type. At bfloat16 both divisions are multiplications by the
//    float32 reciprocal, which gives the same bfloat16 (see normalized()).
//
// Bound on this card: bytes (the frame read once for the pyramid, the levels
// written, the sampled cells read, the crops written); at 32 crops of 112 px
// that is ~26 MB, under 8 us at 3.35 TB/s, so launches and latency decide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;    // output rows per block (TILE_ROWS of ops/crop_mxu.py)
constexpr int kMaxLevels = 8;   // MAX_LEVELS of ops/crop_mxu.py
constexpr int kMaxOutSize = 1024;  // MAX_OUT_SIZE of ops/crop_mxu.py: the column table is static

enum Layout { kS2d = 0, kHwc = 1, kChw = 2 };

// ---- the compute type: a float that holds a value rounded to it -----------

template <typename D> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename D> __device__ __forceinline__ D store_as(float v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float load_f(const uint8_t* p, long long i) {
  return static_cast<float>(__ldg(p + i));
}
__device__ __forceinline__ float load_f(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// ---- pyramid ---------------------------------------------------------------

// the mean of four values already rounded to D: summed in float32 (top pair,
// then bottom pair), rounded to D once
template <typename D>
__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
  return round_to<D>(__fmul_rn(__fadd_rn(__fadd_rn(a, b), __fadd_rn(c, d)), 0.25f));
}

// in [C,Hin,Win,48] of Tin -> out [C,Hin/2,Win/2,48] of D: the mean of each
// 2x2 pixel block, staying packed; a thread per output element. For the
// levels below the second (pyramid_kernel builds the first two).
template <typename Tin, typename D>
__global__ void __launch_bounds__(kThreads)
halve_kernel(const Tin* __restrict__ in, D* __restrict__ out, int C, int Hin, int Win) {
  const int Ho = Hin >> 1, Wo = Win >> 1;
  const long long total = static_cast<long long>(C) * Ho * Wo * 48;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int co = static_cast<int>(e % 48);
  long long cell = e / 48;
  const int wo = static_cast<int>(cell % Wo);
  cell /= Wo;
  const int ho = static_cast<int>(cell % Ho);
  const int c = static_cast<int>(cell / Ho);
  const int byo = co / 12, bxo = (co % 12) / 3, col = co % 3;
  float v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int iy = 2 * byo + (r >> 1), ix = 2 * bxo + (r & 1);  // pixel inside the 2x2 cells
    const int hi = 2 * ho + (iy >> 2), wi = 2 * wo + (ix >> 2);
    const long long src =
        ((static_cast<long long>(c) * Hin + hi) * Win + wi) * 48 + (iy & 3) * 12 + (ix & 3) * 3 + col;
    v[r] = round_to<D>(load_f(in, src));
  }
  out[e] = store_as<D>(mean4<D>(v[0], v[1], v[2], v[3]));
}

// The 48 values of one cell, each rounded to D, read with 16-byte loads
// (the launcher's caller checks that the frames start on a 16-byte boundary).
template <typename Tin, typename D>
__device__ __forceinline__ void load_cell(const Tin* cell, float (&v)[48]) {
  if constexpr (std::is_same<Tin, uint8_t>::value) {
    const uint4* p = reinterpret_cast<const uint4*>(cell);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint4 w = __ldg(p + q);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        v[16 * q + k] = static_cast<float>((words[k >> 2] >> (8 * (k & 3))) & 255u);  // exact in D
      }
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(cell);
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      const float4 w = __ldg(p + q);
      v[4 * q + 0] = round_to<D>(w.x);
      v[4 * q + 1] = round_to<D>(w.y);
      v[4 * q + 2] = round_to<D>(w.z);
      v[4 * q + 3] = round_to<D>(w.w);
    }
  }
}

// n consecutive values (n even, dst 4-byte aligned) of D from floats
// that already hold values rounded to D
template <int n>
__device__ __forceinline__ void store_run(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < n; ++k) dst[k] = v[k];
}
template <int n>
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float* v) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int k = 0; k < n / 2; ++k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);  // .x is the low half
    d[k] = *reinterpret_cast<const uint32_t*>(&pair);
  }
}

// the 2x2 means of the 4x4 pixels in cell[48] (pixel-major, colour last)
// into out at pixel (row0 + a, col0 + b) of a cell laid out the same way
template <typename D>
__device__ __forceinline__ void halve_cell(const float (&cell)[48], float* out, int row0, int col0) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        const int p = ((2 * a) * 4 + 2 * b) * 3 + col;  // pixel (2a, 2b) of the cell
        out[((row0 + a) * 4 + col0 + b) * 3 + col] = mean4<D>(cell[p], cell[p + 3], cell[p + 12], cell[p + 15]);
      }
    }
  }
}

// Levels 1 and 2 from level 0 [C,Hs,Ws,48], one thread per level-1 cell
// (y1, x1): the four level-0 cells (2y1 + qy, 2x1 + qx) are its four 2x2-pixel
// quadrants, and its own 4 x 4 pixels are the 2 x 2 pixels (2(y1&1) + a,
// 2(x1&1) + b) of level-2 cell (y1 >> 1, x1 >> 1). The thread reads 192
// values with 16-byte loads, writes its whole level-1 cell with 16-byte
// stores and its six-value rows of level 2 with 4-byte stores. An odd last
// cell row or column of a level has no place in the next (the halving drops
// it). l2 may be null.
template <typename Tin, typename D>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const Tin* __restrict__ in, D* __restrict__ l1, D* __restrict__ l2, int C, int Hs,
               int Ws) {
  const int H1 = Hs >> 1, W1 = Ws >> 1, H2 = H1 >> 1, W2 = W1 >> 1;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(C) * H1 * W1) return;
  const int x1 = static_cast<int>(idx % W1);
  const int y1 = static_cast<int>((idx / W1) % H1);
  const int c = static_cast<int>(idx / (static_cast<long long>(W1) * H1));
  float o[48];  // the level-1 cell, values rounded to D
#pragma unroll
  for (int qy = 0; qy < 2; ++qy) {
#pragma unroll
    for (int qx = 0; qx < 2; ++qx) {
      float v[48];
      load_cell<Tin, D>(in + ((static_cast<long long>(c) * Hs + 2 * y1 + qy) * Ws + 2 * x1 + qx) * 48, v);
      halve_cell<D>(v, o, 2 * qy, 2 * qx);
    }
  }
  D* o1 = l1 + idx * 48;
  if constexpr (std::is_same<D, float>::value) {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      reinterpret_cast<float4*>(o1)[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(o[8 * k + 2 * j], o[8 * k + 2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      reinterpret_cast<uint4*>(o1)[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (l2 != nullptr && (y1 >> 1) < H2 && (x1 >> 1) < W2) {
    float q[48];  // only the quadrant (0..1, 0..1) is filled and stored
    halve_cell<D>(o, q, 0, 0);
    D* o2 = l2 + ((static_cast<long long>(c) * H2 + (y1 >> 1)) * W2 + (x1 >> 1)) * 48;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      store_run<6>(o2 + ((2 * (y1 & 1) + a) * 4 + 2 * (x1 & 1)) * 3, q + (a * 4) * 3);
    }
  }
}

// ---- sampling --------------------------------------------------------------

struct SampleArgs {
  const void* frames;        // level 0, [C,Hs,Ws,48] of Tin
  const void* pyramid;       // levels 1.. of D, one after the other
  const float* boxes;        // [n,4] xyxy, level-0 pixels
  const int* cam_idx;        // [n]
  float* out;                // [n,S,S,3] in the asked layout
  long long level_offset[kMaxLevels];  // element offset of level k >= 1 in `pyramid`
  int C, Hs, Ws, S, win_cells, n_levels, layout, normalize, tiles;
  float inv_cap, inv_s;      // float32 reciprocals of win_cells*4-8 and of S
  float mean[3], stdev[3];   // normalization constants, already rounded to D
  float inv255, inv_std[3];  // float32 reciprocals of 255 and of stdev
};

struct Axis {
  int origin_px;   // first pixel of the window
  int valid_px;    // pixels of the level along this axis
};

// lo/ls + (j + 0.5) * step - 0.5 with the sum rounded once (float64 holds
// the product of two floats exactly), clamped to the level's valid pixels
__device__ __forceinline__ float sample_pos(float lo_l, float step, int j, float max_px) {
  const double prod = __dmul_rn(static_cast<double>(__fadd_rn(static_cast<float>(j), 0.5f)),
                                static_cast<double>(step));
  const float p = __fsub_rn(__double2float_rn(__dadd_rn(static_cast<double>(lo_l), prod)), 0.5f);
  return fminf(fmaxf(p, 0.0f), max_px);
}

// One tap pair of a sample: pixel index of both taps (absolute in the level,
// clamped so they can be read) and the two weights, rounded to D, zero where
// the tap lies outside the window or outside the level.
template <typename D>
__device__ __forceinline__ void taps(float pos, Axis ax, int win_px, int* i0, int* i1, float* w0,
                                     float* w1) {
  const float r = __fsub_rn(pos, static_cast<float>(ax.origin_px));
  const float f = floorf(r);
  const int k = static_cast<int>(f);
  float a = __fsub_rn(1.0f, fabsf(__fsub_rn(r, f)));
  float b = __fsub_rn(1.0f, fabsf(__fsub_rn(r, __fadd_rn(f, 1.0f))));
  a = round_to<D>(fminf(fmaxf(a, 0.0f), 1.0f));
  b = round_to<D>(fminf(fmaxf(b, 0.0f), 1.0f));
  const int p0 = ax.origin_px + k;
  if (k < 0 || k >= win_px || p0 >= ax.valid_px) a = 0.0f;
  if (k + 1 < 0 || k + 1 >= win_px || p0 + 1 >= ax.valid_px) b = 0.0f;
  *i0 = min(max(p0, 0), ax.valid_px - 1);
  *i1 = min(max(p0 + 1, 0), ax.valid_px - 1);
  *w0 = a;
  *w1 = b;
}

// v / d rounded to D. At float32 it is the division. At bfloat16 it is
// fl(v * fl(1 / d)), which rounds to the same bfloat16 as the correctly
// rounded quotient whenever v and d are bfloat16 values, with 8-bit
// significands m1 and m2 in [128, 256). The quotient is m1 / m2 times a power
// of two. A point midway between two neighbouring bfloat16 values is
// (2k+1) / 512 times a power of two, with 2k+1 in (256, 512). The two
// coincide only if m1 * 2^s = m2 * (2k+1) for some s >= 0, so only if the odd
// part of m1 is the odd part of m2 times 2k+1 > 256 > m1: never. Both sides
// being integers they differ by at least 1, which is more than 7.6e-6 of the
// quotient, and both float32 values lie within 2e-7 of it: on the same side
// of every midpoint. Values so small that the quotient could be subnormal
// are divided.
template <typename D>
__device__ __forceinline__ float quotient(float v, float d, float inv_d) {
  if (std::is_same<D, float>::value || fabsf(v) < 1e-30f) return round_to<D>(__fdiv_rn(v, d));
  return round_to<D>(__fmul_rn(v, inv_d));
}

template <typename D>
__device__ __forceinline__ float normalized(float v, int col, const SampleArgs& a) {
  v = quotient<D>(v, 255.0f, a.inv255);
  v = round_to<D>(__fsub_rn(v, a.mean[col]));
  return quotient<D>(v, a.stdev[col], a.inv_std[col]);
}

template <typename Tin, typename D>
__global__ void __launch_bounds__(kThreads) sample_kernel(const SampleArgs a) {
  // tap tables: element offset of both taps inside one camera's level (a
  // column's includes its place inside the cell) and the two weights
  __shared__ int col_o0[kMaxOutSize], col_o1[kMaxOutSize];
  __shared__ float col_w0[kMaxOutSize], col_w1[kMaxOutSize];
  __shared__ int row_o0[kTileRows], row_o1[kTileRows];
  __shared__ float row_w0[kTileRows], row_w1[kTileRows];

  const int t = threadIdx.x;
  const int S = a.S;
  const int b = blockIdx.x / a.tiles;
  const int first_row = (blockIdx.x - b * a.tiles) * kTileRows;
  const int nrows = min(kTileRows, S - first_row);
  const int win_px = a.win_cells * 4;

  // the crop's level, scale and window: every thread derives them alike
  const float x1 = a.boxes[4 * b + 0], y1 = a.boxes[4 * b + 1];
  const float x2 = a.boxes[4 * b + 2], y2 = a.boxes[4 * b + 3];
  const float span = fmaxf(fmaxf(__fsub_rn(x2, x1), __fsub_rn(y2, y1)), 1.0f);
  const float ratio = __fmul_rn(span, a.inv_cap);
  int level = 0;
  for (int k = 0; k < a.n_levels - 1; ++k) level += ratio > static_cast<float>(1 << k) ? 1 : 0;
  const float ls = static_cast<float>(1 << level);
  const int hl = a.Hs >> level, wl = a.Ws >> level;  // cells of the level
  const float step_x = __fdiv_rn(__fmul_rn(__fsub_rn(x2, x1), a.inv_s), ls);
  const float step_y = __fdiv_rn(__fmul_rn(__fsub_rn(y2, y1), a.inv_s), ls);
  const float x1l = __fdiv_rn(x1, ls), y1l = __fdiv_rn(y1, ls);
  const float max_x = static_cast<float>(wl * 4) - 1.0f, max_y = static_cast<float>(hl * 4) - 1.0f;
  const int cx0 = min(max(static_cast<int>(floorf(sample_pos(x1l, step_x, 0, max_x) * 0.25f)), 0),
                      max(wl - a.win_cells, 0));
  const int cy0 = min(max(static_cast<int>(floorf(sample_pos(y1l, step_y, 0, max_y) * 0.25f)), 0),
                      max(hl - a.win_cells, 0));
  const Axis ax_x = {cx0 * 4, wl * 4}, ax_y = {cy0 * 4, hl * 4};

  for (int j = t; j < S; j += kThreads) {
    int i0, i1;
    taps<D>(sample_pos(x1l, step_x, j, max_x), ax_x, win_px, &i0, &i1, &col_w0[j], &col_w1[j]);
    col_o0[j] = (i0 >> 2) * 48 + (i0 & 3) * 3;
    col_o1[j] = (i1 >> 2) * 48 + (i1 & 3) * 3;
  }
  if (t < nrows) {
    int i0, i1;
    taps<D>(sample_pos(y1l, step_y, first_row + t, max_y), ax_y, win_px, &i0, &i1, &row_w0[t], &row_w1[t]);
    row_o0[t] = (i0 >> 2) * wl * 48 + (i0 & 3) * 12;  // below 2^31: the wrapper checks the frames' size
    row_o1[t] = (i1 >> 2) * wl * 48 + (i1 & 3) * 12;
  }
  __syncthreads();

  const int sl = t >> 5;  // a warp per output row of the tile
  if (sl >= nrows) return;
  const int cam = min(max(a.cam_idx[b], 0), a.C - 1);
  const long long cam_base = static_cast<long long>(cam) * hl * wl * 48;
  const Tin* lvl0 = static_cast<const Tin*>(a.frames) + cam_base;
  const D* lvln = static_cast<const D*>(a.pyramid) + (level > 0 ? a.level_offset[level] : 0) + cam_base;

  // a value of the crop's level, as a float holding a value rounded to D
  auto pixel = [&](int offset, int col) -> float {
    const float v = level == 0 ? round_to<D>(load_f(lvl0, offset + col)) : load_f(lvln, offset + col);
    return a.normalize ? normalized<D>(v, col, a) : v;
  };

  const int row = first_row + sl;
  const int ro0 = row_o0[sl], ro1 = row_o1[sl];
  const float wy0 = row_w0[sl], wy1 = row_w1[sl];
  float* crop = a.out + static_cast<long long>(b) * S * S * 3;
  for (int tc = t & 31; tc < S; tc += 32) {
    const int co0 = col_o0[tc], co1 = col_o1[tc];
    const float wx0 = col_w0[tc], wx1 = col_w1[tc];
    float* o;
    int col_stride = 1;
    if (a.layout == kS2d) {
      o = crop + ((row >> 2) * (S >> 2) + (tc >> 2)) * 48 + (row & 3) * 12 + (tc & 3) * 3;
    } else if (a.layout == kHwc) {
      o = crop + (row * S + tc) * 3;
    } else {
      o = crop + row * S + tc;
      col_stride = S * S;
    }
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      // row product (over y) at the two columns, rounded to D; then the column product
      const float ta = round_to<D>(__fmaf_rn(wy0, pixel(ro0 + co0, col), __fmul_rn(wy1, pixel(ro1 + co0, col))));
      const float tb = round_to<D>(__fmaf_rn(wy0, pixel(ro0 + co1, col), __fmul_rn(wy1, pixel(ro1 + co1, col))));
      o[col * col_stride] = __fmaf_rn(wx0, ta, __fmul_rn(wx1, tb));
    }
  }
}

template <typename Tin, typename D>
int launch_all(const SampleArgs& a, int n, cudaStream_t stream) {
  D* pyr = static_cast<D*>(const_cast<void*>(a.pyramid));
  if (a.n_levels > 1) {  // levels 1 and 2 in one pass over the frames
    const long long cells = static_cast<long long>(a.C) * (a.Hs >> 1) * (a.Ws >> 1);  // of level 1
    pyramid_kernel<Tin, D><<<static_cast<unsigned>((cells + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        static_cast<const Tin*>(a.frames), pyr + a.level_offset[1],
        a.n_levels > 2 ? pyr + a.level_offset[2] : nullptr, a.C, a.Hs, a.Ws);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int k = 3; k < a.n_levels; ++k) {  // each deeper level from the one below
    const int hin = a.Hs >> (k - 1), win = a.Ws >> (k - 1);
    const long long total = static_cast<long long>(a.C) * (hin >> 1) * (win >> 1) * 48;
    halve_kernel<D, D><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        pyr + a.level_offset[k - 1], pyr + a.level_offset[k], a.C, hin, win);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sample_kernel<Tin, D><<<static_cast<unsigned>(n) * a.tiles, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Builds the pyramid and samples the crops on `stream`; returns the
// cudaError_t of the first launch that failed (0 = cudaSuccess).
// frames_u8: frames are uint8 (else float32), starting on a 16-byte boundary.
// dtype_bf16: the compute type is
// bfloat16 (else float32); `pyramid` holds levels 1.. in that type at
// level_offset[k] elements. norm6: mean[3] then std[3], rounded to the type.
int crop_resize_s2d(const void* frames, void* pyramid, const long long* level_offset,
                    const void* boxes, const void* cam_idx, void* out, int C, int Hs, int Ws,
                    int n, int S, int win_cells, int n_levels, int layout, int frames_u8,
                    int dtype_bf16, int normalize, const float* norm6, void* stream) {
  if (n < 1 || S < 1 || S > kMaxOutSize || n_levels < 1 || n_levels > kMaxLevels ||
      win_cells < 1 || layout < 0 || layout > 2 || (Hs >> (n_levels - 1)) < 1 ||
      (Ws >> (n_levels - 1)) < 1 || (layout == kS2d && (S & 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SampleArgs a;
  a.frames = frames;
  a.pyramid = pyramid;
  a.boxes = static_cast<const float*>(boxes);
  a.cam_idx = static_cast<const int*>(cam_idx);
  a.out = static_cast<float*>(out);
  for (int k = 0; k < kMaxLevels; ++k) a.level_offset[k] = k < n_levels ? level_offset[k] : 0;
  a.C = C; a.Hs = Hs; a.Ws = Ws; a.S = S; a.win_cells = win_cells; a.n_levels = n_levels;
  a.layout = layout; a.normalize = normalize;
  a.tiles = (S + kTileRows - 1) / kTileRows;
  a.inv_cap = 1.0f / static_cast<float>(win_cells * 4 - 8);
  a.inv_s = 1.0f / static_cast<float>(S);
  a.inv255 = 1.0f / 255.0f;
  for (int k = 0; k < 3; ++k) {
    a.mean[k] = norm6[k];
    a.stdev[k] = norm6[3 + k];
    a.inv_std[k] = 1.0f / norm6[3 + k];
  }
  if (static_cast<long long>(n) * a.tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames_u8) {
    return dtype_bf16 ? launch_all<uint8_t, __nv_bfloat16>(a, n, s) : launch_all<uint8_t, float>(a, n, s);
  }
  return dtype_bf16 ? launch_all<float, __nv_bfloat16>(a, n, s) : launch_all<float, float>(a, n, s);
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
