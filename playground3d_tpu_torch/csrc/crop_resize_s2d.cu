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
// Bound on this card: bytes (the frame read once for the pyramid, the levels
// written, the sampled cells read, the crops written); at 32 crops of 112 px
// that is ~26 MB, 7.9 us at 3.35 TB/s. In the packed layout one pixel row of
// a cell is a run of 12 values and the next cell's run is 48 values on; the
// 32 crops of the main path overlap ~15-fold on level 2. What decided the
// time of the first version (33 us on an NVIDIA H100 80GB HBM3 at 700.00 W;
// PERF.md) was neither: scalar 2-byte gathers, float-to-bfloat16 conversion
// instructions (a fraction of the float32 rate) and normalizing each value
// again at every tap. Two kernels, one call:
//
//  * pyramid_kernel builds levels 1 and 2 in one pass. A block takes 64
//    level-1 cells of one cell row and copies the two level-0 cell rows under
//    them into shared memory (contiguous 16-byte loads); then a thread per
//    (level-1 cell, pixel row) makes its row from two runs of 24 values, and
//    the odd row of each pair takes the even row above it from the
//    neighbouring lane (a shuffle) for its half-row of level 2. 540 blocks at
//    1080p are in flight together. It lets the sampling kernel launch at once
//    (griddepcontrol.launch_dependents). halve_kernel builds any deeper
//    level from the one below it.
//  * sample_kernel: one block per (crop, tile of 8 output rows), launched
//    with programmatic stream serialization so that its blocks derive the
//    crop's level, window and tap tables (float64 positions rounded once)
//    while the pyramid is still being written; they wait for it
//    (griddepcontrol.wait) before they read a level above 0, and a crop of
//    level 0 at its end, so the kernel never ends before the pyramid. The
//    block then stages the <= 16 source pixel rows its row taps name (a list,
//    not a range: rows of a tile may lie far apart) over the columns its
//    column taps touch inside the window, in shared memory, with
//    asynchronous copies (cp.async): consecutive lanes copy consecutive
//    4-value pieces of the cells' runs, all of a thread's in flight at once.
//    The values are then rounded and normalized in shared memory, in pairs at
//    bfloat16 (normalizing where the levels are built instead was measured:
//    no faster; PERF.md). A thread then makes four consecutive
//    output columns of one row: 12 floats, three 16-byte stores in the s2d
//    and hwc layouts, one float4 per colour in chw (scalar stores where S is
//    not a multiple of 4). A tap of weight zero reads a staged slot: its
//    product is zero whatever the slot holds.
//  * Normalization of a value is "/ 255, - mean, / std", each rounded to the
//    compute type. At bfloat16 both divisions are multiplications by the
//    float32 reciprocal, which gives the same bfloat16 (see quotient()). It
//    is elementwise on a value already rounded to the compute type, so
//    normalizing as a value is staged gives the bits of normalizing at the
//    tap. Rounding to bfloat16 is done on the
//    bits (round_to()) or by the pair conversion, never by the scalar
//    conversion instruction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;    // output rows per block (TILE_ROWS of ops/crop_mxu.py)
constexpr int kMaxLevels = 8;   // MAX_LEVELS of ops/crop_mxu.py
constexpr int kMaxOutSize = 1024;  // MAX_OUT_SIZE of ops/crop_mxu.py
constexpr int kMaxSharedBytes = 232448;  // MAX_SHARED_BYTES of ops/crop_mxu.py: a block's on the H100
constexpr int kPyramidCells = 64;  // PYRAMID_CELLS of ops/crop_mxu.py: level-1 cells a pyramid block builds

enum Layout { kS2d = 0, kHwc = 1, kChw = 2 };

// With -DCROP_S2D_TIMING (scripts/crop_s2d_timeline.py) each block writes
// the card's global timer at the points of its life that STAMP names.
#ifdef CROP_S2D_TIMING
__device__ unsigned long long crop_s2d_stamps[2][16384][6];  // [pyramid, sampling][block][point]
#define STAMP(kernel, point)                                                        \
  do {                                                                              \
    if (threadIdx.x == 0 && blockIdx.x < 16384) {                                   \
      unsigned long long t_;                                                        \
      asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_));                         \
      crop_s2d_stamps[kernel][blockIdx.x][point] = t_;                              \
    }                                                                               \
  } while (0)
#else
#define STAMP(kernel, point) \
  do {                       \
  } while (0)
#endif

// Dynamic shared memory of sample_kernel (ops/crop_mxu.py::sample_shared_bytes):
// the column table (two staged pixels and two weights per output column, S
// rounded up to 4), the row table (a source offset and a weight per staged
// row) and two areas of 2 * kTileRows staged rows, each row 4 * win_cells
// pixels of 3 values: the frames' values as copied (level 0) and the values
// of the compute type the taps read.
__host__ __device__ constexpr int col_table_bytes(int S) { return 16 * ((S + 3) & ~3); }
constexpr int kRowTableBytes = 8 * 2 * kTileRows;
__host__ __device__ constexpr int stage_pitch(int win_cells) { return 12 * win_cells; }  // values a staged row
int sample_shared_bytes(int S, int win_cells, int value_bytes, int frame_bytes) {
  return col_table_bytes(S) + kRowTableBytes + 2 * kTileRows * stage_pitch(win_cells) * (frame_bytes + value_bytes);
}

// ---- the compute type: a float that holds a value rounded to it -----------

// Rounding to bfloat16 is done on the bits, to nearest even: add 0x7fff
// plus the lowest bit that stays, clear the 16 that go. For every finite
// float it gives the bits of __float2bfloat16_rn (a carry into the exponent
// is the rounding up to the next binade, or to infinity), in three integer
// operations at the full rate, where the conversion instruction runs at a
// fraction of it and limited the first versions of these kernels.
template <typename D> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  const uint32_t u = __float_as_uint(v);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

// a float that holds a value of D, stored as D
template <typename D> __device__ __forceinline__ D store_as(float v);
template <> __device__ __forceinline__ float store_as<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(v) >> 16));
}

// byte k of w as a float: the byte in the low bits of 2^23's significand,
// less 2^23 (exact; two full-rate operations instead of a conversion)
__device__ __forceinline__ float byte_f(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650u + k)), 8388608.0f);
}

__device__ __forceinline__ float load_f(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// two floats that hold bfloat16 values as one word, lo in the low half
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Four consecutive staged values at p as floats rounded to D, and four
// floats that hold values of D stored at p. p is aligned to four values: 4
// bytes (uint8), 8 (bfloat16), 16 (float32).
template <typename T, typename D>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  if constexpr (std::is_same<T, uint8_t>::value) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = byte_f(w, k);  // exact in D
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x); v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
  } else {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = round_to<D>(w.x); v[1] = round_to<D>(w.y); v[2] = round_to<D>(w.z); v[3] = round_to<D>(w.w);
  }
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// an asynchronous copy of `bytes` (4, 8 or 16, aligned) from global to shared memory
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(bytes) : "memory");
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

// 24 consecutive values of staged frames (two pixel rows of a cell) as
// floats rounded to D: three 8-byte loads (uint8, 8-byte aligned) or six
// 16-byte loads (float32)
template <typename Tin, typename D>
__device__ __forceinline__ void load_run24(const Tin* p, float (&v)[24]) {
  if constexpr (std::is_same<Tin, uint8_t>::value) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint2 w = q[k];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[8 * k + b] = byte_f(w.x, b);  // exact in D
        v[8 * k + 4 + b] = byte_f(w.y, b);
      }
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 w = q[k];
      v[4 * k + 0] = round_to<D>(w.x);
      v[4 * k + 1] = round_to<D>(w.y);
      v[4 * k + 2] = round_to<D>(w.z);
      v[4 * k + 3] = round_to<D>(w.w);
    }
  }
}

// n (6 or 12) consecutive values of D from floats that already hold values
// rounded to D; dst is aligned to n/6 * 8 bytes at float32 and n/6 * 4 at
// bfloat16
template <int n>
__device__ __forceinline__ void store_run(float* dst, const float* v) {
  if constexpr (n == 12) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      reinterpret_cast<float4*>(dst)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < n / 2; ++k) reinterpret_cast<float2*>(dst)[k] = make_float2(v[2 * k], v[2 * k + 1]);
  }
}
template <int n>
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float* v) {
  if constexpr (n == 12) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      reinterpret_cast<uint2*>(dst)[k] = make_uint2(bf16_pair(v[4 * k], v[4 * k + 1]), bf16_pair(v[4 * k + 2], v[4 * k + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < n / 2; ++k) reinterpret_cast<uint32_t*>(dst)[k] = bf16_pair(v[2 * k], v[2 * k + 1]);
  }
}

// Levels 1 and 2 from level 0 [C,Hs,Ws,48]. A block builds kPyramidCells
// level-1 cells of one cell row y1: it first copies level-0 cell rows 2y1 and
// 2y1+1 under them (contiguous, 16-byte asynchronous copies) into shared
// memory. Then one
// thread per (level-1 cell (y1, x1), pixel row a): pixel row a of the cell is
// the 2x2 means of pixel rows 2(a&1) and 2(a&1)+1 of level-0 cells
// (2y1 + (a>>1), 2x1 + qx), qx = 0, 1: two runs of 24 values. Pixel rows 2k
// and 2k+1 of the cell make pixel row 2(y1&1) + k of level-2 cell
// (y1 >> 1, x1 >> 1), its pixels 2(x1&1) and 2(x1&1) + 1: the odd row's
// thread takes the even row from the lane below. An odd last cell row or
// column of a level has no place in the next (the halving drops it). l2 may
// be null.
template <typename Tin, typename D>
__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const Tin* __restrict__ in, D* __restrict__ l1, D* __restrict__ l2, int C, int Hs,
               int Ws) {
  static_assert(kThreads == 4 * kPyramidCells, "a thread per pixel row of each level-1 cell");
  __shared__ __align__(16) Tin rows[2][2 * kPyramidCells * 48];  // 12 KB at uint8, 48 KB at float32
  asm volatile("griddepcontrol.launch_dependents;");
  STAMP(0, 0);
  const int H1 = Hs >> 1, W1 = Ws >> 1, H2 = H1 >> 1, W2 = W1 >> 1;
  const int chunks = (W1 + kPyramidCells - 1) / kPyramidCells;
  const int xb = (blockIdx.x % chunks) * kPyramidCells;
  const int y1 = (blockIdx.x / chunks) % H1, c = blockIdx.x / (chunks * H1);
  const int ncells = min(kPyramidCells, W1 - xb);
  constexpr int kVec = 16 / sizeof(Tin);  // values a 16-byte piece
  const int per_row = 2 * ncells * 48 / kVec;
  for (int i = threadIdx.x; i < 2 * per_row; i += kThreads) {  // all of a thread's copies in flight at once
    const int r = i >= per_row ? 1 : 0, k = i - r * per_row;
    const Tin* src = in + ((static_cast<long long>(c) * Hs + 2 * y1 + r) * Ws + 2 * xb) * 48;
    cp_async<16>(reinterpret_cast<uint4*>(rows[r]) + k, reinterpret_cast<const uint4*>(src) + k);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  STAMP(0, 1);

  const int xi = threadIdx.x >> 2, a = threadIdx.x & 3;
  const bool live = xi < ncells;
  const int x1 = xb + xi;
  float o[12] = {};  // pixel row a of the level-1 cell, 4 pixels x 3 colours, rounded to D
  if (live) {
#pragma unroll
    for (int qx = 0; qx < 2; ++qx) {
      float v[24];  // pixel rows 2(a&1) (values 0..11) and 2(a&1)+1 (12..23) of the level-0 cell
      load_run24<Tin, D>(rows[a >> 1] + (2 * xi + qx) * 48 + (a & 1) * 24, v);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int col = 0; col < 3; ++col) {
          const int p = 6 * b + col;  // level-0 pixel 2b of the run's top row
          o[(2 * qx + b) * 3 + col] = mean4<D>(v[p], v[p + 3], v[p + 12], v[p + 15]);
        }
      }
    }
    store_run<12>(l1 + ((static_cast<long long>(c) * H1 + y1) * W1 + x1) * 48 + a * 12, o);
  }
  float up[12];  // the row above (from the lane below; meaningful for odd a)
#pragma unroll
  for (int k = 0; k < 12; ++k) up[k] = __shfl_up_sync(0xffffffffu, o[k], 1);
  if (live && (a & 1) && l2 != nullptr && (y1 >> 1) < H2 && (x1 >> 1) < W2) {
    float q[6];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        const int p = 6 * m + col;
        q[3 * m + col] = mean4<D>(up[p], up[p + 3], o[p], o[p + 3]);
      }
    }
    D* o2 = l2 + ((static_cast<long long>(c) * H2 + (y1 >> 1)) * W2 + (x1 >> 1)) * 48 +
            ((2 * (y1 & 1) + (a >> 1)) * 4 + 2 * (x1 & 1)) * 3;
    store_run<6>(o2, q);
  }
  STAMP(0, 2);
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
  int checks;                // 1 unless no staged value nor difference can be near zero (see normalize_rows)
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
// clamped into it) and the two weights, rounded to D, zero where the tap lies
// outside the window or outside the level. Positions are monotone in the
// output index, and so are both indices.
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
// are divided (normalize_rows sends a piece holding one to normalized()).
template <typename D>
__device__ __forceinline__ float quotient(float v, float d, float inv_d) {
  if (std::is_same<D, float>::value || fabsf(v) < 1e-30f) return round_to<D>(__fdiv_rn(v, d));
  return round_to<D>(__fmul_rn(v, inv_d));
}

__device__ __forceinline__ float pick3(const float (&x)[3], int k) { return k == 0 ? x[0] : k == 1 ? x[1] : x[2]; }

template <typename D>
__device__ __forceinline__ float normalized(float v, int col, const SampleArgs& a) {
  v = quotient<D>(v, 255.0f, a.inv255);
  v = round_to<D>(__fsub_rn(v, pick3(a.mean, col)));
  return quotient<D>(v, pick3(a.stdev, col), pick3(a.inv_std, col));
}

// Staging a block's rows. A run is the 12 values of one pixel row of one
// cell (4 pixels x 3 colours); a staged row is the runs of the staged cells,
// one after the other, so pixel c of a staged row is its values 3c .. 3c+2.
// Thread t < 255 takes piece t % 3 (values 4(t%3) .. 4(t%3)+3) of the run of
// cell t/3 (and t/3 + 85, ...) in every staged row: consecutive lanes copy
// consecutive pieces, and a thread's pieces hold the same colours.
//
// normalize_rows: the copied values rounded to D and, with a.normalize,
// normalized as normalized() does, stored as D at the same places of `out`
// (which may be `in`). With a.checks, a piece holding a value, or a
// difference, that is not 0 but below 1e-30 in magnitude goes through
// normalized() itself (see quotient()). The launcher clears a.checks for
// uint8 frames, whose levels hold 0 or at least 2^-14 (means of 4^k
// integers), and means of 0 or at least 2^-30 in magnitude. Then, at
// bfloat16, the values are normalized in pairs: the two products rounded
// and packed by one instruction (cvt.rn.bf16x2.f32), the mean subtracted by
// one (sub.bf16x2, the difference rounded once). That is the bfloat16 of
// the float32 difference: it is exact in float32 unless q is below 2^-16 of
// the mean, and then both round to the mean.
template <typename T, typename D>
__device__ __forceinline__ void normalize_rows(const T* in, D* out, int pitch, int ncells, int nstaged,
                                               const SampleArgs& a) {
  const int t = threadIdx.x;
  if (t >= 255) return;
  const int ch = t % 3;
  int col[4];
  float mean[4], inv_std[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    col[k] = (4 * ch + k) % 3;
    mean[k] = pick3(a.mean, col[k]);
    inv_std[k] = pick3(a.inv_std, col[k]);
  }
  const __nv_bfloat162 mean01 = __floats2bfloat162_rn(mean[0], mean[1]);  // exact: the means are of D
  const __nv_bfloat162 mean23 = __floats2bfloat162_rn(mean[2], mean[3]);
  const bool paired = std::is_same<D, __nv_bfloat16>::value && a.normalize && !a.checks;
  for (int cx = t / 3; cx < ncells; cx += 85) {
#pragma unroll 4
    for (int s = 0; s < nstaged; ++s) {
      const int i = s * pitch + cx * 12 + ch * 4;
      float v[4], q[4];
      load4<T, D>(in + i, v);
      if (paired) {
        uint32_t w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 d = __hsub2(
              __floats2bfloat162_rn(__fmul_rn(v[2 * h], a.inv255), __fmul_rn(v[2 * h + 1], a.inv255)),
              h ? mean23 : mean01);
          const uint32_t u = *reinterpret_cast<const uint32_t*>(&d);
          const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(bf16_lo(u), inv_std[2 * h]),
                                                         __fmul_rn(bf16_hi(u), inv_std[2 * h + 1]));
          w[h] = *reinterpret_cast<const uint32_t*>(&r);
        }
        *reinterpret_cast<uint2*>(out + i) = make_uint2(w[0], w[1]);
        continue;
      }
      if (a.normalize) {
        uint32_t least = 0xffffffffu;  // the least of |x| - 1 as unsigned bits: 0 is the largest
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          least = min(least, (__float_as_uint(v[k]) & 0x7fffffffu) - 1u);
          q[k] = round_to<D>(__fsub_rn(round_to<D>(__fmul_rn(v[k], a.inv255)), mean[k]));
          least = min(least, (__float_as_uint(q[k]) & 0x7fffffffu) - 1u);
          q[k] = round_to<D>(__fmul_rn(q[k], inv_std[k]));
        }
        if (!std::is_same<D, __nv_bfloat16>::value || (a.checks && least < __float_as_uint(1e-30f) - 1u)) {
#pragma unroll
          for (int k = 0; k < 4; ++k) q[k] = normalized<D>(v[k], col[k], a);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = v[k];
      }
      store4(out + i, q);
    }
  }
}

// stage_rows: every piece an asynchronous copy into `copied`, all of a
// thread's in flight at once; then, when `convert`, each thread rounds and
// normalizes the pieces it copied itself into `stage` (no barrier needed).
// (Converting the first half of the rows while the second is on its way was
// measured: no faster; the copies decide, at ~1.5 sectors of 32 bytes for
// each 24-byte run.)
template <typename T, typename D>
__device__ __forceinline__ void stage_rows(const T* lvl, const int* row_src, T* copied, D* stage, int pitch,
                                           int ncells, int nstaged, bool convert, const SampleArgs& a) {
  const int t = threadIdx.x;
  if (t >= 255) return;
  const int ch = t % 3;
  for (int cx = t / 3; cx < ncells; cx += 85) {
    for (int s = 0; s < nstaged; ++s) {
      cp_async<4 * sizeof(T)>(copied + s * pitch + cx * 12 + ch * 4, lvl + row_src[s] + cx * 48 + ch * 4);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (convert) normalize_rows<T, D>(copied, stage, pitch, ncells, nstaged, a);
}

// the three values of pixel c of a staged row of D
__device__ __forceinline__ void staged_px(const float* row, int c, float (&v)[3]) {
  v[0] = row[3 * c]; v[1] = row[3 * c + 1]; v[2] = row[3 * c + 2];
}
__device__ __forceinline__ void staged_px(const __nv_bfloat16* row, int c, float (&v)[3]) {
  // values 3c .. 3c+2 from the two aligned words that hold them
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + ((3 * c) >> 1);
  const uint32_t w0 = w[0], w1 = w[1];
  const bool odd = c & 1;
  v[0] = odd ? bf16_hi(w0) : bf16_lo(w0);
  v[1] = odd ? bf16_lo(w1) : bf16_hi(w0);
  v[2] = odd ? bf16_hi(w1) : bf16_lo(w1);
}

template <typename Tin, typename D>
__global__ void __launch_bounds__(kThreads, 4) sample_kernel(const SampleArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.S, S4 = (S + 3) & ~3;
  int* col_s0 = reinterpret_cast<int*>(smem);       // staged pixel of each column's first tap
  int* col_s1 = col_s0 + S4;                        // and of its second
  float* col_w0 = reinterpret_cast<float*>(col_s1 + S4);
  float* col_w1 = col_w0 + S4;
  int* row_src = reinterpret_cast<int*>(col_w1 + S4);  // element offset of each staged row's runs
  float* row_w = reinterpret_cast<float*>(row_src + 2 * kTileRows);
  const int pitch = stage_pitch(a.win_cells);
  Tin* copied = reinterpret_cast<Tin*>(row_w + 2 * kTileRows);  // [2*kTileRows][pitch]: level 0 as copied
  D* stage = reinterpret_cast<D*>(copied + 2 * kTileRows * pitch);  // [2*kTileRows][pitch]: what the taps read

  STAMP(1, 0);
  const int t = threadIdx.x;
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

  // the staged columns: those the taps touch (the two ends of the column
  // table, indices being monotone) inside the window and the level, whole
  // cells from cell_lo; every tap is clamped into [lo, hi], which moves only
  // taps of weight zero
  int lo, hi;
  {
    int e0, e1, f0, f1;
    float w;
    taps<D>(sample_pos(x1l, step_x, 0, max_x), ax_x, win_px, &e0, &e1, &w, &w);
    taps<D>(sample_pos(x1l, step_x, S - 1, max_x), ax_x, win_px, &f0, &f1, &w, &w);
    lo = max(min(e0, f0), ax_x.origin_px);
    hi = min(max(e1, f1), min(ax_x.origin_px + win_px, ax_x.valid_px) - 1);
  }
  const int cell_lo = lo >> 2, ncells = (hi >> 2) - cell_lo + 1;  // <= win_cells

  for (int j = t; j < S4; j += kThreads) {
    int i0 = 0, i1 = 0;
    float w0 = 0.0f, w1 = 0.0f;
    if (j < S) taps<D>(sample_pos(x1l, step_x, j, max_x), ax_x, win_px, &i0, &i1, &w0, &w1);
    col_s0[j] = j < S ? min(max(i0, lo), hi) - 4 * cell_lo : 0;
    col_s1[j] = j < S ? min(max(i1, lo), hi) - 4 * cell_lo : 0;
    col_w0[j] = w0;
    col_w1[j] = w1;
  }
  if (t < 2 * nrows) {  // staged row t: the first (even t) or second tap of output row t/2
    int i0, i1;
    float w0, w1;
    taps<D>(sample_pos(y1l, step_y, first_row + (t >> 1), max_y), ax_y, win_px, &i0, &i1, &w0, &w1);
    const int y = (t & 1) ? i1 : i0;
    row_src[t] = ((y >> 2) * wl + cell_lo) * 48 + (y & 3) * 12;  // below 2^31: the wrapper checks the frames' size
    row_w[t] = (t & 1) ? w1 : w0;
  }
  __syncthreads();
  STAMP(1, 1);

  const int cam = min(max(a.cam_idx[b], 0), a.C - 1);
  const long long cam_base = static_cast<long long>(cam) * hl * wl * 48;
  if (level == 0) {
    STAMP(1, 2);
    stage_rows<Tin, D>(static_cast<const Tin*>(a.frames) + cam_base, row_src, copied, stage, pitch, ncells,
                       2 * nrows, true, a);
  } else {
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the pyramid is complete and visible
    STAMP(1, 2);
    stage_rows<D, D>(static_cast<const D*>(a.pyramid) + a.level_offset[level] + cam_base, row_src, stage, stage,
                     pitch, ncells, 2 * nrows, a.normalize, a);  // normalized in place
  }
  __syncthreads();
  STAMP(1, 3);

  // a thread per (output row, four consecutive columns); in the s2d layout
  // the four rows of a cell row are the fastest index, so a warp writes whole
  // output cells
  const int G = S4 >> 2;
  float* crop = a.out + static_cast<long long>(b) * S * S * 3;
  for (int i = t; i < nrows * G; i += kThreads) {
    int r, g;
    if (a.layout == kS2d) {  // nrows is a multiple of 4 there
      r = (i & 3) + ((i >> 2) / G) * 4;
      g = (i >> 2) % G;
    } else {
      r = i / G;
      g = i - r * G;
    }
    const D* p0 = stage + 2 * r * pitch;
    const D* p1 = p0 + pitch;
    const float wy0 = row_w[2 * r], wy1 = row_w[2 * r + 1];
    const int4 s0 = reinterpret_cast<const int4*>(col_s0)[g];
    const int4 s1 = reinterpret_cast<const int4*>(col_s1)[g];
    const float4 w0 = reinterpret_cast<const float4*>(col_w0)[g];
    const float4 w1 = reinterpret_cast<const float4*>(col_w1)[g];
    const int c0[4] = {s0.x, s0.y, s0.z, s0.w}, c1[4] = {s1.x, s1.y, s1.z, s1.w};
    const float wx0[4] = {w0.x, w0.y, w0.z, w0.w}, wx1[4] = {w1.x, w1.y, w1.z, w1.w};
    float res[12];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v00[3], v01[3], v10[3], v11[3];
      staged_px(p0, c0[q], v00);
      staged_px(p0, c1[q], v01);
      staged_px(p1, c0[q], v10);
      staged_px(p1, c1[q], v11);
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        // row product (over y) at the two columns, rounded to D; then the column product
        const float ta = round_to<D>(__fmaf_rn(wy0, v00[col], __fmul_rn(wy1, v10[col])));
        const float tb = round_to<D>(__fmaf_rn(wy0, v01[col], __fmul_rn(wy1, v11[col])));
        res[3 * q + col] = __fmaf_rn(wx0[q], ta, __fmul_rn(wx1[q], tb));
      }
    }
    const int row = first_row + r, j0 = 4 * g;
    if (a.layout == kS2d) {
      float4* o = reinterpret_cast<float4*>(crop + ((row >> 2) * (S >> 2) + g) * 48 + (row & 3) * 12);
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = make_float4(res[4 * k], res[4 * k + 1], res[4 * k + 2], res[4 * k + 3]);
    } else if (a.layout == kHwc) {
      float* o = crop + (row * S + j0) * 3;
      if ((S & 3) == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          reinterpret_cast<float4*>(o)[k] = make_float4(res[4 * k], res[4 * k + 1], res[4 * k + 2], res[4 * k + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 12; ++e) {
          if (e < 3 * (S - j0)) o[e] = res[e];
        }
      }
    } else {
      float* o = crop + row * S + j0;
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        float* oc = o + col * S * S;
        if ((S & 3) == 0) {
          *reinterpret_cast<float4*>(oc) = make_float4(res[col], res[3 + col], res[6 + col], res[9 + col]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < S - j0) oc[q] = res[3 * q + col];
          }
        }
      }
    }
  }
  // a block of level 0 ends after the pyramid too, so that the work after
  // this kernel on the stream finds the pyramid finished
  STAMP(1, 4);
  if (level == 0) asm volatile("griddepcontrol.wait;" ::: "memory");
  STAMP(1, 5);
}

template <typename Tin, typename D>
int launch_all(const SampleArgs& a, int n, int shared_bytes, cudaStream_t stream) {
  D* pyr = static_cast<D*>(const_cast<void*>(a.pyramid));
  if (a.n_levels > 1) {  // levels 1 and 2 in one pass over the frames, a block per kPyramidCells level-1 cells
    const long long blocks =
        static_cast<long long>(a.C) * (a.Hs >> 1) * (((a.Ws >> 1) + kPyramidCells - 1) / kPyramidCells);
    pyramid_kernel<Tin, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
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
  void (*kernel)(const SampleArgs) = sample_kernel<Tin, D>;
  if (shared_bytes > 48 * 1024) {  // above the default, set for this instantiation on the current device
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = a.n_levels > 1;  // overlap the pyramid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * a.tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Builds the pyramid and samples the crops on `stream`; returns the
// cudaError_t of the first launch that failed (0 = cudaSuccess).
// frames_u8: frames are uint8 (else float32), starting on a 16-byte boundary.
// dtype_bf16: the compute type is
// bfloat16 (else float32); `pyramid` holds levels 1.. in that type at
// level_offset[k] elements. norm6: mean[3] then std[3], rounded to the type.
// shared_bytes: the sampling kernel's dynamic shared memory as
// ops/crop_mxu.py::launch_plan computed it; refused unless it is this file's.
int crop_resize_s2d(const void* frames, void* pyramid, const long long* level_offset,
                    const void* boxes, const void* cam_idx, void* out, int C, int Hs, int Ws,
                    int n, int S, int win_cells, int n_levels, int layout, int frames_u8,
                    int dtype_bf16, int normalize, int shared_bytes, const float* norm6, void* stream) {
  if (n < 1 || S < 1 || S > kMaxOutSize || n_levels < 1 || n_levels > kMaxLevels ||
      win_cells < 1 || layout < 0 || layout > 2 || (Hs >> (n_levels - 1)) < 1 ||
      (Ws >> (n_levels - 1)) < 1 || (layout == kS2d && (S & 3)) ||
      shared_bytes != sample_shared_bytes(S, win_cells, dtype_bf16 ? 2 : 4, frames_u8 ? 1 : 4) ||
      shared_bytes > kMaxSharedBytes) {
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
  a.checks = frames_u8 ? 0 : 1;
  for (int k = 0; k < 3; ++k) {
    a.mean[k] = norm6[k];
    a.stdev[k] = norm6[3 + k];
    a.inv_std[k] = 1.0f / norm6[3 + k];
    if (norm6[k] != 0.0f && std::fabs(norm6[k]) < 0x1p-30f) a.checks = 1;
  }
  if (static_cast<long long>(n) * a.tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (frames_u8) {
    return dtype_bf16 ? launch_all<uint8_t, __nv_bfloat16>(a, n, shared_bytes, s)
                      : launch_all<uint8_t, float>(a, n, shared_bytes, s);
  }
  return dtype_bf16 ? launch_all<float, __nv_bfloat16>(a, n, shared_bytes, s)
                    : launch_all<float, float>(a, n, shared_bytes, s);
}

#ifdef CROP_S2D_TIMING
int crop_s2d_read_stamps(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, crop_s2d_stamps, sizeof(crop_s2d_stamps)));
}
#endif

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
