// int8 x int8 -> int32 NHWC convolution with a fused dequantize epilogue for
// Hopper (sm_90a), plain C interface.
//
// Replaces the device op that playground3d_tpu/models/quant.py builds inside
// _chain_qconv / _chain_qconv_b (and quant_conv_bn / quant_conv): an int8
// jax.lax.conv_general_dilated with an int32 result, which XLA lowers to the
// TPU's matrix unit, followed by array ops for "multiply by the per-channel
// scale, add the offset or bias, relu, then requantize for the consumer or
// cast to bfloat16". Here that is one kernel:
//
//   acc[m][c] = sum over taps and input channels of x * w        (int32, exact)
//   v = float(acc) * scale[c]; v = v + offset[c]; v = max(v, 0)   (each rounded)
//   store int32 acc | bfloat16(v) | int8(clip(rint(v / *emit_xs), -127, 127))
//
// x is [N,H,W,Cin] int8, w is [Cout,k,k,Cin] int8 (k = 1 or 3), stride 1 or
// 2, "SAME" padding given as the pad before the first row and column. The
// epilogue's operations are those of ops/qconv.py::epilogue_plain in the same
// order, so int8 and bfloat16 outputs agree with the plain version exactly.
//
// Bound on this card: operations for the wide layers (2 * MACs against the
// int8 tensor-core rate), bytes for the narrow ones. The kernel is an
// implicit GEMM on the tensor cores through mma.sync (m16n8k32, int8 in,
// int32 out): M = N*Ho*Wo output pixels, N = Cout, K = k*k*Cin.
//
//  * A block of 8 warps owns a 128 x TN output tile, TN = 128 where the
//    layer has more than 64 filters, else 64. A warp owns 32 x TN/2 of it:
//    two 16-row by TN/16 8-column mma tiles, accumulators in registers.
//  * K advances one kernel tap and 64 input channels at a time. The threads
//    copy the 128 x 64 and TN x 64 byte operand tiles to shared memory as
//    16-byte cp.async pieces, zero-filled where the tap falls into the
//    padding or past the last pixel, channel or filter. Shared memory holds
//    three such stages (61 KB, so three blocks fit an SM), the copies of two
//    steps are in flight while one is multiplied, and a step has one
//    barrier. (128 channels a step in four stages, 147 KB and one block an
//    SM, was measured slower on the wide layers and no faster on the small.)
//  * Operand rows are 64 bytes of data padded to 80: the eight 16-byte rows
//    that one ldmatrix phase reads then fall into distinct banks. One
//    ldmatrix.x4 yields the four registers of an A tile, or the two registers
//    of two neighbouring B tiles (B is stored [filter][k], the "col" operand).
//
// What holds it back on an H100 (PERF.md section 6 has the numbers): the
// 128 x 128 tile re-reads its operands from L2 once per tile on the other
// axis (64 MACs per byte), which bounds the wide layers at about a quarter
// of mma.sync's own int8 peak (1,295 TOPS measured); layers with few output
// pixels occupy a handful of SMs and stream K at one block's pace (0.55 us
// a step). Larger tiles on wgmma and split K are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 128;   // TILE_M of ops/qconv.py
constexpr int kTileNarrow = 64;   // TILE_N_NARROW: filters per block for layers of up to 64 filters
constexpr int kTileWide = 128;    // TILE_N_WIDE: for wider layers
constexpr int kTileK = 64;     // TILE_K: int8 values per step
constexpr int kPieces = kTileK / 16;           // 16-byte pieces of data per operand row
constexpr int kRowPieces = kPieces + 1;        // and one of padding
constexpr int kCopyRows = kThreads / kPieces;  // rows the block copies in one pass, a piece a thread
constexpr int kStages = 3;     // STAGES: operand tiles in shared memory

enum Store { kAcc = 0, kBf16 = 1, kInt8 = 2 };

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* offset;   // may be null
  const float* emit_xs;  // one float on the device; read when store == kInt8
  void* out;
  int N, H, W, Cin, Cout, k, stride, Ho, Wo, pad_t, pad_l, relu, store;
};

// four 8 x 16-byte matrices from shared memory, one row address per lane
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t smem_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr));
}

// 16 bytes from global to shared memory without passing through registers;
// with `bytes` = 0 nothing is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async_16(uint32_t smem_addr, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

// c += a (16 x 32 int8, row-major) * b (32 x 8 int8, column-major), int32
__device__ __forceinline__ void mma_m16n8k32_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(rint(fl(v / xs)), -127, 127), rint to even: the int8 value at scale xs.
// The exactly rounded division is a routine of some forty dependent
// instructions, and an epilogue holds 64 of them a thread, so it is kept for
// the values that need it. With inv_xs = fl(1 / xs), q = fl(v * inv_xs) lies
// within 2^-23 |v / xs| of the true quotient, and so does t = fl(v / xs)
// within 2^-24 of it: |q - t| < 2.3e-5 wherever |v / xs| <= 128. So if
// |q| >= 126.75 then |t| > 126.5 and the clipped result is +-127; else if q is
// further than 1e-4 from the nearest half-integer, t lies on the same side of
// it and rint(q) = rint(t). Only the one value in five thousand that is
// closer takes the division.
__device__ __forceinline__ float requantized(float v, float xs, float inv_xs) {
  const float q = __fmul_rn(v, inv_xs);
  if (fabsf(q) >= 126.75f) return copysignf(127.0f, q);
  const float n = rintf(q);
  if (fabsf(__fsub_rn(q, n)) <= 0.4999f) return n;
  return fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.0f), 127.0f);
}

template <int TN>
__global__ void __launch_bounds__(kThreads) qconv_kernel(const Args a) {
  constexpr int kARows = kTileM / kCopyRows;  // rows of A a thread copies per step
  constexpr int kBRows = TN / kCopyRows;      // rows of B
  constexpr int kNTiles = TN / 16;   // 8-column mma tiles of a warp
  // dynamic shared memory: kStages stages of A [128][kRowPieces] then of B [TN][kRowPieces], in 16-byte pieces
  extern __shared__ int4 smem[];
  constexpr uint32_t kRowBytes = kRowPieces * 16;
  constexpr uint32_t kAStage = kTileM * kRowBytes, kBStage = TN * kRowBytes;
  const uint32_t a_smem = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t b_smem = a_smem + kStages * kAStage;

  const int t = threadIdx.x;
  const int M = a.N * a.Ho * a.Wo;  // output pixels; below 2^31 (the launcher checks)
  const int m0 = blockIdx.x * kTileM;
  const int c0 = blockIdx.y * TN;

  // What this thread copies each step: piece q of rows r, r + kCopyRows, ... of A
  // and of B. Everything that does not change from step to step is worked
  // out here, once: per row of A the address of its pixel at tap (0, 0) and a
  // bit per tap that falls inside the image; per row of B the address of its
  // filter. A step then adds one offset, common to all rows, and tests a bit.
  const int r = t / kPieces, q = t % kPieces;
  const int taps = a.k * a.k;
  const int8_t* xrow[kARows];
  uint32_t tap_ok[kARows];
#pragma unroll
  for (int h = 0; h < kARows; ++h) {
    const int m = m0 + r + kCopyRows * h;
    const bool live = m < M;
    const int mm = live ? m : 0;
    const int n = mm / (a.Ho * a.Wo);
    const int rem = mm - n * a.Ho * a.Wo;
    const int oy = rem / a.Wo, ox = rem - oy * a.Wo;
    const int iy0 = oy * a.stride - a.pad_t, ix0 = ox * a.stride - a.pad_l;
    xrow[h] = a.x + ((static_cast<long long>(n) * a.H + iy0) * a.W + ix0) * a.Cin + q * 16;
    uint32_t bits = 0;
    for (int ky = 0, tap = 0; ky < a.k; ++ky) {
      for (int kx = 0; kx < a.k; ++kx, ++tap) {
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (live && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) bits |= 1u << tap;
      }
    }
    tap_ok[h] = bits;
  }
  const int8_t* wrow[kBRows];
  uint32_t filter_ok = 0;
#pragma unroll
  for (int h = 0; h < kBRows; ++h) {
    const int cout = c0 + r + kCopyRows * h;
    if (cout < a.Cout) filter_ok |= 1u << h;
    wrow[h] = a.w + static_cast<long long>(min(cout, a.Cout - 1)) * taps * a.Cin + q * 16;
  }
  const uint32_t a_dst = a_smem + r * kRowBytes + q * 16, b_dst = b_smem + r * kRowBytes + q * 16;

  const int chunks = (a.Cin + kTileK - 1) / kTileK;
  const int steps = taps * chunks;

  // Start the copies of the next step not yet started into its stage, walking
  // (tap, chunk) along; past the last step only the (empty) group is committed,
  // so that the count of pending groups stays uniform.
  int next = 0, next_tap = 0, next_ky = 0, next_kx = 0, next_chunk = 0, next_stage = 0;
  auto prefetch = [&]() {
    if (next < steps) {
      const int cq = next_chunk * kTileK;  // first channel of this step; this thread's piece starts q * 16 on
      const bool cin_ok = cq + q * 16 < a.Cin;
      const long long x_off = (static_cast<long long>(next_ky) * a.W + next_kx) * a.Cin + cq;
      const long long w_off = static_cast<long long>(next_tap) * a.Cin + cq;
#pragma unroll
      for (int h = 0; h < kARows; ++h) {
        const bool ok = cin_ok && ((tap_ok[h] >> next_tap) & 1u);
        cp_async_16(a_dst + next_stage * kAStage + (kCopyRows * h) * kRowBytes, ok ? xrow[h] + x_off : a.x, ok ? 16 : 0);
      }
#pragma unroll
      for (int h = 0; h < kBRows; ++h) {
        const bool ok = cin_ok && ((filter_ok >> h) & 1u);
        cp_async_16(b_dst + next_stage * kBStage + (kCopyRows * h) * kRowBytes, ok ? wrow[h] + w_off : a.w, ok ? 16 : 0);
      }
      ++next;
      if (++next_chunk == chunks) {
        next_chunk = 0;
        ++next_tap;
        if (++next_kx == a.k) {
          next_kx = 0;
          ++next_ky;
        }
      }
      if (++next_stage == kStages) next_stage = 0;
    }
    cp_async_commit();
  };

  // warp tile 32 x TN/2 of the block's 128 x TN
  const int warp = t >> 5, lane = t & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * (TN / 2);
  int acc[2][kNTiles][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix addresses: lanes 0-7, 8-15, 16-23, 24-31 name the rows of the
  // four 8 x 16-byte matrices of one x4 load. For A those are (rows 0-7,
  // bytes 0-15), (rows 8-15, bytes 0-15), (rows 0-7, bytes 16-31), (rows
  // 8-15, bytes 16-31) of a 16 x 32 tile: the registers a0..a3 of the mma.
  // For B they are (filters 0-7, bytes 0-15), (0-7, 16-31), (8-15, 0-15),
  // (8-15, 16-31): b0, b1 of two neighbouring 8-column tiles.
  const int lrow = lane & 7, lmat = lane >> 3;
  const uint32_t a_base = a_smem + (wm + lrow + 8 * (lmat & 1)) * kRowBytes + (lmat >> 1) * 16;
  const uint32_t b_base = b_smem + (wn + lrow + 8 * (lmat >> 1)) * kRowBytes + (lmat & 1) * 16;

#pragma unroll
  for (int s0 = 0; s0 < kStages - 1; ++s0) prefetch();
  int stage = 0;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's copies have landed (this thread's)
    __syncthreads();               // ... everyone's; and the stage refilled below is no longer read
    // (QCONV_SKIP_COPIES / QCONV_SKIP_MMA compile a part of the step out, for
    // scripts/qconv_step_cost.cu, which times what is left; results are wrong then)
#ifndef QCONV_SKIP_COPIES
    prefetch();
#else
    cp_async_commit();
#endif
#ifndef QCONV_SKIP_MMA
#pragma unroll
    for (int ks = 0; ks < kTileK / 32; ++ks) {  // 32 bytes of K at a time
      uint32_t af[2][4], bf[kNTiles / 2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(af[i], a_base + stage * kAStage + (16 * i) * kRowBytes + 32 * ks);
      }
#pragma unroll
      for (int j = 0; j < kNTiles / 2; ++j) {
        ldmatrix_x4(bf[j], b_base + stage * kBStage + (16 * j) * kRowBytes + 32 * ks);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          mma_m16n8k32_s8(acc[i][j], af[i], bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
        }
      }
    }
#endif
    if (++stage == kStages) stage = 0;
  }

  // epilogue: ops/qconv.py::epilogue_plain, operation for operation. An mma
  // tile leaves rows g and g + 8, columns 2 * tg and 2 * tg + 1 in a lane; the
  // two neighbouring columns go out in one store where the layer's filter
  // count is even (then the pair is aligned). Staging the tile in shared
  // memory to store whole 16-byte pieces of a row was built and measured: no
  // faster (PERF.md), so the fragments are stored as they are.
  const float xs = a.store == kInt8 ? __ldg(a.emit_xs) : 1.0f;
  const float inv_xs = __frcp_rn(xs);
  const int g = lane >> 2, tg = lane & 3;
  const bool pairs = (a.Cout & 1) == 0;
  auto finish = [&](int sum, float sc, float of) -> float {
    float v = __fmul_rn(static_cast<float>(sum), sc);
    if (a.offset != nullptr) v = __fadd_rn(v, of);
    if (a.relu) v = fmaxf(v, 0.0f);
    return a.store == kInt8 ? requantized(v, xs, inv_xs) : v;
  };
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    // past the layer's last filter or pixel: computed on clamped indices, never stored
    const int c = c0 + wn + 8 * j + 2 * tg;
    const bool first = c < a.Cout, second = c + 1 < a.Cout;
    const int ca = min(c, a.Cout - 1), cb = min(c + 1, a.Cout - 1);
    const float sc0 = __ldg(a.scale + ca), sc1 = __ldg(a.scale + cb);
    const float of0 = a.offset != nullptr ? __ldg(a.offset + ca) : 0.0f;
    const float of1 = a.offset != nullptr ? __ldg(a.offset + cb) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e0 = 0; e0 < 2; ++e0) {
        const int m = m0 + wm + 16 * i + g + 8 * e0;
        const bool row = m < M && first;
        const long long o = static_cast<long long>(m) * a.Cout + c;
        const int s0 = acc[i][j][2 * e0], s1 = acc[i][j][2 * e0 + 1];
        if (a.store == kAcc) {
          if (row) static_cast<int*>(a.out)[o] = s0;
          if (row && second) static_cast<int*>(a.out)[o + 1] = s1;
          continue;
        }
        const float v0 = finish(s0, sc0, of0), v1 = finish(s1, sc1, of1);
        if (a.store == kBf16) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + o;
          if (row && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
          } else if (row) {
            out[0] = __float2bfloat16_rn(v0);
            if (second) out[1] = __float2bfloat16_rn(v1);
          }
        } else {
          int8_t* out = static_cast<int8_t*>(a.out) + o;
          const int q0 = static_cast<int>(v0), q1 = static_cast<int>(v1);
          if (row && pairs) {
            *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>((q0 & 255) | ((q1 & 255) << 8));
          } else if (row) {
            out[0] = static_cast<int8_t>(q0);
            if (second) out[1] = static_cast<int8_t>(q1);
          }
        }
      }
    }
  }
}

template <int TN>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem_bytes = kStages * (kTileM + TN) * kRowPieces * 16;  // 61,440 or 46,080
  static bool raised = false;  // above the 48 KB a kernel may use without asking
  if (smem_bytes > 48 * 1024 && !raised) {
    const cudaError_t err =
        cudaFuncSetAttribute(qconv_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  qconv_kernel<TN><<<grid, kThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess). The wrapper
// (ops/qconv.py) checks types, contiguity and the 16-byte alignment of x and
// w; Cin is a multiple of 16.
int qconv(const void* x, const void* w, const void* scale, const void* offset, const void* emit_xs,
          void* out, int N, int H, int W, int Cin, int Cout, int k, int stride, int Ho, int Wo,
          int pad_t, int pad_l, int relu, int store, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cout < 1 || Cin < 16 || (Cin & 15) || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || store < 0 || store > 2 || (store == kInt8 && emit_xs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.emit_xs = static_cast<const float*>(emit_xs);
  a.out = out;
  a.N = N; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.k = k; a.stride = stride;
  a.Ho = Ho; a.Wo = Wo; a.pad_t = pad_t; a.pad_l = pad_l; a.relu = relu; a.store = store;
  const long long M = static_cast<long long>(N) * Ho * Wo;
  if (M > 2147483647LL - kTileM) return static_cast<int>(cudaErrorInvalidValue);
  const long long gx = (M + kTileM - 1) / kTileM;
  const int tn = Cout > kTileNarrow ? kTileWide : kTileNarrow;  // ops/qconv.py::launch_plan's rule
  const int gy = (Cout + tn - 1) / tn;
  if (gx > 2147483647LL || gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return tn == kTileWide ? launch<kTileWide>(a, grid, static_cast<cudaStream_t>(stream))
                         : launch<kTileNarrow>(a, grid, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
