// int8 x int8 -> int32 NHWC convolution with a fused dequantize epilogue for
// Hopper (sm_90a), plain C interface.
//
// Replaces the device op that playground3d_tpu/models/quant.py builds inside
// _chain_qconv / _chain_qconv_b (and quant_conv_bn / quant_conv): an int8
// jax.lax.conv_general_dilated with an int32 result, which XLA lowers to the
// TPU's matrix unit, followed by array ops for "multiply by the per-channel
// scale, add the offset or bias, relu, then requantize for the consumer or
// cast to bfloat16", and, for the last conv of a ResNet block, the block's
// residual add, relu and requantize (quant.py's `block`). Here that is one
// kernel:
//
//   acc[m][c] = sum over taps and input channels of x * w        (int32, exact)
//   v = float(acc) * scale[c]; v = v + offset[c]; v = max(v, 0)   (each rounded)
//   with a residual r (int8 q at scale xs_r, or bfloat16):
//     r = bf16(float(q) * float(bf16(xs_r)))  or  r as it is
//     v = max(bf16(float(bf16(v)) + float(r)), 0)
//   store int32 acc | bfloat16(v) | int8(clip(rint(v / *emit_xs), -127, 127))
//
// x is [N,H,W,Cin] int8, w is [Cout,k,k,Cin] int8 (k = 1 or 3), stride 1 or
// 2, "SAME" padding given as the pad before the first row and column. The
// epilogue's operations are those of ops/qconv.py::epilogue_plain in the same
// order, so int8 and bfloat16 outputs agree with the plain version exactly.
//
// Bound on this card: operations for the wide layers (2 * MACs against the
// int8 tensor-core rate), bytes for the narrow ones. The kernel is an
// implicit GEMM, M = N*Ho*Wo output pixels, N = Cout, K = k*k*Cin, on
// Hopper's warpgroup tensor-core instruction:
//
//  * A block owns a 128 x TN output tile (TN = 256 for layers of more than
//    128 filters, else the narrowest of 48, 64, 80, 112, 128 that holds them:
//    the head output convs' 108 and 72 filters run at 112 and 80, the extra
//    columns zero and never stored). Three warpgroups: two consumers, each
//    issuing wgmma.m64nTNk32.s32.s8.s8 on 64 rows of the tile from shared
//    memory, accumulators in registers; one producer, which keeps four stages
//    of operands in flight and gives most of its registers to the consumers
//    (setmaxnreg).
//  * K advances one kernel tap and 128 input channels at a time: one
//    128-byte row per pixel and per filter, in the 128-byte swizzled layout
//    wgmma reads (both operands K-major, as 8-bit wgmma requires).
//  * B, the weights, comes by TMA: a 3-D tensor map over [Cout][taps][Cin],
//    encoded once per weight tensor and kept (libcuda's encoder is reached
//    through cudaGetDriverEntryPoint, so the library does not link libcuda);
//    channels past Cin and filters past Cout arrive as zeros.
//  * A is an implicit im2col of the activations: the producer warpgroup
//    gathers each pixel's 128 bytes of one tap with 16-byte cp.async into the
//    same swizzled layout, zero-filled where the tap falls into the padding
//    or past the last pixel or channel, from a table of the tile's rows that
//    all threads build first (a row a thread). TMA's im2col mode was not
//    used: the gather keeps one path for every stride, padding and batch of
//    small maps, and the K loop already runs at the wgmma rate (PERF.md).
//    Each stage has a "full" mbarrier (the TMA's bytes and the producers'
//    128 arrivals, each after its copies landed and a proxy fence) and an
//    "empty" one (one arrival per consumer warp once its wgmma read it).
//  * Small maps: when the tiles are too few to occupy the card, the K loop
//    (taps x channel chunks) is split across `splits` blocks of one tile
//    (grid z). Each adds its int32 partial tile into a workspace by TMA bulk
//    reductions (cp.reduce.async.bulk .add.s32, a row a thread); the last to
//    arrive (an atomic counter per tile) takes the sums, zeroes the
//    workspace and its counter for the next call, and runs the epilogue.
//    Integer addition is exact in any order, and |acc| <= 3*3*2048 * 127 *
//    127 < 2^31. One launch per conv either way. ops/qconv.py::launch_plan
//    chooses TN and the split from the shapes.
//  * The epilogue parks the accumulators in an int32 tile in shared memory
//    (the stages are free by then) and walks it by runs of 8 neighbouring
//    outputs of a row, a thread the same 8 columns in every row it takes:
//    its scales and offsets stay in registers, its residual runs are copied
//    to shared memory while the tile is parked, and output stores are whole
//    runs. The loop over rows is rolled: a block runs the epilogue once,
//    with two warps per scheduler, so code that does not stay in the
//    instruction cache, or that waits on a global load per row, costs it
//    tens of microseconds (PERF.md).

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "int8_round.cuh"  // requantize_guess, requantize_exact

namespace {

constexpr int kConsumers = 256;  // CONSUMERS of ops/qconv.py: two warpgroups, 64 tile rows each
constexpr int kThreads = 384;    // THREADS: and one producer warpgroup
constexpr int kProducers = kThreads - kConsumers;
constexpr int kTileM = 128;      // TILE_M: output pixels per block
constexpr int kTileK = 128;      // TILE_K: channels of one tap per step, one 128-byte swizzled row
constexpr int kStages = 4;       // STAGES: operand tiles in flight in shared memory
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // 128 * 56 + 256 * 224 <= 384 * 168
constexpr int kPitchPad = 8;     // PITCH_PAD: ints after each row of the epilogue's int32 tile, so that
                                 // the 8-byte writes of a half-warp fall on distinct banks
template <int TN>
constexpr int kPitch = TN + kPitchPad;
// dynamic shared memory: the operand stages, or the epilogue's int32 tile and
// residual tile (2 bytes a value at most) where those are larger; + room to
// align to 1,024 bytes
template <int TN>
constexpr int kSmemBytes = (kStages * (kTileM + TN) * kTileK > kTileM * kPitch<TN> * 4 + kTileM * TN * 2
                                ? kStages * (kTileM + TN) * kTileK
                                : kTileM * kPitch<TN> * 4 + kTileM * TN * 2) +
                           1024;

enum Store { kAcc = 0, kBf16 = 1, kInt8 = 2 };
enum Residual { kNoRes = 0, kResInt8 = 1, kResBf16 = 2 };

struct Args {
  const int8_t* x;
  const float* scale;
  const float* offset;   // may be null
  const float* emit_xs;  // one float on the device; read when store == kInt8
  const void* res;       // [M][Cout] int8 or bfloat16 when res_kind != kNoRes
  const float* res_xs;   // one float on the device; read when res_kind == kResInt8
  void* out;
  int* counters;  // one per tile, zero between calls (split K only)
  int* partials;  // kConsumers * TN / 2 per tile, zero between calls (split K only)
  int N, H, W, Cin, Cout, k, stride, Ho, Wo, pad_t, pad_l, relu, store, res_kind, splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and copies ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the tensor map to shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 16 bytes from global to shared memory; with `bytes` = 0 nothing is read and the 16 bytes are zero
__device__ __forceinline__ void cp_async_16(uint32_t smem_addr, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr), "l"(src), "r"(bytes) : "memory");
}
// 8 bytes from global to shared memory
__device__ __forceinline__ void cp_async_8(uint32_t smem_addr, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}
// makes this thread's writes to shared memory visible to wgmma's reads (another proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// ---- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzled
// layout: rows of 128 bytes, groups of 8 rows 1,024 bytes apart (the stride
// byte offset), the tile 1,024-byte aligned. The next 32 bytes of K are the
// same descriptor with its address 32 bytes on: desc + 2.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across the asm before it
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 x N int32, the warpgroup's fragment) += a (64 x 32 int8) * b (32 x N int8),
// both operands in shared memory. One specialization per tile width.
template <int N>
struct Wgmma;

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void mma(int (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void mma(int (&d)[40], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<112> {
  __device__ __forceinline__ static void mma(int (&d)[56], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t a, uint64_t b) {
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
};

// ---- the epilogue's arithmetic ------------------------------------------------

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
// bf16_round of two values by one packed conversion (conversions issue at a quarter of the rate)
__device__ __forceinline__ void bf16_round2(float& u, float& v) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(u, v);
  u = __low2float(p);
  v = __high2float(p);
}

__device__ __forceinline__ void named_barrier_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// a run of 8 neighbouring values of one output row, as loaded and stored whole
union Run32 {
  int4 v[2];
  int i[8];
};
union Run16 {
  int4 v;
  uint16_t s[8];  // bfloat16 bits
};
union Run8 {
  uint2 v;
  int8_t b[8];
};

// ---- the kernel ----------------------------------------------------------------

#ifdef QCONV_TIMING
__device__ unsigned long long qconv_stamps[4096][16];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { const unsigned b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); if (b < 4096) qconv_stamps[b][i] = gtimer(); } while (0)
#else
#define STAMP(i) do {} while (0)
#endif

template <int TN>
__global__ void __launch_bounds__(kThreads, 1) qconv_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  constexpr int kNReg = TN / 2;  // accumulators a consumer thread holds
  constexpr uint32_t kAStage = kTileM * kTileK, kBStage = TN * kTileK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[kStages], then empty[kStages]
  __shared__ int last_arrival;
  __shared__ int row_off[kTileM];
  __shared__ uint32_t row_taps[kTileM];
  __shared__ float res_lut[kConsumers];  // an int8 residual's bfloat16 value by its byte
  static_assert(kConsumers == 256, "a consumer thread builds one entry of res_lut");
  const uint32_t tiles = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle needs 1,024-byte alignment
  const uint32_t a_smem = tiles, b_smem = tiles + kStages * kAStage;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * kTileM, c0 = blockIdx.y * TN;
  const int chunks = (a.Cin + kTileK - 1) / kTileK;
  const int steps = a.k * a.k * chunks;
  // this block's share of K, split blockIdx.z of a.splits (ops/qconv.py::split_range)
  const int s0 = static_cast<int>(static_cast<long long>(steps) * blockIdx.z / a.splits);
  const int s1 = static_cast<int>(static_cast<long long>(steps) * (blockIdx.z + 1) / a.splits);
  const int n_steps = s1 - s0;  // >= 1: the launcher keeps splits <= steps

  if (t == 0) STAMP(0);
  // the weights of the first stages go out before anything else: their
  // tensor map is fetched and their bytes travel while the rows are set up
  auto load_b = [&](int i) {
    const int s = s0 + i, tap = s / chunks, stage = i % kStages;
    mbar_arrive_expect_tx(full0 + 8 * stage, kBStage);
    tma_load_3d(b_smem + stage * kBStage, &wmap, full0 + 8 * stage, (s - tap * chunks) * kTileK, tap, c0);
  };
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kProducers + 1);  // the producers' arrivals and the TMA's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int i = 0; i < min(n_steps, kStages); ++i) load_b(i);
    STAMP(2);
  }
  // The tile's rows, a thread each: the offset of the row's pixel at tap
  // (0, 0) and a bit per tap that falls inside the image. A step of the
  // producer then adds one offset and tests a bit.
  if (t < kTileM) {
    const int M = a.N * a.Ho * a.Wo;  // output pixels; below 2^31 (the launcher checks)
    const int m = m0 + t;
    const bool live = m < M;
    const int mm = live ? m : 0;
    const int n = mm / (a.Ho * a.Wo);
    const int rem = mm - n * a.Ho * a.Wo;
    const int oy = rem / a.Wo, ox = rem - oy * a.Wo;
    const int iy0 = oy * a.stride - a.pad_t, ix0 = ox * a.stride - a.pad_l;
    uint32_t in_y = 0, in_x = 0, bits = 0;
    for (int d = 0; d < a.k; ++d) {
      in_y |= static_cast<uint32_t>(iy0 + d >= 0 && iy0 + d < a.H) << d;
      in_x |= static_cast<uint32_t>(ix0 + d >= 0 && ix0 + d < a.W) << d;
    }
    for (int ky = 0; ky < a.k; ++ky) {
      if ((in_y >> ky) & 1u) bits |= in_x << (ky * a.k);
    }
    row_off[t] = ((n * a.H + iy0) * a.W + ix0) * a.Cin;
    row_taps[t] = live ? bits : 0u;
  }
  __syncthreads();
  if (t == 0) STAMP(1);

  if (t >= kConsumers) {
    // ---- producer warpgroup: TMA for B, cp.async gathers for A ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int p = t - kConsumers;
    const int q = p & 7;   // the 16-byte piece of a 128-byte row this thread copies
    const int r0 = p >> 3;  // and its rows r0 + 16 h
    int xoff[kTileM / 16];
    uint32_t tap_ok[kTileM / 16];
#pragma unroll
    for (int h = 0; h < kTileM / 16; ++h) {
      xoff[h] = row_off[r0 + 16 * h] + q * 16;
      tap_ok[h] = row_taps[r0 + 16 * h];
    }
    if (p == 0) STAMP(3);
    // row r's piece q lands at r * 128 + ((q ^ (r % 8)) * 16): the 128-byte swizzle; r % 8 = r0 % 8
    const uint32_t dst0 = a_smem + r0 * kTileK + ((q ^ (r0 & 7)) << 4);
    int tap = s0 / chunks, chunk = s0 - tap * chunks;
    int ky = tap / a.k, kx = tap - ky * a.k;
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % kStages;
      if (i >= kStages) {
        mbar_wait(empty0 + 8 * stage, ((i / kStages) - 1) & 1);
        if (p == 0) load_b(i);
      }
      const bool cin_ok = chunk * kTileK + q * 16 < a.Cin;
      const int x_step = (ky * a.W + kx) * a.Cin + chunk * kTileK;
#pragma unroll
      for (int h = 0; h < kTileM / 16; ++h) {
        const bool ok = cin_ok && ((tap_ok[h] >> tap) & 1u);
        cp_async_16(dst0 + stage * kAStage + h * 16 * kTileK, ok ? a.x + xoff[h] + x_step : a.x, ok ? 16 : 0);
      }
      cp_async_commit();
      if (i > 0) {  // the previous step's copies have landed: publish them
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(full0 + 8 * ((i - 1) % kStages));
      }
      if (++chunk == chunks) {
        chunk = 0;
        ++tap;
        if (++kx == a.k) {
          kx = 0;
          ++ky;
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(full0 + 8 * ((n_steps - 1) % kStages));
  } else {
    // ---- consumer warpgroups: wgmma, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
    if (t == 0) STAMP(4);
    int acc[kNReg];
#pragma unroll
    for (int i = 0; i < kNReg; ++i) acc[i] = 0;
    const uint64_t a_desc = smem_desc(a_smem + wg * 64 * kTileK), b_desc = smem_desc(b_smem);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % kStages;
      mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
      if (t == 0 && i == 0) STAMP(5);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTileK / 32; ++ks) {
        Wgmma<TN>::mma(acc, a_desc + (stage * kAStage + 32 * ks) / 16, b_desc + (stage * kBStage + 32 * ks) / 16);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's wgmma are done with its stage
      if (i > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kNReg; ++i) fence_operand(acc[i]);
    if (t == 0) STAMP(6);

    // epilogue. The stages are free now: each thread parks its fragment in an
    // int32 tile in shared memory (rows g and g + 8 of its warp's 16,
    // columns 8 j + 2 tg and 8 j + 2 tg + 1 in acc[4 j + 2 e + (0, 1)] for
    // row g + 8 e). Then each thread takes one run of 8 neighbouring columns
    // in every kRowsPerPass-th row: its 8 scales and offsets stay in
    // registers, its residual runs are copied to shared memory (cp.async)
    // while the tile is parked, and the loop over its rows is not unrolled,
    // so the epilogue's code stays in the instruction cache. Each row does
    // ops/qconv.py::epilogue_plain's operations in the same order and
    // writes the run whole where the layer's row pitch allows.
    constexpr int kRunsPerRow = TN / 8;
    constexpr int kRowsPerPass = kConsumers / kRunsPerRow;
    const int M = a.N * a.Ho * a.Wo;
    const int rows = min(kTileM, M - m0), cols = min(TN, a.Cout - c0);
    int* const s_acc = reinterpret_cast<int*>(smem_raw + (tiles - smem_u32(smem_raw)));
    uint8_t* const s_res = reinterpret_cast<uint8_t*>(s_acc + kTileM * kPitch<TN>);  // [kTileM][TN], 1 or 2 bytes
    const int run_col = (t % kRunsPerRow) * 8, r0 = t / kRunsPerRow;
    const int n = min(8, cols - run_col);  // the run's columns below Cout
    const bool active = r0 < kRowsPerPass && n > 0;
    const bool whole_runs = (a.Cout & 7) == 0;  // then every run starts 8 elements aligned and n = 8
    named_barrier_consumers();  // both warpgroups' wgmma are done with the stages
    if (t == 0) STAMP(8);
    // the residual of this thread's runs to shared memory, read back by the thread itself
    const bool staged_res = a.res_kind != kNoRes && whole_runs && active;
    auto copy_res = [&]() {
      const int bytes = a.res_kind == kResInt8 ? 8 : 16;
#pragma unroll 1
      for (int r = r0; r < rows; r += kRowsPerPass) {
        const long long o = static_cast<long long>(m0 + r) * a.Cout + c0 + run_col;
        const uint32_t dst = smem_u32(s_res) + (r * TN + run_col) * (bytes / 8);
        if (bytes == 8) {
          cp_async_8(dst, static_cast<const int8_t*>(a.res) + o);
        } else {
          cp_async_16(dst, static_cast<const uint16_t*>(a.res) + o, 16);
        }
      }
      cp_async_commit();
    };
    if (staged_res && a.splits == 1) copy_res();  // (a split conv's last block copies it once it knows)
    {
      const int g = lane >> 2, tg = lane & 3;
      int* const row = s_acc + (wg * 64 + warp * 16 + g) * kPitch<TN> + 2 * tg;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<int2*>(row + 8 * e * kPitch<TN> + 8 * j) =
              make_int2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
        }
      }
    }
    float sc[8], of[8];  // in flight during the split reduction and the residual's copies
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + run_col + min(i, n - 1);  // past the last filter: a clamped column, never stored
      sc[i] = active ? __ldg(a.scale + c) : 0.0f;
      of[i] = active && a.offset != nullptr ? __ldg(a.offset + c) : 0.0f;
    }
    if (a.splits > 1) {
      // split K: each block adds its partial tile into the tile's workspace
      // by TMA bulk reductions, a row a thread; the last block to arrive (an
      // atomic counter) takes the sums and leaves zeros behind. Rows past the
      // last pixel are neither added nor read.
      fence_proxy_async();  // the tile's writes, before the bulk copies read them
      named_barrier_consumers();
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      int* const part = a.partials + static_cast<long long>(tile) * kTileM * TN;
      if (t < rows) {
        asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.s32 [%0], [%1], %2;" ::"l"(part + t * TN),
                     "r"(smem_u32(s_acc + t * kPitch<TN>)), "n"(TN * 4)
                     : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
      __threadfence();
      named_barrier_consumers();
      if (t == 0) last_arrival = atomicAdd(a.counters + tile, 1) == a.splits - 1;
      named_barrier_consumers();
      if (!last_arrival) return;
      __threadfence();
      if (staged_res) copy_res();
      // the sums, a thread's loads of a half in flight at once
      int4* const sums = reinterpret_cast<int4*>(part);
      constexpr int kHalf = TN / 16;  // int4 a thread per half
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        int4 got[kHalf];
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int i = t + (half * kHalf + j) * kConsumers;
          got[j] = i < rows * (TN / 4) ? __ldcg(sums + i) : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int i = t + (half * kHalf + j) * kConsumers, r = i / (TN / 4), c4 = i - r * (TN / 4);
          if (r < rows) {
            *reinterpret_cast<int4*>(s_acc + r * kPitch<TN> + 4 * c4) = got[j];
            __stcg(sums + i, make_int4(0, 0, 0, 0));
          }
        }
      }
      if (t == 0) a.counters[tile] = 0;
    }
    if (staged_res) cp_async_wait<0>();  // a thread reads back only the runs it copied
    if (a.res_kind == kResInt8) {  // bf16(float(q) * float(bf16(xs_r))) for each of the 256 values of q
      res_lut[t] = bf16_round(__fmul_rn(static_cast<float>(static_cast<int8_t>(t)), bf16_round(__ldg(a.res_xs))));
    }
    named_barrier_consumers();
    if (t == 0) STAMP(9);
    if (!active) return;

    const float xs = a.store == kInt8 ? __ldg(a.emit_xs) : 1.0f;
    const float inv_xs = __frcp_rn(xs);
#pragma unroll 1
    for (int r = r0; r < rows; r += kRowsPerPass) {
      const long long o = static_cast<long long>(m0 + r) * a.Cout + c0 + run_col;
      Run32 v;
      v.v[0] = *reinterpret_cast<const int4*>(s_acc + r * kPitch<TN> + run_col);
      v.v[1] = *reinterpret_cast<const int4*>(s_acc + r * kPitch<TN> + run_col + 4);
      if (a.store == kAcc) {
        int* out = static_cast<int*>(a.out) + o;
        if (whole_runs) {
          reinterpret_cast<int4*>(out)[0] = v.v[0];
          reinterpret_cast<int4*>(out)[1] = v.v[1];
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < n) out[i] = v.i[i];
          }
        }
        continue;
      }
      float w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = __fmul_rn(static_cast<float>(v.i[i]), sc[i]);
      if (a.offset != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = __fadd_rn(w[i], of[i]);
      }
      if (a.relu) {
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = fmaxf(w[i], 0.0f);
      }
      if (a.res_kind != kNoRes) {
        float res[8];
        if (a.res_kind == kResInt8) {
          Run8 q;
          if (whole_runs) {
            q.v = *reinterpret_cast<const uint2*>(s_res + r * TN + run_col);
          } else {
            const int8_t* src = static_cast<const int8_t*>(a.res) + o;
#pragma unroll
            for (int i = 0; i < 8; ++i) q.b[i] = i < n ? src[i] : 0;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) res[i] = res_lut[static_cast<uint8_t>(q.b[i])];
        } else {
          Run16 h;
          if (whole_runs) {
            h.v = *reinterpret_cast<const int4*>(s_res + 2 * (r * TN + run_col));
          } else {
            const uint16_t* src = static_cast<const uint16_t*>(a.res) + o;
#pragma unroll
            for (int i = 0; i < 8; ++i) h.s[i] = i < n ? src[i] : 0;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) res[i] = __bfloat162float(__ushort_as_bfloat16(h.s[i]));
        }
#pragma unroll
        for (int i = 0; i < 8; i += 2) bf16_round2(w[i], w[i + 1]);
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = __fadd_rn(w[i], res[i]);
#pragma unroll
        for (int i = 0; i < 8; i += 2) bf16_round2(w[i], w[i + 1]);
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = fmaxf(w[i], 0.0f);
      }
      if (a.store == kBf16) {
        Run16 h;
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(w[i], w[i + 1]);
          h.s[i] = __bfloat16_as_ushort(p.x);
          h.s[i + 1] = __bfloat16_as_ushort(p.y);
        }
        uint16_t* out = static_cast<uint16_t*>(a.out) + o;
        if (whole_runs) {
          *reinterpret_cast<int4*>(out) = h.v;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < n) out[i] = h.s[i];
          }
        }
      } else {
        int qi[8];
        bool divide[8], any = false;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          qi[i] = requantize_guess(w[i], inv_xs, divide[i]);
          any |= divide[i];
        }
        if (any) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (divide[i]) qi[i] = requantize_exact(w[i], xs);
          }
        }
        Run8 q;
#pragma unroll
        for (int i = 0; i < 8; ++i) q.b[i] = static_cast<int8_t>(qi[i]);
        int8_t* out = static_cast<int8_t*>(a.out) + o;
        if (whole_runs) {
          *reinterpret_cast<uint2*>(out) = q.v;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i < n) out[i] = q.b[i];
          }
        }
      }
      if (t == 0 && r == r0) STAMP(10);
    }
    if (t == 0) STAMP(7);
  }
}

// ---- the host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The weights' tensor maps, encoded once per (tensor, shape, tile width): a
// map holds nothing but the address and the geometry, so a key of those is
// never stale, whatever tensor later occupies the same address.
struct WeightMap {
  const void* w;
  int cin, taps, cout, tn;
  CUtensorMap map;
};
constexpr int kMapCache = 512;
WeightMap map_cache[kMapCache];
int map_count = 0, map_next = 0;
std::mutex map_mutex;

int weight_map(const void* w, int cin, int taps, int cout, int tn, CUtensorMap* out) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < map_count; ++i) {
    const WeightMap& e = map_cache[i];
    if (e.w == w && e.cin == cin && e.taps == taps && e.cout == cout && e.tn == tn) {
      *out = e.map;
      return 0;
    }
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  WeightMap& e = map_cache[map_next];
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(taps),
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(taps) * cin};  // bytes
  const cuuint32_t box[3] = {kTileK, 1, static_cast<cuuint32_t>(tn)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  e.w = w;
  e.cin = cin;
  e.taps = taps;
  e.cout = cout;
  e.tn = tn;
  *out = e.map;
  map_next = (map_next + 1) % kMapCache;
  if (map_count < kMapCache) ++map_count;
  return 0;
}

template <int TN>
int launch(const CUtensorMap& map, const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem_bytes = kSmemBytes<TN>;
  // Above the 48 KB a kernel may use without asking. The attribute belongs
  // to the device current at the call (the wrapper makes x's device
  // current), so it is raised once a device: bit d for device d < 64, and
  // on every launch on a device beyond.
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(raised.load() & bit)) {
    err = cudaFuncSetAttribute(qconv_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  qconv_kernel<TN><<<grid, kThreads, smem_bytes, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess). The wrapper
// (ops/qconv.py) checks types, shapes, contiguity and the 16-byte alignment
// of x and w, and chooses tile_n and splits (launch_plan); the workspace is
// int32, zero, and holds the tiles' counters, then from the next multiple of
// 64 ints their partial sums (needed when splits > 1).
int qconv(const void* x, const void* w, const void* scale, const void* offset, const void* emit_xs,
          const void* res, const void* res_xs, void* out, void* workspace, int N, int H, int W, int Cin, int Cout,
          int k, int stride, int Ho, int Wo, int pad_t, int pad_l, int relu, int store, int res_kind, int tile_n,
          int splits, void* stream) {
  const int steps = k * k * ((Cin + kTileK - 1) / kTileK);
  if (N < 1 || H < 1 || W < 1 || Cout < 1 || Cin < 16 || (Cin & 15) || (k != 1 && k != 3) ||
      (stride != 1 && stride != 2) || store < 0 || store > 2 || (store == kInt8 && emit_xs == nullptr) ||
      res_kind < 0 || res_kind > 2 || (res_kind != kNoRes && res == nullptr) ||
      (res_kind == kResInt8 && res_xs == nullptr) || (res_kind != kNoRes && store == kAcc) || splits < 1 ||
      splits > steps || (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long M = static_cast<long long>(N) * Ho * Wo;
  if (M > 2147483647LL - kTileM) return static_cast<int>(cudaErrorInvalidValue);
  const long long gx = (M + kTileM - 1) / kTileM;
  const int gy = (Cout + tile_n - 1) / tile_n;
  if (gx > 2147483647LL || gy > 65535 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = weight_map(w, Cin, k * k, Cout, tile_n, &map);
  if (err != 0) return err;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.scale = static_cast<const float*>(scale);
  a.offset = static_cast<const float*>(offset);
  a.emit_xs = static_cast<const float*>(emit_xs);
  a.res = res;
  a.res_xs = static_cast<const float*>(res_xs);
  a.out = out;
  const long long tiles = gx * gy;
  a.counters = static_cast<int*>(workspace);
  a.partials = workspace != nullptr ? static_cast<int*>(workspace) + ((tiles + 63) / 64) * 64 : nullptr;
  a.N = N; a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout; a.k = k; a.stride = stride;
  a.Ho = Ho; a.Wo = Wo; a.pad_t = pad_t; a.pad_l = pad_l; a.relu = relu; a.store = store;
  a.res_kind = res_kind; a.splits = splits;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy), static_cast<unsigned>(splits));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_n) {  // ops/qconv.py's TILE_NS
    case 48: return launch<48>(map, a, grid, s);
    case 64: return launch<64>(map, a, grid, s);
    case 80: return launch<80>(map, a, grid, s);
    case 112: return launch<112>(map, a, grid, s);
    case 128: return launch<128>(map, a, grid, s);
    case 256: return launch<256>(map, a, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef QCONV_TIMING
int qconv_read_stamps(void* host) { return (int)cudaMemcpyFromSymbol(host, qconv_stamps, sizeof(qconv_stamps)); }
#endif

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
