// Masked fixed-capacity greedy NMS on Hopper (sm_90a), plain C interface.
//
// Replaces the device loop of playground3d_tpu/ops/nms.py::nms (and, through
// it, batched_nms): a lax.while_loop that iterates
//     keep[i] <- not any_j (beats[j, i] and keep[j]) and mask[i]
// from keep = mask to its fixed point (at most n_iter rounds), then compacts
// the kept indices in lax.top_k's order. The port's plain version
// (ops/nms.py::nms_plain) runs the loop on the host and reads one flag a
// round; these kernels keep the whole loop on the card, so the caller never
// waits for it and a CUDA graph can hold it. batched_nms's shift (boxes
// moved to a non-negative origin and offset by group * span) is done in
// the kernels when the caller passes the groups.
//
// What bounds it: neither bytes (a few KB of boxes) nor operations (n^2 / 2
// IoUs once, then n^2/32 word ANDs a round) but latency: the loop runs as
// many rounds as the longest suppression chain, each a barrier of one
// block. There are no products, so the tensor cores have no part here.
// Two routes, chosen by n in ops/nms.py::launch_plan:
//  - n <= kSmemMaxBoxes (every NMS of the tracker; 512 at most): ONE
//    launch, fused_kernel, a thread-block cluster of cluster_for(n) CTAs of
//    1,024 threads (1 CTA at n <= 64, 8 from n 257). Each CTA reads the
//    boxes once into registers, shifts them (batched_nms) and stages them,
//    their areas and masked scores in its shared memory. Then the beats
//    bits of the [words][n] table (bit b of word (w, i) = beats[32w + b,
//    i]) by 32 x 32 tiles of box pairs, each IoU once: a warp holds the 32
//    boxes of word a in registers and tests them against a slice of the
//    boxes i of word b >= a; the ballot of "j beats i" is word (a, i), and
//    the bits of "i beats j" that lane j collects are word (b, j), ORed in
//    by the tile's slices. The words go through distributed shared memory
//    into the leader CTA's table. After the cluster barrier the others exit and the leader's first
//    threads_for(n) threads run the rounds from shared memory, one named
//    barrier a round: keep is double-buffered as ballot words, each box ANDs
//    its column (in registers up to n 512: 19.0 us at n 512 / 23 rounds,
//    25.1 with the column read from shared memory) against them, read as
//    uint4, branch-free over the words (an early exit measured slower), and
//    bar.red.or over "changed" both publishes the next keep and decides the
//    next round. The previous route read each column from L2 with an
//    early exit, two launches and a barrier more a round: 50.5 us at n 512
//    (PERF.md).
//  - above it, up to kMaxBoxes (the retinanet default pre_topk of 4,096):
//    two launches as before, the table in device memory (n^2/8 bytes, in
//    L2): beats_kernel, a grid of a thread per (box i, word w), then
//    loop_kernel, one block, as its programmatic dependent (its launch
//    overlaps the grid's tail); with groups, shift_kernel writes the
//    shifted boxes first.
// Compaction: a kept box's rank is the number of kept boxes ahead of it in
// top_k's order (a higher score, or an equal score at a lower index), and
// each kept box writes itself to its rank (one route lists the kept boxes
// and counts by a warp a kept box, stopping at max_keep; the other counts
// by a thread a box).
//
// Exactness: IoU > thr decides every bit, so the IoU is formed op for op as
// ops/iou.py::pairwise_iou does (each op rounded on its own: __fmul_rn,
// __fadd_rn, __fsub_rn; the file is also built with -fmad=false), and the
// quotient's test against thr is exact without dividing (iou_above). The
// shift is ops/nms.py::group_shift op for op: min and max over the masked
// coordinates (0 for a masked-out box), span = (max - min) + 1, offset =
// float(g) * span, (b - min) + offset. Scores compare as the plain version
// compares them. Output, masks and the round count equal the plain
// version's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBoxes = 8192;  // kMaxPerThread boxes for each of 1,024 threads
constexpr int kSmemMaxBoxes = 1260;  // fused_shared_bytes(n) within the 232,448 bytes a block may opt into
constexpr int kMaxPerThread = 8;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kClusterBoxes = 64;  // a cluster CTA for each 64 boxes, in powers of two
constexpr int kBeatsThreads = 256;
constexpr int kShiftThreads = 1024;
constexpr int kRegWords = 16;  // up to n 512 a round thread keeps its box's column in registers
constexpr float kNegInf = -1e30f;  // NEG_INF of ops/nms.py: masked scores
constexpr float kKeptFloor = -5e29f;  // NEG_INF / 2: top_k scores above it are kept boxes

__host__ __device__ constexpr int words_for(int n) { return (n + 31) / 32; }
// keep and mask words as whole uint4s: kRegWords of them while a round reads
// them all against a column in registers, else the words rounded up
__host__ __device__ constexpr int words4_for(int n) {
  return n <= 32 * kRegWords ? kRegWords : (words_for(n) + 3) / 4 * 4;
}
__host__ __device__ constexpr int threads_for(int n) { return n <= 32 ? 32 : n >= 1024 ? 1024 : ((n + 31) / 32) * 32; }
__host__ __device__ constexpr int per_thread_for(int n) { return n < 1 ? 1 : (n + threads_for(n) - 1) / threads_for(n); }
__host__ __device__ constexpr int cluster_for(int n) {
  return n <= kClusterBoxes ? 1 : n <= 2 * kClusterBoxes ? 2 : n <= 4 * kClusterBoxes ? 4 : kMaxCluster;
}
// fused_kernel's dynamic shared memory: boxes float4 [n], keep words [2][W4],
// mask words [W4], the table [W][n], masked scores [n], areas [n], the
// shift's min and max keys and two spare words
__host__ __device__ constexpr int fused_shared_bytes(int n) {
  return 16 * n + 12 * words4_for(n) + 4 * words_for(n) * n + 8 * n + 16;
}
// loop_kernel's: keep words [W] and one word
__host__ __device__ constexpr int loop_shared_bytes(int n) { return 4 * words_for(n) + 4; }

#ifdef NMS_TIMING
// fused_kernel's leader thread 0 writes (SM clock, global timer) at: start,
// boxes staged, table complete, rounds done, compaction done
__device__ unsigned long long nms_stamps[5][2];
#define STAMP(k)                                                                    \
  do {                                                                              \
    if (threadIdx.x == 0 && cluster.block_rank() == 0) {                            \
      unsigned long long g;                                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));                         \
      nms_stamps[k][0] = clock64();                                                 \
      nms_stamps[k][1] = g;                                                         \
    }                                                                               \
  } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

// an int whose signed order is the float order (for atomicMin / atomicMax)
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float order_key_value(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

// the area of a box, as pairwise_iou forms it
__device__ __forceinline__ float area_of(float4 b) { return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y)); }

// "IoU > thr" without the division, exactly: for thr = 0 or a normal float
// thr the correctly rounded quotient fl(inter / union) exceeds thr if and
// only if the real quotient exceeds mu, the midpoint between thr and the
// next float (a tie at mu cannot occur: mu has 25 significant bits and an
// odd last one, so mu * union never equals a float inter; at thr = 0 a tie
// rounds to 0). With union > 0 that is inter > mu * union, and mu * union is
// exact in double (25 by 24 significant bits). Other thresholds divide.
struct Cut {
  double mu;
  bool exact;
};

__device__ __forceinline__ Cut cut_for(float thr) {
  thr = __fadd_rn(thr, 0.0f);  // -0 -> +0
  const float up = __uint_as_float(__float_as_uint(thr) + 1u);  // the next float, for 0 <= thr < FLT_MAX
  return {(static_cast<double>(thr) + static_cast<double>(up)) * 0.5,
          thr == 0.0f || (thr >= 1.17549435e-38f && thr < 3.40282347e38f)};
}

// ops/iou.py::pairwise_iou(a, b)[0, 0] > thr for a = box j, b = box i (the
// clamps at 0 as fmaxf: where they differ, at NaN, both give "not above")
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b, float thr, const Cut& cut) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  uni = uni < 1e-8f ? 1e-8f : uni;
  if (cut.exact) return static_cast<double>(inter) > cut.mu * static_cast<double>(uni);
  return __fdiv_rn(inter, uni) > thr;
}

// group_shift's min and max over the masked coordinates (0 for a masked-out
// box), reduced into keys[0] (min) and keys[1] (max), which the caller set
// to the keys of +inf and -inf before a barrier; the caller syncs after
__device__ void shift_bounds(const float4* __restrict__ boxes, const uint8_t* __restrict__ mask, int n, int* keys) {
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 b = mask[i] ? boxes[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    lo = fminf(lo, fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
    hi = fmaxf(hi, fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(keys, order_key(lo));
    atomicMax(keys + 1, order_key(hi));
  }
}

// (b - min) + float(g) * ((max - min) + 1), each op rounded
__device__ __forceinline__ float4 shifted(float4 b, int g, float lo, float hi) {
  const float off = __fmul_rn(__int2float_rn(g), __fadd_rn(__fsub_rn(hi, lo), 1.0f));
  return make_float4(__fadd_rn(__fsub_rn(b.x, lo), off), __fadd_rn(__fsub_rn(b.y, lo), off),
                     __fadd_rn(__fsub_rn(b.z, lo), off), __fadd_rn(__fsub_rn(b.w, lo), off));
}

// ---- one launch: n <= kSmemMaxBoxes ---------------------------------------

constexpr int kFusedThreads = 1024;  // every CTA of the cluster; the rounds take threads_for(n) of the leader's
constexpr int kSliceBoxes = 4;  // boxes i of a 32 x 32 beats tile a warp takes in one step
constexpr int kFusedPer = 2;  // per_thread_for(kSmemMaxBoxes)
static_assert(per_thread_for(kSmemMaxBoxes) <= kFusedPer, "fused_kernel holds two boxes a round thread");

// bar.sync / bar.red.or on named barrier 1 over the first `count` threads
__device__ __forceinline__ void sync_first(int count) { asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory"); }
__device__ __forceinline__ bool or_first(int count, bool v) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 q, %1, 0;\n\tbar.red.or.pred p, 1, %2, q;\n\tselp.s32 %0, 1, 0, p;\n\t}"
      : "=r"(r)
      : "r"(static_cast<int>(v)), "r"(count)
      : "memory");
  return r != 0;
}

template <bool kRegColumn>
__global__ void __launch_bounds__(kFusedThreads)
fused_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, const uint8_t* __restrict__ mask,
             const int32_t* __restrict__ groups, int n, float thr, int n_iter, int max_keep,
             int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_mask, int32_t* __restrict__ rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  STAMP(0);
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = words_for(n), W4 = words4_for(n), T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int C = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  float4* bx = reinterpret_cast<float4*>(smem);
  uint32_t* keep_w = reinterpret_cast<uint32_t*>(bx + n);  // [2][W4]
  uint32_t* mask_w = keep_w + 2 * W4;  // [W4]
  uint32_t* table = mask_w + W4;  // [W][n], used in the leader only
  float* s = reinterpret_cast<float*>(table + W * n);
  float* area = s + n;
  int* keys = reinterpret_cast<int*>(area + n);  // the shift's min and max, the final keep buffer
  // the leader's table words that the tiles OR into (word w of a box in an
  // earlier word) start at 0, before any other CTA may write them; then
  // "this CTA runs": the others may write its shared memory once all arrived
  if (rank == 0) {
    for (int w = 1; w < W; ++w) {
      for (int i = t; i < 32 * w && i < n; i += T) table[w * n + i] = 0u;
    }
  }
  if (C > 1) {
    if (rank == 0) {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    } else {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    }
  }

  // 1. stage the boxes (shifted), their areas, the masked scores and the
  // mask words in this CTA's shared memory; one read of each input, into
  // registers, before the shift's min and max
  if (groups != nullptr && t == 0) {
    keys[0] = order_key(__int_as_float(0x7f800000));
    keys[1] = order_key(-__int_as_float(0x7f800000));
  }
  const int staged = (n + T - 1) / T;  // boxes of each thread, at most kFusedPer
  float4 bi[kFusedPer];
  float si[kFusedPer];
  int gi[kFusedPer];
  bool mi[kFusedPer];
#pragma unroll
  for (int k = 0; k < kFusedPer; ++k) {
    const int i = t + k * T;
    const bool in = k < staged && i < n;
    bi[k] = in ? boxes[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    mi[k] = in && mask[i];
    si[k] = in ? scores[i] : 0.0f;
    gi[k] = in && groups != nullptr ? groups[i] : 0;
  }
  if (groups != nullptr) {
    float lo = __int_as_float(0x7f800000), hi = -lo;
#pragma unroll
    for (int k = 0; k < kFusedPer; ++k) {
      if (k < staged && t + k * T < n) {  // a masked-out box counts as zeros
        const float4 b = mi[k] ? bi[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        lo = fminf(lo, fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
        hi = fmaxf(hi, fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
    __syncthreads();  // the keys are set
    if (lane == 0) {
      atomicMin(keys, order_key(lo));
      atomicMax(keys + 1, order_key(hi));
    }
    __syncthreads();
    lo = order_key_value(keys[0]);
    hi = order_key_value(keys[1]);
#pragma unroll
    for (int k = 0; k < kFusedPer; ++k) bi[k] = shifted(bi[k], gi[k], lo, hi);
  }
  for (int w = W + t; w < W4; w += T) keep_w[w] = keep_w[W4 + w] = mask_w[w] = 0u;
#pragma unroll
  for (int k = 0; k < kFusedPer; ++k) {
    if (k >= staged) break;  // uniform over the block
    const int i = t + k * T;
    const uint32_t ballot = __ballot_sync(0xffffffffu, mi[k]);
    const int w = k * (T >> 5) + warp;
    if (lane == 0 && w < W) keep_w[w] = mask_w[w] = ballot;  // keep starts as the mask
    if (i < n) {
      bx[i] = bi[k];
      area[i] = area_of(bi[k]);
      s[i] = mi[k] ? si[k] : kNegInf;
    }
  }
  __syncthreads();
  if (C > 1) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // every CTA runs
  STAMP(1);

  // 2. the beats words by 32 x 32 tiles, each IoU once: tile (a, b), a <= b,
  // holds box j = 32a + lane in registers and tests it against the boxes i
  // of word b, a slice of kSliceBoxes of them per warp step. "j beats i" is
  // the ballot, word (a, i) of the table; for a < b, "i beats j" collects in
  // lane j as the bits of word (b, j), ORed into the table (the slices of a
  // tile share it). The words go to the leader's table through distributed
  // shared memory; the cluster's warps share the slices.
  {
    uint32_t* lead = cluster.map_shared_rank(table, 0);
    const int warps = C * (T >> 5), gw = rank * (T >> 5) + warp;
    const int slices = W * (W + 1) / 2 * (32 / kSliceBoxes);
    const Cut cut = cut_for(thr);
    const float nan = __int_as_float(0x7fffffff);  // a masked-out box's score: never ahead, never behind
    for (int u = gw; u < slices; u += warps) {
      int a = 0, tile = u / (32 / kSliceBoxes);
      while (tile >= W - a) {  // tiles row by row: (0, 0..W-1), (1, 1..W-1), ...
        tile -= W - a;
        ++a;
      }
      const int b = a + tile, i0 = 32 * b + (u % (32 / kSliceBoxes)) * kSliceBoxes;
      const int j = 32 * a + lane, jj = j < n ? j : 0;
      const float4 bj = bx[jj];
      const float aj = area[jj], sj = (mask_w[a] >> lane) & 1u ? s[jj] : nan;
      uint32_t rev = 0;
#pragma unroll
      for (int q = 0; q < kSliceBoxes; ++q) {
        const int i = i0 + q;
        if (i >= n) break;  // uniform over the warp
        const float s_i = (mask_w[i >> 5] >> (i & 31)) & 1u ? s[i] : nan;
        const bool hit = j != i && iou_above(bj, aj, bx[i], area[i], thr, cut);
        const uint32_t word = __ballot_sync(0xffffffffu, hit && (sj > s_i || (sj == s_i && j < i)));
        if (lane == 0) lead[a * n + i] = word;
        rev |= hit && (s_i > sj || (s_i == sj && i < j)) ? 1u << (i & 31) : 0u;
      }
      if (a < b && rev != 0u) atomicOr(lead + b * n + j, rev);
    }
  }
  if (C > 1) {  // the table is complete; the other CTAs leave only now
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (rank != 0) return;
  } else {
    __syncthreads();
  }
  STAMP(2);

  // 3. the rounds, by the first R threads, from shared memory: one barrier a
  // round (named barrier 1); the others wait at the block barrier below
  const int R = threads_for(n), per = per_thread_for(n);
  bool keep[kFusedPer];
  int cur = 0;
  if (t < R) {
    bool m[kFusedPer];
    uint32_t col[kRegColumn ? kRegWords : 1];
#pragma unroll
    for (int k = 0; k < kFusedPer; ++k) {
      const int i = t + k * R;
      m[k] = k < per && i < n && ((mask_w[i >> 5] >> (i & 31)) & 1u);
      keep[k] = m[k];
    }
    if (kRegColumn) {  // per == 1 and W <= kRegWords
#pragma unroll
      for (int w = 0; w < (kRegColumn ? kRegWords : 1); ++w) col[w] = w < W && t < n ? table[w * n + t] : 0u;
    }
    int it = 0, reads = 0;
    bool again = n > 0;  // any(keep != prev) with prev = ~mask
    while (it < n_iter) {
      ++reads;
      if (!again) break;
      const uint4* kw = reinterpret_cast<const uint4*>(keep_w + cur * W4);
      bool changed = false;
#pragma unroll
      for (int k = 0; k < kFusedPer; ++k) {
        if (k >= per) break;
        const int i = t + k * R;
        uint32_t hit = 0;
        if (kRegColumn) {  // W4 == kRegWords: every uint4, branch-free
#pragma unroll
          for (int q = 0; q < kRegWords / 4; ++q) {
            const uint4 kv = kw[q];
            hit |= (col[4 * q] & kv.x) | (col[4 * q + 1] & kv.y) | (col[4 * q + 2] & kv.z) | (col[4 * q + 3] & kv.w);
          }
        } else if (m[k]) {  // the column from shared memory
          for (int q = 0; q < W4 / 4; ++q) {
            const uint4 kv = kw[q];
            const uint32_t* c = table + 4 * q * n + i;
            hit |= c[0] & kv.x;
            if (4 * q + 1 < W) hit |= c[n] & kv.y;
            if (4 * q + 2 < W) hit |= c[2 * n] & kv.z;
            if (4 * q + 3 < W) hit |= c[3 * n] & kv.w;
          }
        }
        const bool nk = m[k] && hit == 0;
        changed |= nk != keep[k];
        keep[k] = nk;
        const uint32_t ballot = __ballot_sync(0xffffffffu, nk);
        const int w = k * (R >> 5) + warp;
        if (lane == 0 && w < W) keep_w[(cur ^ 1) * W4 + w] = ballot;
      }
      again = or_first(R, changed);  // publishes the next keep words too
      cur ^= 1;
      ++it;
    }
    if (t == 0) {
      keys[2] = cur;  // which keep buffer holds the fixed point
      if (rounds != nullptr) atomicAdd(rounds, reads);
    }
  }
  __syncthreads();
  STAMP(3);
  cur = keys[2];

  // 4. compaction in top_k's order (higher score first, lower index first on
  // ties): the kept boxes listed in index order with their scores, then a
  // warp per kept box counts the kept boxes ahead of it, 32 a step, and
  // stops once they reach max_keep (such a box has no position); positions
  // from the number kept on are 0 / False, and a kept box whose score is
  // not above NEG_INF / 2 writes 0 / False at its rank, as top_k's mask
  // drops it
  const uint32_t* kw = keep_w + cur * W4;
  int* kept = reinterpret_cast<int*>(area);  // the areas and the staged boxes are spent
  float* kept_s = reinterpret_cast<float*>(bx);
  int before = 0, total = 0;  // kept boxes in the words before this thread's first box's, and in all
  for (int w = 0; w < W; ++w) {
    const int c = __popc(kw[w]);
    before += w < warp ? c : 0;
    total += c;
  }
  for (int k = 0; k < staged; ++k) {
    const int i = t + k * T;
    if (i < n && ((kw[i >> 5] >> lane) & 1u)) {
      const int at = before + __popc(kw[i >> 5] & ((1u << lane) - 1u));
      kept[at] = i;
      kept_s[at] = s[i];
    }
    for (int w = i >> 5; w < ((i + T) >> 5) && w < W; ++w) before += __popc(kw[w]);  // to the next box's word
  }
  for (int p = total + t; p < max_keep; p += T) {
    keep_idx[p] = 0;
    keep_mask[p] = 0;
  }
  __syncthreads();
  for (int q = warp; q < total; q += T >> 5) {
    const int i = kept[q];
    const float s_i = kept_s[q];
    int ahead = 0;
    for (int r0 = 0; r0 < total && ahead < max_keep; r0 += 32) {  // ahead is uniform over the warp
      const int r = r0 + lane;
      const float sj = r < total ? kept_s[r] : -__int_as_float(0x7f800000);
      const int j = r < total ? kept[r] : n;
      ahead += __reduce_add_sync(0xffffffffu, (sj > s_i || (sj == s_i && j < i)) ? 1 : 0);
    }
    if (lane == 0 && ahead < max_keep) {
      const bool valid = s_i > kKeptFloor;
      keep_idx[ahead] = valid ? i : 0;
      keep_mask[ahead] = valid ? 1 : 0;
    }
  }
  STAMP(4);
}

// ---- two launches: kSmemMaxBoxes < n <= kMaxBoxes ---------------------------

// batched_nms's shifted boxes into the workspace, one block
__global__ void __launch_bounds__(kShiftThreads)
shift_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ mask, const int32_t* __restrict__ groups,
             int n, float4* __restrict__ out) {
  __shared__ int keys[2];
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the caller's boxes are complete
  asm volatile("griddepcontrol.launch_dependents;");
  if (threadIdx.x == 0) {
    keys[0] = order_key(__int_as_float(0x7f800000));
    keys[1] = order_key(-__int_as_float(0x7f800000));
  }
  __syncthreads();
  shift_bounds(boxes, mask, n, keys);
  __syncthreads();
  const float lo = order_key_value(keys[0]), hi = order_key_value(keys[1]);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = shifted(boxes[i], groups[i], lo, hi);
}

// beat[w * n + i], bit b = beats[32w + b, i] = (s_j > s_i, or equal and
// j < i) and IoU(j, i) > thr and both masked in
__global__ void __launch_bounds__(kBeatsThreads)
beats_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores, const uint8_t* __restrict__ mask,
             int n, float thr, uint32_t* __restrict__ beat) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the boxes (shifted by shift_kernel) are complete
  asm volatile("griddepcontrol.launch_dependents;");
  const long long e = static_cast<long long>(blockIdx.x) * kBeatsThreads + threadIdx.x;
  if (e >= static_cast<long long>(words_for(n)) * n) return;
  const int w = static_cast<int>(e / n), i = static_cast<int>(e % n);
  uint32_t word = 0;
  if (mask[i]) {
    const Cut cut = cut_for(thr);
    const float4 bi = boxes[i];
    const float si = scores[i], ai = area_of(bi);
    const int j_end = min(32, n - 32 * w);
    for (int b = 0; b < j_end; ++b) {
      const int j = 32 * w + b;
      if (!mask[j]) continue;
      const float sj = scores[j];
      if (!(sj > si || (sj == si && j < i))) continue;
      const float4 bj = boxes[j];
      if (iou_above(bj, area_of(bj), bi, ai, thr, cut)) word |= 1u << b;
    }
  }
  beat[e] = word;
}

// loop_kernel's compaction in top_k's order (higher score first, lower
// index first on ties); positions past the kept boxes are 0 / False. keep[k]
// is box t + k * blockDim.x; keep_words hold the same bits, visible to the
// block; s[j] is the score of box j wherever box j is kept.
__device__ void compact(const bool (&keep)[kMaxPerThread], int per, const uint32_t* keep_words, const float* s, int n,
                        int max_keep, int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_mask) {
  const int T = blockDim.x, t = threadIdx.x, W = words_for(n);
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
    const float si = s[i];
    if (!keep[k] || !(si > kKeptFloor)) continue;
    int rank = 0;
    for (int w = 0; w < W; ++w) {
      for (uint32_t bits = keep_words[w]; bits; bits &= bits - 1) {
        const int j = 32 * w + __ffs(bits) - 1;
        const float sj = s[j];
        rank += (sj > si || (sj == si && j < i)) ? 1 : 0;
      }
    }
    if (rank < K) {
      keep_idx[rank] = i;
      keep_mask[rank] = 1;
    }
  }
}

__global__ void __launch_bounds__(1024)
loop_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ mask, const uint32_t* __restrict__ beat,
            int n, int n_iter, int max_keep, int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_mask,
            int32_t* __restrict__ rounds) {
  extern __shared__ uint32_t keep_words[];  // [words]: bit b of word w = keep[32w + b]
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, W = words_for(n);
  const int per = per_thread_for(n);  // box k of this thread: i = t + k * T (uniform over the block)
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the beats table is complete
  bool keep[kMaxPerThread], prev[kMaxPerThread], m[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = t + k * T;
    m[k] = k < per && i < n && mask[i];
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

  __syncthreads();  // every thread is done reading keep_words
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    if (k >= per) break;
    const uint32_t ballot = __ballot_sync(0xffffffffu, keep[k]);
    const int w = k * (T >> 5) + warp;
    if (lane == 0 && w < W) keep_words[w] = ballot;
  }
  __syncthreads();
  // a kept box is masked in, so its raw score is its masked score
  compact(keep, per, keep_words, scores, n, max_keep, keep_idx, keep_mask);
  if (t == 0 && rounds != nullptr) atomicAdd(rounds, reads);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the first launch that failed (0 = cudaSuccess).
// The wrapper (ops/nms.py) checks types, shapes and devices and passes the
// plan launch_plan computed (cluster CTAs, 0 for the two-launch route;
// threads of the block that runs the rounds; its dynamic shared memory),
// which must equal this file's rule. `groups` (int32 [n], or null) asks for
// batched_nms's shift. `workspace` (two-launch route only): [n] float4
// shifted boxes, then the [words][n] beats table. `rounds` (int32 on the
// card, or null) is increased by the loop's rounds, counted as the plain
// version counts its host reads.
int nms(const void* boxes, const void* scores, const void* mask, const void* groups, int n, float thr, int n_iter,
        int max_keep, void* keep_idx, void* keep_mask, void* rounds, void* workspace, int cluster, int threads,
        int shared_bytes, void* stream) {
  if (n < 0 || n > kMaxBoxes || max_keep < 0 || n_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool fused = n <= kSmemMaxBoxes;
  if (cluster != (fused ? cluster_for(n) : 0) || threads != (fused ? kFusedThreads : threads_for(n)) ||
      shared_bytes != (fused ? fused_shared_bytes(n) : loop_shared_bytes(n)) ||
      per_thread_for(n) > kMaxPerThread) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* g = static_cast<const int32_t*>(groups);
  int32_t* ki = static_cast<int32_t*>(keep_idx);
  uint8_t* km = static_cast<uint8_t*>(keep_mask);
  int32_t* r = static_cast<int32_t*>(rounds);
  if (fused) {
    void (*kernel)(const float4*, const float*, const uint8_t*, const int32_t*, int, float, int, int, int32_t*,
                   uint8_t*, int32_t*) = n <= 32 * kRegWords ? fused_kernel<true> : fused_kernel<false>;
    if (shared_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, b, sc, m, g, n, thr, n_iter, max_keep, ki, km, r);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  float4* shifted_boxes = static_cast<float4*>(workspace);
  uint32_t* beat = reinterpret_cast<uint32_t*>(shifted_boxes + n);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (g != nullptr) {
    cfg.gridDim = dim3(1);
    cfg.blockDim = dim3(kShiftThreads);
    cfg.numAttrs = 0;  // the first of the chain waits for the caller's work as usual
    const cudaError_t err = cudaLaunchKernelEx(&cfg, shift_kernel, b, m, g, n, shifted_boxes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.numAttrs = 1;
    b = shifted_boxes;
  }
  const long long cells = static_cast<long long>(words_for(n)) * n;
  cfg.gridDim = dim3(static_cast<unsigned>((cells + kBeatsThreads - 1) / kBeatsThreads));
  cfg.blockDim = dim3(kBeatsThreads);
  cfg.numAttrs = g != nullptr ? 1 : 0;  // a programmatic dependent of shift_kernel
  cudaError_t err = cudaLaunchKernelEx(&cfg, beats_kernel, b, sc, m, n, thr, beat);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  cfg.numAttrs = 1;  // a programmatic dependent of beats_kernel
  err = cudaLaunchKernelEx(&cfg, loop_kernel, static_cast<const float*>(sc), m, static_cast<const uint32_t*>(beat), n,
                           n_iter, max_keep, ki, km, r);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef NMS_TIMING
int nms_read_stamps(void* host) { return (int)cudaMemcpyFromSymbol(host, nms_stamps, sizeof(nms_stamps)); }

__global__ void empty_kernel() {}

// an empty kernel launched as fused_kernel is (cluster, threads, shared memory)
int nms_empty_launch(int cluster, int threads, int shared_bytes, void* stream) {
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  if (cluster == 0) cfg.gridDim = dim3(1);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}
#endif

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
