// The detector's training loss and its gradient for Hopper (sm_90a), plain C
// interface.
//
// Replaces the device op playground3d_tpu/losses/focal.py::detection_loss
// (:187), which the JAX package built for the TPU out of XLA primitives: a
// streaming anchor assignment (a fori_loop over the label rows, _assign :79,
// the loop at :96) and, per image under vmap, the focal classification,
// smooth-L1 corner and vp-angle terms; jax.grad derived its backward. Here
// the forward is one launch and the backward another, bound by
// ops/focal_loss.py through a torch.autograd.Function.
//
// Inputs: classification [B,A,K] float32 (sigmoided), regression [B,A,12]
// float32, annotations [B,M,21] float32 (class -1 = padding), anchors [A,4]
// float32 xyxy. Every float op is rounded on its own in the order of the
// plain version (losses/focal.py::detection_loss_plain); the build passes
// -fmad=false and divides in IEEE round-to-nearest, and min / max / clamp
// pass NaN on as torch's do, so the IoU, and with it the assignment
// (argmax, positive, negative), equals the plain version's bit for bit.
//
// Bound on this card: bytes (classification and the outputs; regression and
// the label targets only at the rare positive anchors). A first, simple
// kernel (a block a tile, the labels staged and all M IoUs divided at every
// anchor, four serial block sums in the last block) ran at 8-16% of that
// bound; most of its time went to the IoU loop and the focal term's
// instructions, not to bytes. What this design does:
//
// Forward: a persistent grid of about kSlots blocks (two a SM), each
// walking a fixed list of tiles of kThreads anchors of one image
// (make_plan): ppi blocks an image, block p taking its every ppi-th tile
// from tile p (a stride shares a crowded region out); above kSlots images,
// one block an image. A block stages its image's label table in shared memory
// once (hull, area, class, the 20 targets, the three axis vectors and their
// norms, read with coalesced loads), and loads the next tile's anchors and
// classification (16-byte loads) before it works on this one. Each warp
// culls the labels for its 32 anchors (below) and evaluates the rest four
// at a time (independent divisions); then each thread takes its focal term
// over K (one logarithm a class) and, at a positive anchor, its smooth-L1
// term over 20 values and its vp term, the regression loaded before the
// focal term. A tile's sums are reduced per warp in a fixed tree (doubles)
// onto the warp's row in shared memory; a block writes its image's four
// sums into its slot. The last block to finish (an integer ticket) reduces
// the partials, a warp an image, in one parallel pass in a fixed order, writes
// the losses and returns the ticket to 0: a run repeats bit for bit (no
// float atomics) and the next launch needs no fill. Two launches must not
// share a ticket at once; the wrapper keeps one per device and stream, and
// work on one stream runs in order. It also writes each anchor's argmax
// (int32) and flags (bit 0 positive, bit 1 positive or negative).
//
// The cull. The plain loop starts from best = -1, arg = 0 and keeps the
// first label of strictly greater IoU; an invalid label (-1) never wins.
// Let W be the hull of a warp's anchors (min x0, min y0, max x1, max y1). A
// label with h.x0 >= W.x1, h.x1 <= W.x0, h.y0 >= W.y1 or h.y1 <= W.y0 is
// disjoint: at every anchor of the warp min(x1, hx1) - max(x0, hx0) is <= 0
// or NaN (a hull that only touches W gives exactly 0), so its IoU is +-0 or
// NaN. NaN never beats best, and +-0 beats it only while best is still -1.
// Let f be the first valid label whose hull lies within +-2^60: if the
// warp's anchors lie within +-2^60 too, no intermediate overflows, so f's
// IoU is a number >= 0 at every anchor and best >= 0 from f on. The warp
// therefore keeps every valid label up to f, and after f every valid label
// it cannot prove disjoint; a warp with an anchor outside +-2^60 (or NaN)
// keeps every valid label. A NaN hull coordinate fails every comparison, so
// such a label is kept and evaluated (its IoU is NaN, as the plain version
// finds). The argmax is then bit-equal to the plain loop's, and an image's
// 32 labels cost a warp a few IoU divisions instead of 32.
//
// Backward: a block of kThreads anchors of one image, a warp per 32, three
// blocks a SM (no label table, no block barrier, no reduction: nothing for
// a persistent grid to amortize). Each thread recomputes its terms'
// derivatives from the saved assignment, scaled by grad_output / B / num_pos
// (and / 20 for the regression term), in two rounds of loads: flags, argmax
// and classification; then, at a positive anchor, its label row (an L2
// hit), anchor and regression. The warp builds its 32 rows of d
// classification and d regression in shared memory and writes each as one
// contiguous run of 16-byte stores. The clamp's derivative is JAX's: 0.5 at
// exactly either bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // anchors a tile
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;  // anchors a cull (one warp)
constexpr int kMaxLabels = 64;
constexpr int kMaxClasses = 16;
constexpr int kReg = 12;
constexpr int kAnn = 21;
constexpr int kSms = 132;
constexpr int kBlocksPerSm = 2;
constexpr int kSlots = kSms * kBlocksPerSm;  // forward blocks at most
constexpr int kBackwardBlocksPerSm = 3;  // <= 85 registers: three backward blocks a SM
constexpr int kHeaderBytes = 528;  // forward shared memory before the label table
constexpr int kLabelBytes = 140;  // a label's row of the table: hull 16, area 4, class 4, targets 80, axes 24, norms 12

constexpr float kAlpha = 0.25f;
constexpr float kClsLo = static_cast<float>(1e-4);
constexpr float kClsHi = static_cast<float>(1.0 - 1e-4);
constexpr float kBeta = static_cast<float>(1.0 / 9.0);
constexpr float kHalfOverBeta = static_cast<float>(0.5 / (1.0 / 9.0));
constexpr float kHalfBeta = static_cast<float>(0.5 * (1.0 / 9.0));
constexpr float kTopWeight = 0.5f;
constexpr float kNormEps = 1e-12f;
constexpr float kBig = 1152921504606846976.0f;  // 2^60: products and sums of such values stay finite
constexpr unsigned kFull = 0xffffffffu;

// corner sign pattern of models/decode.py (length, width, height vectors)
__constant__ float kSigns[8][3] = {
    {-1.f, -1.f, 1.f}, {-1.f, 1.f, 1.f}, {1.f, -1.f, 1.f}, {1.f, 1.f, 1.f},
    {-1.f, -1.f, -1.f}, {-1.f, 1.f, -1.f}, {1.f, -1.f, -1.f}, {1.f, 1.f, -1.f},
};
// The x column of the q-th corner coordinate summed (plus) or subtracted for
// axis i: l' = back - front (4,6,12,14 - 0,2,8,10), w' = right - left
// (2,6,10,14 - 0,4,8,12), h' = bottom - top (0,2,4,6 - 8,10,12,14), one
// nibble each. A compile-time index keeps the label row in registers.
__device__ __forceinline__ constexpr int axis_col(int i, int q, bool plus) {
  return static_cast<int>(((plus ? (i == 0 ? 0xEC64u : i == 1 ? 0xEA62u : 0x6420u)
                                 : (i == 0 ? 0xA820u : i == 1 ? 0xC840u : 0xECA8u)) >> (4 * q)) & 15u);
}

// torch.minimum / torch.maximum (and clamp): NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float clamp_cls(float c) { return c != c ? c : fminf(fmaxf(c, kClsLo), kClsHi); }
__device__ __forceinline__ bool bounded(float x) { return fabsf(x) <= kBig; }  // false for NaN

// The forward's label table in shared memory: R rows, an image's labels.
struct Labels {
  float4* hull;
  float* area;
  int* cls;
  float* t;  // [R][20]
  float* axis;  // [R][3][2]
  float* tn;  // [R][3]
};

__device__ __forceinline__ Labels label_table(unsigned char* p, int R) {
  Labels L;
  L.hull = reinterpret_cast<float4*>(p);
  L.area = reinterpret_cast<float*>(p + 16 * R);
  L.cls = reinterpret_cast<int*>(p + 20 * R);
  L.t = reinterpret_cast<float*>(p + 24 * R);
  L.axis = reinterpret_cast<float*>(p + 104 * R);
  L.tn = reinterpret_cast<float*>(p + 128 * R);
  return L;
}

// A label's three target axis vectors (in pixels) and their norms, in the
// plain version's op order.
__device__ __forceinline__ void label_axes(const float* v, float axis[3][2], float tn[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float px = 0.0f, py = 0.0f, mx = 0.0f, my = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      px = px + v[axis_col(i, q, true)];
      py = py + v[axis_col(i, q, true) + 1];
      mx = mx + v[axis_col(i, q, false)];
      my = my + v[axis_col(i, q, false) + 1];
    }
    axis[i][0] = (px - mx) / 4.0f;
    axis[i][1] = (py - my) / 4.0f;
    tn[i] = sqrtf(axis[i][0] * axis[i][0] + axis[i][1] * axis[i][1] + kNormEps);
  }
}

// Stage image b's M labels (thread m takes row m); every thread calls it,
// between two barriers. bits[0..1] get the ballot of "label valid" over
// labels 0-31 and 32-63, bits[2..3] of "valid with a hull within 2^60".
__device__ void stage_labels(const Labels& L, unsigned* bits, const float* __restrict__ ann, long long b, int M) {
  // The rows are read once, coalesced, into the room of the targets, axes
  // and norms (116 bytes a row, 84 needed): every block reads the same few
  // kilobytes at once, and one strided read per row multiplied the requests.
  // A thread issues all its loads before it stores any: one round trip.
  float* raw = L.t;
  const float* src = ann + b * M * kAnn;
  constexpr int kPer = (kMaxLabels * kAnn + kThreads - 1) / kThreads;
  float w[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    w[q] = e < M * kAnn ? src[e] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < M * kAnn) raw[e] = w[q];
  }
  __syncthreads();
  const int j = threadIdx.x;
  float v[kAnn];
  if (j < M) {
#pragma unroll
    for (int q = 0; q < kAnn; ++q) v[q] = raw[j * kAnn + q];
  }
  __syncthreads();  // every row read before the table overwrites them
  if (j < M) {
    float x0 = v[0], x1 = v[0], y0 = v[1], y1 = v[1];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      x0 = tmin(x0, v[2 * k]);
      x1 = tmax(x1, v[2 * k]);
      y0 = tmin(y0, v[2 * k + 1]);
      y1 = tmax(y1, v[2 * k + 1]);
    }
    L.hull[j] = make_float4(x0, y0, x1, y1);
    L.area[j] = (x1 - x0) * (y1 - y0);
    L.cls[j] = static_cast<int>(v[20]);  // truncates, as astype(int32)
#pragma unroll
    for (int q = 0; q < 20; ++q) L.t[j * 20 + q] = v[q];
    float axis[3][2], tn[3];
    label_axes(v, axis, tn);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      L.axis[j * 6 + 2 * i] = axis[i][0];
      L.axis[j * 6 + 2 * i + 1] = axis[i][1];
      L.tn[j * 3 + i] = tn[i];
    }
  }
  if (j < 64) {  // warps 0 and 1 (warp-uniform)
    const bool valid = j < M && v[20] >= 0.0f;
    const float4 h = valid ? L.hull[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const bool inside = valid && bounded(h.x) && bounded(h.y) && bounded(h.z) && bounded(h.w);
    const unsigned vb = __ballot_sync(kFull, valid), ib = __ballot_sync(kFull, inside);
    if ((j & 31) == 0) {
      bits[j >> 5] = vb;
      bits[2 + (j >> 5)] = ib;
    }
  }
}

// The predicted value j of the 20 (8 composed corners, then the 2D box) and
// its anchor-normalized target.
__device__ __forceinline__ float pred20(const float* r, int j) {
  if (j >= 16) return r[8 + (j - 16)];
  const int k = j >> 1, d = j & 1;
  return ((r[d] + kSigns[k][0] * r[2 + d]) + kSigns[k][1] * r[4 + d]) + kSigns[k][2] * r[6 + d];
}

struct Anchor {
  float x0, y0, x1, y1, w, h, cx, cy;
};

__device__ __forceinline__ Anchor make_anchor(float4 v) {
  Anchor r;
  r.x0 = v.x;
  r.y0 = v.y;
  r.x1 = v.z;
  r.y1 = v.w;
  r.w = r.x1 - r.x0;
  r.h = r.y1 - r.y0;
  r.cx = r.x0 + 0.5f * r.w;
  r.cy = r.y0 + 0.5f * r.h;
  return r;
}

__device__ __forceinline__ float target20(const float* t, const Anchor& an, int j) {
  return (j & 1) ? (t[j] - an.cy) / an.h : (t[j] - an.cx) / an.w;
}

__device__ __forceinline__ float4 load_anchor(const float* __restrict__ anchors, int a, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(anchors) + a);
  const float* p = anchors + 4LL * a;
  return make_float4(p[0], p[1], p[2], p[3]);
}

// KV: K rounded up to a multiple of 4 (the unrolled width); entries >= K are 0.
template <int KV>
__device__ __forceinline__ void load_cls(const float* __restrict__ row, int K, bool vec, float (&c)[KV]) {
  if (vec && (K & 3) == 0) {
#pragma unroll
    for (int q = 0; q < KV / 4; ++q) {
      const float4 v = 4 * q < K ? __ldg(reinterpret_cast<const float4*>(row) + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < KV; ++k) c[k] = k < K ? row[k] : 0.0f;
  }
}

__device__ __forceinline__ void load_reg(const float* __restrict__ row, bool vec, float (&r)[kReg]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row) + q);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kReg; ++j) r[j] = row[j];
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;  // lane 0's is the warp's sum, in a fixed tree
}

// Sum four per-thread doubles over the block in a fixed tree; thread 0 gets
// them in out. Every thread calls it.
__device__ void block_sum4(const double (&v)[4], double* red, double (&out)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = warp_sum(v[q]);
  __syncthreads();  // the last call's reads of red are done
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) red[warp * 4 + q] = w[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) out[q] = 0.0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) out[q] += red[i * 4 + q];
    }
  }
}

// The plain version's IoU of anchor an (area area_a) and a label hull h
// (area area_b). kExact: torch's NaN-passing min / max / clamp; else fminf /
// fmaxf, which give the same values where no operand is NaN or infinite (a
// zero's sign aside, which no comparison sees). The quick form took 0.4 us
// off a 32 us forward at batch 4 x 512x768 (H100 80GB HBM3, 700 W).
template <bool kExact>
__device__ __forceinline__ float iou_of(float4 an, float area_a, float4 h, float area_b) {
  if (kExact) {
    const float iw = tmax(tmin(an.z, h.z) - tmax(an.x, h.x), 0.0f);
    const float ih = tmax(tmin(an.w, h.w) - tmax(an.y, h.y), 0.0f);
    const float inter = iw * ih;
    return inter / tmax(area_a + area_b - inter, 1e-8f);
  }
  const float iw = fmaxf(fminf(an.z, h.z) - fmaxf(an.x, h.x), 0.0f);
  const float ih = fmaxf(fminf(an.w, h.w) - fmaxf(an.y, h.y), 0.0f);
  const float inter = iw * ih;
  return inter / fmaxf(area_a + area_b - inter, 1e-8f);
}

// The first label of strictly greatest IoU over the labels in mask, in
// label order. Four labels at a time while four
// are left: their IoUs are independent (four division chains in flight),
// then taken in order.
template <bool kExact>
__device__ __forceinline__ void argmax_labels(unsigned long long mk, const Labels& L, float4 an, float area_a,
                                              float& best, int& arg) {
  while (__popcll(mk) >= 4) {
    int m[4];
    float q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      m[u] = __ffsll(static_cast<long long>(mk)) - 1;
      mk &= mk - 1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = iou_of<kExact>(an, area_a, L.hull[m[u]], L.area[m[u]]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q[u] > best) {
        best = q[u];
        arg = m[u];
      }
    }
  }
  for (; mk; mk &= mk - 1) {
    const int m = __ffsll(static_cast<long long>(mk)) - 1;
    const float q = iou_of<kExact>(an, area_a, L.hull[m], L.area[m]);
    if (q > best) {
      best = q;
      arg = m;
    }
  }
}

// The forward's fixed work split (ops/focal_loss.py::launch_plan, the same
// rule): ppi = min(kSlots / B, tiles) blocks an image, at least one. Block
// g = b * ppi + p walks image b's tiles p, p + ppi, ... (a stride, so a
// crowded region of the image is shared out), which fixes the tile-to-block
// map and so the order of every sum, and writes the image's four sums into
// slot p of partials [B][ppi][4].
struct Plan {
  int tiles, ppi, grid;
};

Plan make_plan(int B, int A) {
  Plan p;
  p.tiles = (A + kThreads - 1) / kThreads;
  p.ppi = kSlots / B < p.tiles ? kSlots / B : p.tiles;
  if (p.ppi < 1) p.ppi = 1;
  p.grid = B * p.ppi;
  return p;
}

// header: red and the warps' sums, [kWarps][4] doubles each; the label bits
constexpr int kBitsOffset = 2 * kWarps * 4 * 8;
static_assert(kBitsOffset + 4 * 4 <= kHeaderBytes && kHeaderBytes % 16 == 0, "header");

// Forward shared memory: the header, then the label table (M rows).
int forward_smem(int M) { return kHeaderBytes + M * kLabelBytes; }
int backward_smem(int K) { return kThreads * (K + kReg) * static_cast<int>(sizeof(float)); }

template <int KV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
focal_forward_kernel(const float* __restrict__ cls, const float* __restrict__ reg, const float* __restrict__ ann,
                     const float* __restrict__ anchors, int B, int A, int K, int M, Plan plan, bool vec,
                     int* __restrict__ argmax_out, uint8_t* __restrict__ flags_out, double* __restrict__ partials,
                     unsigned int* __restrict__ ticket, float* __restrict__ num_pos_out, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  double* wacc = red + kWarps * 4;  // [kWarps][4]: each warp's sums of the image
  unsigned* bits = reinterpret_cast<unsigned*>(smem + kBitsOffset);
  const Labels L = label_table(smem + kHeaderBytes, M);
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = plan.tiles, g = blockIdx.x;
  const long long b = g / plan.ppi;  // this block's image, and its first tile
  int t = g % plan.ppi;

  float4 an = make_float4(0.f, 0.f, 0.f, 0.f), an_next = an;
  float c[KV], c_next[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) c[k] = c_next[k] = 0.0f;
  auto fetch = [&](int ft, float4& an_o, float (&c_o)[KV]) {
    const int a = ft * kThreads + tid;
    if (a < A) {
      an_o = load_anchor(anchors, a, vec);
      load_cls<KV>(cls + (b * A + a) * K, K, vec, c_o);
    }
  };
  fetch(t, an, c);

  // stage the image's labels and zero the warps' sums
  if (tid < kWarps * 4) wacc[tid] = 0.0;
  stage_labels(L, bits, ann, b, M);
  __syncthreads();
  const unsigned long long valid = (static_cast<unsigned long long>(bits[1]) << 32) | bits[0];
  const unsigned long long inside = (static_cast<unsigned long long>(bits[3]) << 32) | bits[2];
  const int f = inside ? __ffsll(static_cast<long long>(inside)) - 1 : 64;
  const unsigned long long prefix = f >= 63 ? valid : valid & ((2ull << f) - 1ull);

  for (; t < T; t += plan.ppi) {
    if (t + plan.ppi < T) fetch(t + plan.ppi, an_next, c_next);

    const int a = t * kThreads + tid;
    if (t * kThreads + warp * kGroup < A) {  // warp-uniform: the warp has anchors
      const bool in = a < A;
      // the warp's anchor hull, and whether every anchor lies within 2^60
      float w0 = in ? an.x : __int_as_float(0x7f800000), w1 = in ? an.y : __int_as_float(0x7f800000);
      float w2 = in ? an.z : -__int_as_float(0x7f800000), w3 = in ? an.w : -__int_as_float(0x7f800000);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        w0 = fminf(w0, __shfl_xor_sync(kFull, w0, o));
        w1 = fminf(w1, __shfl_xor_sync(kFull, w1, o));
        w2 = fmaxf(w2, __shfl_xor_sync(kFull, w2, o));
        w3 = fmaxf(w3, __shfl_xor_sync(kFull, w3, o));
      }
      const bool ok = !in || (bounded(an.x) && bounded(an.y) && bounded(an.z) && bounded(an.w));
      const bool fast = __all_sync(kFull, ok);
      unsigned long long keep = valid, dis = 0;
      if (fast) {
        bool d0 = false, d1 = false;
        if (lane < M) {
          const float4 h = L.hull[lane];
          d0 = h.x >= w2 || h.z <= w0 || h.y >= w3 || h.w <= w1;
        }
        if (lane + 32 < M) {
          const float4 h = L.hull[lane + 32];
          d1 = h.x >= w2 || h.z <= w0 || h.y >= w3 || h.w <= w1;
        }
        dis = (static_cast<unsigned long long>(__ballot_sync(kFull, d1)) << 32) | __ballot_sync(kFull, d0);
        keep = prefix | (valid & ~dis);
      }
      // The prefix is label f alone (nothing valid before it) and f is
      // disjoint: its IoU is 0 at every anchor, so the loop would start
      // from best 0, arg f; start there.
      float best0 = -1.0f;
      int arg0 = 0;
      if (fast && f < 64 && prefix == (1ull << f) && ((dis >> f) & 1ull)) {
        best0 = 0.0f;
        arg0 = f;
        keep &= ~prefix;
      }

      double sums[4] = {0.0, 0.0, 0.0, 0.0};  // this anchor's cls, reg, vp, positive
      if (in) {
        const float area_a = (an.z - an.x) * (an.w - an.y);
        float best = best0;
        int arg = arg0;
        // labels within 2^60 at a warp within 2^60 meet no NaN or
        // infinity: the quick IoU (warp-uniform choice)
        if (fast && (keep & ~inside) == 0) {
          argmax_labels<false>(keep, L, an, area_a, best, arg);
        } else {
          argmax_labels<true>(keep, L, an, area_a, best, arg);
        }
        const bool has = valid != 0;
        const bool positive = (best >= 0.5f) && has;
        const bool negative = (best < 0.4f) || !has;
        const bool care = positive || negative;
        const long long ia = b * A + a;
        argmax_out[ia] = arg;
        flags_out[ia] = static_cast<uint8_t>((positive ? 1 : 0) | (care ? 2 : 0));
        float r[kReg];
        if (positive) load_reg(reg + ia * kReg, vec, r);  // in flight during the focal term

        float cls_sum = 0.0f;
        if (care) {
          const int cid = L.cls[arg];
#pragma unroll
          for (int k = 0; k < KV; ++k) {
            if (k < K) {
              const float x = clamp_cls(c[k]);
              const bool tk = positive && k == cid;
              const float alpha = tk ? kAlpha : 1.0f - kAlpha;
              const float fw = tk ? 1.0f - x : x;
              const float bce = -logf(tk ? x : 1.0f - x);  // one logarithm, chosen first
              cls_sum += alpha * (fw * fw) * bce;
            }
          }
        }
        sums[0] = cls_sum;
        if (positive) {
          const Anchor A4 = make_anchor(an);
          const float* tt = L.t + arg * 20;
          float reg_sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 20; ++j) {
            float diff = fabsf(target20(tt, A4, j) - pred20(r, j));
            if (j >= 8 && j < 16) diff = diff * kTopWeight;
            reg_sum += diff <= kBeta ? kHalfOverBeta * (diff * diff) : diff - kHalfBeta;
          }
          float vt[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float rx = r[2 + 2 * q], ry = r[3 + 2 * q];
            const float tx = L.axis[arg * 6 + 2 * q], ty = L.axis[arg * 6 + 2 * q + 1];
            const float rn = sqrtf(rx * rx + ry * ry + kNormEps);
            vt[q] = 1.0f - (rx * tx + ry * ty) / (rn * L.tn[arg * 3 + q]);
          }
          sums[1] = reg_sum;
          sums[2] = ((vt[0] + vt[1]) + vt[2]) / 3.0f;
          sums[3] = 1.0;
        }
      }
      // the warp's sums of this tile, in a fixed tree, onto its own row
#pragma unroll
      for (int q = 0; q < 4; ++q) sums[q] = warp_sum(sums[q]);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) wacc[warp * 4 + q] += sums[q];
      }
    }
    an = an_next;
#pragma unroll
    for (int k = 0; k < KV; ++k) c[k] = c_next[k];
  }

  __syncthreads();
  if (tid < 4) {
    // this block's four sums of its image, into its slot: partials [B][ppi][4], g = b * ppi + p
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += wacc[w * 4 + tid];
    partials[g * 4LL + tid] = v;
  }

  // the last block to finish reduces the partials in a fixed order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  double tot[4] = {0.0, 0.0, 0.0, 0.0};
  // warp w finishes images w, w + kWarps, ...; its lanes sum an image's slots
  for (int ib = warp; ib < B; ib += kWarps) {
    double sb[4] = {0.0, 0.0, 0.0, 0.0};
    const double2* pp = reinterpret_cast<const double2*>(partials) + static_cast<long long>(ib) * plan.ppi * 2;
#pragma unroll 4
    for (int sl = lane; sl < plan.ppi; sl += 32) {
      const double2 u = __ldcg(pp + 2 * sl), v = __ldcg(pp + 2 * sl + 1);
      sb[0] += u.x;
      sb[1] += u.y;
      sb[2] += v.x;
      sb[3] += v.y;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) sb[q] = warp_sum(sb[q]);
    if (lane == 0) {
      const float np = fmaxf(static_cast<float>(sb[3]), 1.0f);
      num_pos_out[ib] = np;
      tot[0] += static_cast<double>(static_cast<float>(sb[0]) / np);
      tot[1] += static_cast<double>(static_cast<float>(sb[1]) / (np * 20.0f));
      tot[2] += static_cast<double>(static_cast<float>(sb[2]) / np);
    }
  }
  double all[4];
  block_sum4(tot, red, all);
  if (tid == 0) {
    const float fb = static_cast<float>(B);
    out[0] = static_cast<float>(all[0]) / fb;
    out[1] = static_cast<float>(all[1]) / fb;
    out[2] = static_cast<float>(all[2]) / fb;
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

// n floats from shared src to global dst by one warp: 16-byte stores where
// dst is aligned, single floats at a ragged head and tail.
__device__ __forceinline__ void warp_store(float* __restrict__ dst, const float* src, int n, int lane) {
  int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) >> 2);
  head = head < n ? head : n;
  if (lane < head) dst[lane] = src[lane];
  const int body = head + ((n - head) & ~3);
  for (int j = head + 4 * lane; j < body; j += 128) {
    *reinterpret_cast<float4*>(dst + j) = make_float4(src[j], src[j + 1], src[j + 2], src[j + 3]);
  }
  if (body + lane < n) dst[body + lane] = src[body + lane];
}

template <int KV>
__global__ void __launch_bounds__(kThreads, kBackwardBlocksPerSm)
focal_backward_kernel(const float* __restrict__ cls, const float* __restrict__ reg, const float* __restrict__ ann,
                      const float* __restrict__ anchors, const int* __restrict__ argmax,
                      const uint8_t* __restrict__ flags, const float* __restrict__ num_pos,
                      const float* __restrict__ grad_out, int B, int A, int K, int M, bool vec,
                      float* __restrict__ dcls, float* __restrict__ dreg) {
  extern __shared__ __align__(16) float stage[];  // per warp: 32 rows of d classification, then of d regression
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.y;
  const int a0 = blockIdx.x * kThreads + warp * 32;
  if (a0 >= A) return;  // warp-uniform
  const int n = A - a0 < 32 ? A - a0 : 32;
  float* sc = stage + warp * 32 * (K + kReg);
  float* sr = sc + 32 * K;
  const int a = a0 + lane;
  const long long ia = b * A + a;

  float dc[KV], g[kReg];
#pragma unroll
  for (int k = 0; k < KV; ++k) dc[k] = 0.0f;
#pragma unroll
  for (int j = 0; j < kReg; ++j) g[j] = 0.0f;
  if (lane < n) {
    // two rounds of loads: flags, argmax and classification; then, at a
    // positive, its label row, anchor and regression
    float c[KV];
    const int f = flags[ia];
    const int arg = argmax[ia];
    load_cls<KV>(cls + ia * K, K, vec, c);
    const bool positive = f & 1, care = (f >> 1) & 1;
    const float np = num_pos[b];
    const float fb = static_cast<float>(B);
    float v[kAnn], r[kReg];
    float4 an4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (positive) {
      const float* row = ann + (b * M + arg) * kAnn;
#pragma unroll
      for (int j = 0; j < kAnn; ++j) v[j] = row[j];
      an4 = load_anchor(anchors, a, vec);
      load_reg(reg + ia * kReg, vec, r);
    }
    if (care) {
      const float g_cls = grad_out[0] / fb / np;
      const int cid = positive ? static_cast<int>(v[20]) : -1;
#pragma unroll
      for (int k = 0; k < KV; ++k) {
        if (k < K) {
          const float raw = c[k];
          const float x = clamp_cls(raw);
          const bool tk = positive && k == cid;
          const float alpha = tk ? kAlpha : 1.0f - kAlpha;
          const float fw = tk ? 1.0f - x : x;
          const float dfw = tk ? -1.0f : 1.0f;
          const float p = tk ? x : 1.0f - x;  // one logarithm and one division, chosen first
          const float bce = -logf(p);
          const float dbce = dfw / p;  // -1 / x or 1 / (1 - x)
          // d/dx of alpha * fw^2 * bce, times the clamp's derivative (JAX's
          // maximum/minimum split a tie: 0.5 at exactly either bound)
          const float dx = alpha * (2.0f * fw * dfw * bce + (fw * fw) * dbce);
          const float clamp_d = (raw == kClsLo || raw == kClsHi) ? 0.5f : (raw > kClsLo && raw < kClsHi ? 1.0f : 0.0f);
          dc[k] = g_cls * dx * clamp_d;
        }
      }
      if (positive) {
        const float g_reg = grad_out[1] / fb / (np * 20.0f);
        const float g_vp = grad_out[2] / fb / np / 3.0f;
        const Anchor an = make_anchor(an4);
#pragma unroll
        for (int j = 0; j < 20; ++j) {
          const float u = target20(v, an, j) - pred20(r, j);
          const float w = (j >= 8 && j < 16) ? kTopWeight : 1.0f;
          const float diff = fabsf(u) * w;
          const float dsl1 = diff <= kBeta ? kHalfOverBeta * (2.0f * diff) : 1.0f;
          // d|u|/d pred = -sign(u); sign(0) = 0
          const float dpred = g_reg * dsl1 * w * (u > 0.0f ? -1.0f : (u < 0.0f ? 1.0f : 0.0f));
          if (j >= 16) {
            g[8 + (j - 16)] += dpred;
          } else {
            const int k = j >> 1, dd = j & 1;
            g[dd] += dpred;
            g[2 + dd] += kSigns[k][0] * dpred;
            g[4 + dd] += kSigns[k][1] * dpred;
            g[6 + dd] += kSigns[k][2] * dpred;
          }
        }
        float axis[3][2], tn[3];
        label_axes(v, axis, tn);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float rx = r[2 + 2 * i], ry = r[3 + 2 * i];
          const float tx = axis[i][0], ty = axis[i][1];
          const float rn = sqrtf(rx * rx + ry * ry + kNormEps);
          const float dot = rx * tx + ry * ty;
          // d(1 - cos)/dr = -(t / (rn tn) - dot r / (rn^3 tn))
          const float rt = rn * tn[i];
          const float q = dot / (rn * rn);
          g[2 + 2 * i] += -g_vp * ((tx - q * rx) / rt);
          g[3 + 2 * i] += -g_vp * ((ty - q * ry) / rt);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      if (k < K) sc[lane * K + k] = dc[k];
    }
#pragma unroll
    for (int j = 0; j < kReg; ++j) sr[lane * kReg + j] = g[j];
  }
  __syncwarp();
  warp_store(dcls + (b * A + a0) * K, sc, n * K, lane);
  warp_store(dreg + (b * A + a0) * kReg, sr, n * kReg, lane);
}

bool shapes_ok(int B, int A, int K, int M) {
  return B >= 1 && B <= 65535 && A >= 1 && K >= 1 && K <= kMaxClasses && M >= 1 && M <= kMaxLabels &&
         static_cast<long long>(B) * A * kReg < (1LL << 40);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int KV>
void launch_forward(const float* cls, const float* reg, const float* ann, const float* anchors, int B, int A, int K,
                    int M, const Plan& p, bool vec, int* argmax, uint8_t* flags, double* partials,
                    unsigned* ticket, float* num_pos, float* out, cudaStream_t stream) {
  focal_forward_kernel<KV><<<p.grid, kThreads, forward_smem(M), stream>>>(
      cls, reg, ann, anchors, B, A, K, M, p, vec, argmax, flags, partials, ticket, num_pos, out);
}

template <int KV>
void launch_backward(const float* cls, const float* reg, const float* ann, const float* anchors, const int* argmax,
                     const uint8_t* flags, const float* num_pos, const float* grad_out, int B, int A, int K, int M,
                     bool vec, float* dcls, float* dreg, cudaStream_t stream) {
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  focal_backward_kernel<KV><<<grid, kThreads, backward_smem(K), stream>>>(
      cls, reg, ann, anchors, argmax, flags, num_pos, grad_out, B, A, K, M, vec, dcls, dreg);
}

}  // namespace

extern "C" {

// Forward: losses (cls, reg, vp) -> out[3], per-image clamped positive
// counts -> num_pos[B], per-anchor argmax [B,A] int32 and flags [B,A] uint8.
// grid and smem_bytes are launch_plan's (refused unless this side computes
// the same); partials holds 4 * grid doubles; ticket one unsigned int that
// is 0 at the launch and is 0 again when the launch ends. Returns the
// cudaError_t of the launch.
int focal_loss_forward(const void* cls, const void* reg, const void* ann, const void* anchors, int B, int A, int K,
                       int M, int grid, int smem_bytes, void* argmax, void* flags, void* partials, void* ticket,
                       void* num_pos, void* out, void* stream) {
  if (!shapes_ok(B, A, K, M)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, A);
  if (p.grid != grid || forward_smem(M) != smem_bytes) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = aligned16(cls) && aligned16(reg) && aligned16(anchors);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const float*>(cls);
  auto* r = static_cast<const float*>(reg);
  auto* an = static_cast<const float*>(ann);
  auto* anc = static_cast<const float*>(anchors);
  auto* am = static_cast<int*>(argmax);
  auto* fl = static_cast<uint8_t*>(flags);
  auto* pa = static_cast<double*>(partials);
  auto* tk = static_cast<unsigned*>(ticket);
  auto* np = static_cast<float*>(num_pos);
  auto* o = static_cast<float*>(out);
  switch ((K + 3) / 4) {
    case 1: launch_forward<4>(c, r, an, anc, B, A, K, M, p, vec, am, fl, pa, tk, np, o, s); break;
    case 2: launch_forward<8>(c, r, an, anc, B, A, K, M, p, vec, am, fl, pa, tk, np, o, s); break;
    case 3: launch_forward<12>(c, r, an, anc, B, A, K, M, p, vec, am, fl, pa, tk, np, o, s); break;
    default: launch_forward<16>(c, r, an, anc, B, A, K, M, p, vec, am, fl, pa, tk, np, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: grad_out[3] (d loss / d cls, reg, vp outputs) -> dcls [B,A,K],
// dreg [B,A,12], every element written. smem_bytes is launch_plan's.
int focal_loss_backward(const void* cls, const void* reg, const void* ann, const void* anchors, const void* argmax,
                        const void* flags, const void* num_pos, const void* grad_out, int B, int A, int K, int M,
                        int smem_bytes, void* dcls, void* dreg, void* stream) {
  if (!shapes_ok(B, A, K, M)) return static_cast<int>(cudaErrorInvalidValue);
  if (backward_smem(K) != smem_bytes) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = aligned16(cls) && aligned16(reg) && aligned16(anchors);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const float*>(cls);
  auto* r = static_cast<const float*>(reg);
  auto* an = static_cast<const float*>(ann);
  auto* anc = static_cast<const float*>(anchors);
  auto* am = static_cast<const int*>(argmax);
  auto* fl = static_cast<const uint8_t*>(flags);
  auto* np = static_cast<const float*>(num_pos);
  auto* go = static_cast<const float*>(grad_out);
  auto* dc = static_cast<float*>(dcls);
  auto* dr = static_cast<float*>(dreg);
  switch ((K + 3) / 4) {
    case 1: launch_backward<4>(c, r, an, anc, am, fl, np, go, B, A, K, M, vec, dc, dr, s); break;
    case 2: launch_backward<8>(c, r, an, anc, am, fl, np, go, B, A, K, M, vec, dc, dr, s); break;
    case 3: launch_backward<12>(c, r, an, anc, am, fl, np, go, B, A, K, M, vec, dc, dr, s); break;
    default: launch_backward<16>(c, r, an, anc, am, fl, np, go, B, A, K, M, vec, dc, dr, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
