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
// -fmad=false and divides in IEEE round-to-nearest, so the IoU, and with it
// the assignment (argmax, positive, negative), equals the plain version's
// bit for bit.
//
// Forward: a block of kThreads anchors of one image (grid: anchor tiles x
// images). The image's labels are staged in shared memory: 2D hull, area,
// class id, the 20 targets, the three target axis vectors and their norms.
// Each thread takes the first label of strictly greatest IoU in label order
// (the fori_loop's argmax, ties included), then its focal term over K, and
// for a positive anchor its smooth-L1 term over 20 values and its vp term.
// A block's four sums (cls, reg, vp, positives) go to a partials buffer in
// double; the last block to finish (an integer ticket) reduces them tile by
// tile in a fixed order, so a run repeats bit for bit (no float atomics). It
// also writes the per-image positive count, clamped to >= 1, and each
// anchor's argmax (int32) and flags (bit 0 positive, bit 1 positive or
// negative) for the backward.
//
// Backward: a thread per anchor recomputes its terms' derivatives from the
// saved assignment, scaled by grad_output / B / num_pos (and / 20 for the
// regression term), and writes d classification and d regression for every
// anchor (zeros where the anchor does not count). The clamp's derivative is
// JAX's: 0.5 at exactly either bound.
//
// Bound on this card: bytes. The forward reads classification, regression
// and the anchors once (68.5 MB at 1080x1920, batch 2) and writes 5 bytes an
// anchor; the backward reads them again with the assignment and writes both
// gradients. The design stays simple: one pass, scalar loads (a warp's
// anchors are contiguous, so each line is fetched once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLabels = 64;
constexpr int kMaxClasses = 16;
constexpr int kReg = 12;
constexpr int kAnn = 21;

constexpr float kAlpha = 0.25f;
constexpr float kClsLo = static_cast<float>(1e-4);
constexpr float kClsHi = static_cast<float>(1.0 - 1e-4);
constexpr float kBeta = static_cast<float>(1.0 / 9.0);
constexpr float kHalfOverBeta = static_cast<float>(0.5 / (1.0 / 9.0));
constexpr float kHalfBeta = static_cast<float>(0.5 * (1.0 / 9.0));
constexpr float kTopWeight = 0.5f;
constexpr float kNormEps = 1e-12f;

// corner sign pattern of models/decode.py (length, width, height vectors)
__constant__ float kSigns[8][3] = {
    {-1.f, -1.f, 1.f}, {-1.f, 1.f, 1.f}, {1.f, -1.f, 1.f}, {1.f, 1.f, 1.f},
    {-1.f, -1.f, -1.f}, {-1.f, 1.f, -1.f}, {1.f, -1.f, -1.f}, {1.f, 1.f, -1.f},
};
// x columns of the 16 corner coordinates summed (plus) and subtracted
// (minus) for each axis: l' = back - front, w' = right - left, h' = bottom - top
__constant__ int kAxisPlus[3][4] = {{4, 6, 12, 14}, {2, 6, 10, 14}, {0, 2, 4, 6}};
__constant__ int kAxisMinus[3][4] = {{0, 2, 8, 10}, {0, 4, 8, 12}, {8, 10, 12, 14}};

struct Labels {
  float hull[kMaxLabels][4];
  float area[kMaxLabels];
  int valid[kMaxLabels];
  int cls[kMaxLabels];
  float t[kMaxLabels][20];
  float axis[kMaxLabels][3][2];
  float tn[kMaxLabels][3];
  int has_objects;
};

// Stage image b's M labels (thread m takes label m).
__device__ void load_labels(Labels& s, const float* __restrict__ ann, int b, int M) {
  const int m = threadIdx.x;
  if (m == 0) s.has_objects = 0;
  __syncthreads();
  if (m < M) {
    const float* row = ann + (static_cast<long long>(b) * M + m) * kAnn;
    float v[kAnn];
#pragma unroll
    for (int j = 0; j < kAnn; ++j) v[j] = row[j];
    float x0 = v[0], x1 = v[0], y0 = v[1], y1 = v[1];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      x0 = fminf(x0, v[2 * k]);
      x1 = fmaxf(x1, v[2 * k]);
      y0 = fminf(y0, v[2 * k + 1]);
      y1 = fmaxf(y1, v[2 * k + 1]);
    }
    s.hull[m][0] = x0;
    s.hull[m][1] = y0;
    s.hull[m][2] = x1;
    s.hull[m][3] = y1;
    s.area[m] = (x1 - x0) * (y1 - y0);
    const int valid = v[20] >= 0.0f;
    s.valid[m] = valid;
    s.cls[m] = static_cast<int>(v[20]);  // truncates, as astype(int32)
#pragma unroll
    for (int j = 0; j < 20; ++j) s.t[m][j] = v[j];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float px = 0.0f, py = 0.0f, mx = 0.0f, my = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        px = px + v[kAxisPlus[i][q]];
        py = py + v[kAxisPlus[i][q] + 1];
        mx = mx + v[kAxisMinus[i][q]];
        my = my + v[kAxisMinus[i][q] + 1];
      }
      const float tx = (px - mx) / 4.0f;
      const float ty = (py - my) / 4.0f;
      s.axis[m][i][0] = tx;
      s.axis[m][i][1] = ty;
      s.tn[m][i] = sqrtf(tx * tx + ty * ty + kNormEps);
    }
    if (valid) atomicOr(&s.has_objects, 1);  // an integer flag: order-free
  }
  __syncthreads();
}

struct Anchor {
  float x0, y0, x1, y1, w, h, cx, cy;
};

__device__ __forceinline__ Anchor load_anchor(const float* __restrict__ anchors, int a) {
  Anchor r;
  r.x0 = anchors[4LL * a];
  r.y0 = anchors[4LL * a + 1];
  r.x1 = anchors[4LL * a + 2];
  r.y1 = anchors[4LL * a + 3];
  r.w = r.x1 - r.x0;
  r.h = r.y1 - r.y0;
  r.cx = r.x0 + 0.5f * r.w;
  r.cy = r.y0 + 0.5f * r.h;
  return r;
}

// The predicted value j of the 20 (8 composed corners, then the 2D box) and
// its anchor-normalized target.
__device__ __forceinline__ float pred20(const float* r, int j) {
  if (j >= 16) return r[8 + (j - 16)];
  const int k = j >> 1, d = j & 1;
  return ((r[d] + kSigns[k][0] * r[2 + d]) + kSigns[k][1] * r[4 + d]) + kSigns[k][2] * r[6 + d];
}

__device__ __forceinline__ float target20(const float* t, const Anchor& an, int j) {
  return (j & 1) ? (t[j] - an.cy) / an.h : (t[j] - an.cx) / an.w;
}

__device__ __forceinline__ float clamp_cls(float c) { return fminf(fmaxf(c, kClsLo), kClsHi); }

// Sum a per-thread double over the block in a fixed tree; thread 0 gets it.
__device__ double block_sum(double v, double* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
focal_forward_kernel(const float* __restrict__ cls, const float* __restrict__ reg, const float* __restrict__ ann,
                     const float* __restrict__ anchors, int B, int A, int K, int M, int* __restrict__ argmax_out,
                     uint8_t* __restrict__ flags_out, double* __restrict__ partials, unsigned int* __restrict__ ticket,
                     float* __restrict__ num_pos_out, float* __restrict__ out) {
  __shared__ Labels s;
  __shared__ double scratch[kThreads / 32];
  __shared__ int s_last;
  const int b = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  load_labels(s, ann, b, M);

  float cls_sum = 0.0f, reg_sum = 0.0f, vp_sum = 0.0f, pos_f = 0.0f;
  if (a < A) {
    const Anchor an = load_anchor(anchors, a);
    const float area_a = (an.x1 - an.x0) * (an.y1 - an.y0);
    float best = -1.0f;
    int arg = 0;
    for (int m = 0; m < M; ++m) {
      float iou = -1.0f;
      if (s.valid[m]) {
        const float iw = fmaxf(fminf(an.x1, s.hull[m][2]) - fmaxf(an.x0, s.hull[m][0]), 0.0f);
        const float ih = fmaxf(fminf(an.y1, s.hull[m][3]) - fmaxf(an.y0, s.hull[m][1]), 0.0f);
        const float inter = iw * ih;
        iou = inter / fmaxf(area_a + s.area[m] - inter, 1e-8f);
      }
      if (iou > best) {
        best = iou;
        arg = m;
      }
    }
    const bool has = s.has_objects != 0;
    const bool positive = (best >= 0.5f) && has;
    const bool negative = (best < 0.4f) || !has;
    const bool care = positive || negative;
    const long long ia = static_cast<long long>(b) * A + a;
    argmax_out[ia] = arg;
    flags_out[ia] = static_cast<uint8_t>((positive ? 1 : 0) | (care ? 2 : 0));

    if (care) {
      const int cid = s.cls[arg];
      const float* c = cls + ia * K;
      for (int k = 0; k < K; ++k) {
        const float x = clamp_cls(c[k]);
        const bool t = positive && k == cid;
        const float alpha = t ? kAlpha : 1.0f - kAlpha;
        const float fw = t ? 1.0f - x : x;
        const float bce = t ? -logf(x) : -logf(1.0f - x);
        cls_sum += alpha * (fw * fw) * bce;
      }
    }
    if (positive) {
      pos_f = 1.0f;
      float r[kReg];
      const float* rp = reg + ia * kReg;
#pragma unroll
      for (int j = 0; j < kReg; ++j) r[j] = rp[j];
      const float* t = s.t[arg];
#pragma unroll
      for (int j = 0; j < 20; ++j) {
        float diff = fabsf(target20(t, an, j) - pred20(r, j));
        if (j >= 8 && j < 16) diff = diff * kTopWeight;
        reg_sum += diff <= kBeta ? kHalfOverBeta * (diff * diff) : diff - kHalfBeta;
      }
      float terms[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float rx = r[2 + 2 * i], ry = r[3 + 2 * i];
        const float tx = s.axis[arg][i][0], ty = s.axis[arg][i][1];
        const float rn = sqrtf(rx * rx + ry * ry + kNormEps);
        terms[i] = 1.0f - (rx * tx + ry * ty) / (rn * s.tn[arg][i]);
      }
      vp_sum = ((terms[0] + terms[1]) + terms[2]) / 3.0f;
    }
  }

  const int tiles = gridDim.x;
  const double sums[4] = {cls_sum, reg_sum, vp_sum, pos_f};
  for (int q = 0; q < 4; ++q) {
    const double total = block_sum(sums[q], scratch);
    if (threadIdx.x == 0) partials[(static_cast<long long>(b) * tiles + blockIdx.x) * 4 + q] = total;
  }

  // the last block to finish reduces every image's partials in tile order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float tot_cls = 0.0f, tot_reg = 0.0f, tot_vp = 0.0f;
  for (int bb = 0; bb < B; ++bb) {
    double img[4];
    for (int q = 0; q < 4; ++q) {
      double v = 0.0;
      for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
        v += __ldcg(&partials[(static_cast<long long>(bb) * tiles + tile) * 4 + q]);
      }
      img[q] = block_sum(v, scratch);
    }
    if (threadIdx.x == 0) {
      const float np = fmaxf(static_cast<float>(img[3]), 1.0f);
      num_pos_out[bb] = np;
      tot_cls = tot_cls + static_cast<float>(img[0]) / np;
      tot_reg = tot_reg + static_cast<float>(img[1]) / (np * 20.0f);
      tot_vp = tot_vp + static_cast<float>(img[2]) / np;
    }
  }
  if (threadIdx.x == 0) {
    out[0] = tot_cls / static_cast<float>(B);
    out[1] = tot_reg / static_cast<float>(B);
    out[2] = tot_vp / static_cast<float>(B);
  }
}

__global__ void __launch_bounds__(kThreads)
focal_backward_kernel(const float* __restrict__ cls, const float* __restrict__ reg, const float* __restrict__ ann,
                      const float* __restrict__ anchors, const int* __restrict__ argmax,
                      const uint8_t* __restrict__ flags, const float* __restrict__ num_pos,
                      const float* __restrict__ grad_out, int B, int A, int K, int M, float* __restrict__ dcls,
                      float* __restrict__ dreg) {
  __shared__ Labels s;
  const int b = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  load_labels(s, ann, b, M);
  if (a >= A) return;

  const long long ia = static_cast<long long>(b) * A + a;
  const int f = flags[ia];
  const bool positive = f & 1, care = (f >> 1) & 1;
  const int arg = argmax[ia];
  const float np = num_pos[b];
  const float fb = static_cast<float>(B);
  const float g_cls = grad_out[0] / fb / np;
  const float g_reg = grad_out[1] / fb / (np * 20.0f);
  const float g_vp = grad_out[2] / fb / np / 3.0f;

  const float* c = cls + ia * K;
  float* dc = dcls + ia * K;
  const int cid = s.cls[arg];
  for (int k = 0; k < K; ++k) {
    float d = 0.0f;
    if (care) {
      const float raw = c[k];
      const float x = clamp_cls(raw);
      const bool t = positive && k == cid;
      const float alpha = t ? kAlpha : 1.0f - kAlpha;
      const float fw = t ? 1.0f - x : x;
      const float dfw = t ? -1.0f : 1.0f;
      const float bce = t ? -logf(x) : -logf(1.0f - x);
      const float dbce = t ? -1.0f / x : 1.0f / (1.0f - x);
      // d/dx of alpha * fw^2 * bce, times the clamp's derivative (JAX's
      // maximum/minimum split a tie: 0.5 at exactly either bound)
      const float dx = alpha * (2.0f * fw * dfw * bce + (fw * fw) * dbce);
      const float clamp_d = (raw == kClsLo || raw == kClsHi) ? 0.5f : (raw > kClsLo && raw < kClsHi ? 1.0f : 0.0f);
      d = g_cls * dx * clamp_d;
    }
    dc[k] = d;
  }

  float g[kReg];
#pragma unroll
  for (int j = 0; j < kReg; ++j) g[j] = 0.0f;
  if (positive) {
    const Anchor an = load_anchor(anchors, a);
    float r[kReg];
    const float* rp = reg + ia * kReg;
#pragma unroll
    for (int j = 0; j < kReg; ++j) r[j] = rp[j];
    const float* t = s.t[arg];
#pragma unroll
    for (int j = 0; j < 20; ++j) {
      const float u = target20(t, an, j) - pred20(r, j);
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
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float rx = r[2 + 2 * i], ry = r[3 + 2 * i];
      const float tx = s.axis[arg][i][0], ty = s.axis[arg][i][1];
      const float tn = s.tn[arg][i];
      const float rn = sqrtf(rx * rx + ry * ry + kNormEps);
      const float dot = rx * tx + ry * ty;
      // d(1 - cos)/dr = -(t / (rn tn) - dot r / (rn^3 tn))
      const float rt = rn * tn;
      const float q = dot / (rn * rn);
      g[2 + 2 * i] += -g_vp * ((tx - q * rx) / rt);
      g[3 + 2 * i] += -g_vp * ((ty - q * ry) / rt);
    }
  }
  float* dr = dreg + ia * kReg;
#pragma unroll
  for (int j = 0; j < kReg; ++j) dr[j] = g[j];
}

bool shapes_ok(int B, int A, int K, int M) {
  return B >= 1 && B <= 65535 && A >= 1 && K >= 1 && K <= kMaxClasses && M >= 1 && M <= kMaxLabels &&
         static_cast<long long>(B) * A * kReg < (1LL << 40);
}

}  // namespace

extern "C" {

// Forward: losses (cls, reg, vp) -> out[3], per-image clamped positive
// counts -> num_pos[B], per-anchor argmax [B,A] int32 and flags [B,A] uint8.
// partials holds B * ceil(A / 256) * 4 doubles; ticket one unsigned int that
// is 0 at the launch. Returns the cudaError_t of the launch.
int focal_loss_forward(const void* cls, const void* reg, const void* ann, const void* anchors, int B, int A, int K,
                       int M, void* argmax, void* flags, void* partials, void* ticket, void* num_pos, void* out,
                       void* stream) {
  if (!shapes_ok(B, A, K, M)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  focal_forward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cls), static_cast<const float*>(reg), static_cast<const float*>(ann),
      static_cast<const float*>(anchors), B, A, K, M, static_cast<int*>(argmax), static_cast<uint8_t*>(flags),
      static_cast<double*>(partials), static_cast<unsigned int*>(ticket), static_cast<float*>(num_pos),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Backward: grad_out[3] (d loss / d cls, reg, vp outputs) -> dcls [B,A,K],
// dreg [B,A,12], every element written.
int focal_loss_backward(const void* cls, const void* reg, const void* ann, const void* anchors, const void* argmax,
                        const void* flags, const void* num_pos, const void* grad_out, int B, int A, int K, int M,
                        void* dcls, void* dreg, void* stream) {
  if (!shapes_ok(B, A, K, M)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((A + kThreads - 1) / kThreads, B);
  focal_backward_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cls), static_cast<const float*>(reg), static_cast<const float*>(ann),
      static_cast<const float*>(anchors), static_cast<const int*>(argmax), static_cast<const uint8_t*>(flags),
      static_cast<const float*>(num_pos), static_cast<const float*>(grad_out), B, A, K, M,
      static_cast<float*>(dcls), static_cast<float*>(dreg));
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
