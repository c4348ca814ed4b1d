// Epsilon-scaled forward auction (linear assignment) as one block on Hopper
// (sm_90a), plain C interface.
//
// Replaces the device loop of playground3d_tpu/ops/assignment.py::
// assign_auction: a lax.while_loop of Bertsekas' forward auction on the
// squared-up, masked benefit, with epsilon scaling and the near-zero
// diagonal tie-break on dummy entries. The port's plain version
// (ops/assignment.py::assign_auction_plain) runs the loop on the host and
// reads one flag a round; this kernel keeps it on the card, so the caller
// never waits for it and a CUDA graph can hold it.
//
// What bounds it: latency. k = max(n, m) <= 1024 (64 on the tracker's
// 64 x 48 IoU), a round is k subtractions and compares for each row that
// bids and four block barriers, and the rounds depend on the data (tens to
// thousands a call).
// One block holds the whole problem:
//  - the squared-up benefit (real entries, else the tie-break) is formed
//    once into shared memory; above kSmemMaxK it is formed on the fly from
//    the benefit in device memory instead;
//  - a round: a warp per unassigned row finds its best and second value
//    (each lane over every 32nd column, then a butterfly of shuffles) and
//    the row's bid; a warp per column takes the largest bid (amax), its
//    lowest winning row (amin) and evicts the column's previous holder; then
//    a thread per row and column applies the round, and the epsilon shrink
//    and the restart are decided by __syncthreads_and / __syncthreads_count.
//    The first version, a thread per row and per column scanning k values
//    alone, took 5.5 us a round (PERF.md).
//
// Exactness: the same float32 operations in the same order as the plain
// version, each rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn; -fmad=false too): the bid is (price[j] + (best - second)) +
// eps, argmax takes the first index among equal values, a bid wins when it
// is >= (column bid - 1e-12f), the shrink is eps * 0.1f, and scale,
// eps_final and the tie-break are formed as the plain version forms them.
// The assignment and the round count equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;  // max(n, m): one block
constexpr int kSmemMaxK = 224;  // the formed benefit fits a block's shared memory up to here
constexpr float kNeg = -1e9f;  // NEG of ops/assignment.py

__host__ __device__ constexpr int threads_for(int k) { return k >= 32 ? 1024 : 32 * k; }  // a warp a row

// benefit [k][k] floats when k <= kSmemMaxK, then ten [k] arrays (price,
// row_of_col, col_of_row, best_of, bid_of, evict, won, taken, winner,
// col_bid) and one word
__host__ __device__ constexpr int shared_bytes_for(int k) {
  return (k <= kSmemMaxK ? k * k * 4 : 0) + 10 * k * 4 + 16;
}

struct Problem {
  const float* benefit;  // [n, m]
  const uint8_t* row_mask;  // [n]
  const uint8_t* col_mask;  // [m]
  int n, m, k;
  float tie_scale;  // scale * 1e-7f
};

// the squared-up benefit: real entries as given, else -|r - j| * (scale * 1e-7)
__device__ __forceinline__ float formed(const Problem& p, int r, int j) {
  if (r < p.n && j < p.m && p.row_mask[r] && p.col_mask[j]) return p.benefit[r * p.m + j];
  return __fmul_rn(-static_cast<float>(r > j ? r - j : j - r), p.tie_scale);
}

// (best value, its column, second value) over a set of columns; bj < 0 is
// the empty set. Merging two disjoint sets: the larger best wins, the lower
// column among equal ones (argmax's first index); the loser's best joins
// the second values. Max is exact, so any merge order gives the values a
// scan in column order gives.
struct Best {
  float bv;
  int bj;
  float sv;
};

__device__ __forceinline__ Best merge(Best a, Best b) {
  if (b.bj < 0) return a;
  if (a.bj < 0) return b;
  const bool a_wins = a.bv > b.bv || (a.bv == b.bv && a.bj < b.bj);
  const Best w = a_wins ? a : b, l = a_wins ? b : a;
  return {w.bv, w.bj, l.bv > w.sv ? l.bv : w.sv};
}

template <bool kSmem>
__global__ void __launch_bounds__(1024)
auction_kernel(const float* __restrict__ benefit, const uint8_t* __restrict__ row_mask,
               const uint8_t* __restrict__ col_mask, int n, int m, int max_iters, int32_t* __restrict__ out,
               int32_t* __restrict__ rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = max(n, m), t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  float* b = reinterpret_cast<float*>(smem);
  float* price = b + (kSmem ? k * k : 0);
  int* row_of_col = reinterpret_cast<int*>(price + k);
  int* col_of_row = row_of_col + k;
  int* best_of = col_of_row + k;  // the column a bidding row bids on, else -1
  float* bid_of = reinterpret_cast<float*>(best_of + k);
  int* evict = reinterpret_cast<int*>(bid_of + k);
  int* won = evict + k;
  int* taken = won + k;
  int* winner = taken + k;
  float* col_bid = reinterpret_cast<float*>(winner + k);
  unsigned* scale_bits = reinterpret_cast<unsigned*>(col_bid + k);

  // scale = max(max |real benefit|, 1e-6): |x| >= 0, so its bits order as unsigned ints
  if (t == 0) *scale_bits = 0u;
  __syncthreads();
  unsigned local = 0u;
  if (t < n && row_mask[t]) {
    for (int j = 0; j < m; ++j) {
      if (col_mask[j]) local = max(local, __float_as_uint(fabsf(benefit[t * m + j])));
    }
  }
  atomicMax(scale_bits, local);
  __syncthreads();
  float scale = __uint_as_float(*scale_bits);
  scale = scale < 1e-6f ? 1e-6f : scale;
  const Problem p{benefit, row_mask, col_mask, n, m, k, __fmul_rn(scale, 1e-7f)};
  const float eps_final = __fdiv_rn(scale, __fmul_rn(1e4f, __fadd_rn(static_cast<float>(k), 1.0f)));
  float eps = __fadd_rn(__fmul_rn(scale, 0.25f), eps_final);  // scale / 4 (exact) + eps_final

  if (kSmem) {
    for (int e = t; e < k * k; e += blockDim.x) b[e] = formed(p, e / k, e % k);
  }
  if (t < k) {
    price[t] = 0.0f;
    row_of_col[t] = -1;
    col_of_row[t] = -1;
  }

  int it = 0, reads = 0, bids = 0;
  while (it < max_iters) {
    ++reads;
    const int bidders = __syncthreads_count(t < k && col_of_row[t] < 0);
    if (bidders == 0 && !(eps > eps_final)) break;
    bids += bidders;

    // rows, a warp each: the bid of each unassigned row
    for (int r = warp; r < k; r += warps) {
      int best_j = -1;
      float bid = kNeg;
      if (col_of_row[r] < 0) {
        Best mine{0.0f, -1, kNeg};
        for (int j = lane; j < k; j += 32) {
          const float v = __fsub_rn(kSmem ? b[r * k + j] : formed(p, r, j), price[j]);
          mine = merge(mine, Best{v, j, kNeg});
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          const Best other{__shfl_xor_sync(0xffffffffu, mine.bv, d), __shfl_xor_sync(0xffffffffu, mine.bj, d),
                           __shfl_xor_sync(0xffffffffu, mine.sv, d)};
          mine = merge(mine, other);
        }
        best_j = mine.bj;
        bid = __fadd_rn(__fadd_rn(price[best_j], __fsub_rn(mine.bv, mine.sv)), eps);
      }
      if (lane == 0) {
        best_of[r] = best_j;
        bid_of[r] = bid;
        evict[r] = 0;
        won[r] = -1;
      }
    }
    __syncthreads();

    // columns, a warp each: the largest bid, the lowest row that bid within
    // 1e-12 of it, and the eviction of the column's previous holder
    for (int c = warp; c < k; c += warps) {
      bool has_bid = false;
      float top = kNeg;
      for (int r = lane; r < k; r += 32) {
        if (best_of[r] != c) continue;
        has_bid = true;
        top = bid_of[r] > top ? bid_of[r] : top;
      }
      has_bid = __any_sync(0xffffffffu, has_bid);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, top, d);
        top = o > top ? o : top;
      }
      const float floor = __fsub_rn(top, 1e-12f);
      int first = k;
      for (int r = lane; r < k && has_bid; r += 32) {
        if (best_of[r] == c && bid_of[r] >= floor) {
          first = r;
          break;
        }
      }
      first = __reduce_min_sync(0xffffffffu, first);
      if (lane == 0) {
        const bool is_taken = has_bid && first < k;
        taken[c] = is_taken;
        winner[c] = first;
        col_bid[c] = top;
        if (is_taken) {
          const int prev = row_of_col[c];
          if (prev >= 0) evict[prev] = 1;
          won[first] = c;
        }
      }
    }
    __syncthreads();

    if (t < k) {
      int col = evict[t] ? -1 : col_of_row[t];
      if (won[t] >= 0) col = won[t];
      col_of_row[t] = col;
      if (taken[t]) {
        row_of_col[t] = winner[t];
        price[t] = col_bid[t];
      }
    }
    const bool all_assigned = __syncthreads_and(t >= k || col_of_row[t] >= 0);
    if (all_assigned && eps > eps_final) {  // shrink and restart (uniform over the block)
      eps = __fmul_rn(eps, 0.1f);
      if (t < k) {
        col_of_row[t] = -1;
        row_of_col[t] = -1;
      }
    }
    ++it;
  }
  __syncthreads();

  if (t < n) {
    const int c = col_of_row[t];
    out[t] = (row_mask[t] && c >= 0 && c < m && col_mask[c]) ? c : -1;
  }
  if (t == 0 && rounds != nullptr) {
    atomicAdd(rounds, reads);
    atomicAdd(rounds + 1, bids);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess). The wrapper
// (ops/assignment.py) checks types, shapes and devices and passes the
// threads and dynamic shared memory its launch_plan computed, which must
// equal this file's rule. `rounds` (two int32 on the card, or null): the
// first is increased by the loop's rounds, counted as the plain version
// counts its host reads, the second by the rows that bid, summed over the
// rounds (the work these inputs needed).
int auction(const void* benefit, const void* row_mask, const void* col_mask, int n, int m, int max_iters,
            void* out, void* rounds, int threads, int shared_bytes, void* stream) {
  const int k = n > m ? n : m;
  if (n < 0 || m < 0 || k < 1 || k > kMaxK || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads != threads_for(k) || shared_bytes != shared_bytes_for(k)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(benefit);
  const uint8_t* rm = static_cast<const uint8_t*>(row_mask);
  const uint8_t* cm = static_cast<const uint8_t*>(col_mask);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* c = static_cast<int32_t*>(rounds);
  if (k <= kSmemMaxK) {
    if (shared_bytes > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(auction_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    auction_kernel<true><<<1, threads, shared_bytes, s>>>(b, rm, cm, n, m, max_iters, o, c);
  } else {
    auction_kernel<false><<<1, threads, shared_bytes, s>>>(b, rm, cm, n, m, max_iters, o, c);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
