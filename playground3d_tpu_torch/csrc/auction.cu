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
// 64 x 48 IoU); a round is k subtractions and compares for each row that
// bids and a few block barriers, and the rounds depend on the data (tens to
// thousands a call). There are no products, so the tensor cores have no
// part here. One block holds the whole problem, sized to it
// (ops/assignment.py::launch_plan): 32 * ceil(k / 4) threads, at most 256
// up to kSmemMaxK (1,024 above it), in groups of lanes_for(k) lanes, a
// group per bidding row.
//  - Up to kSmemMaxK the squared-up benefit lives in shared memory (rows at
//    an odd stride, so groups reading different rows fall in different
//    banks): the [n, m] rows are copied in by cp.async, then the dummy and
//    masked entries are filled with the tie-break. Above it the benefit is
//    formed on the fly from device memory, with the same rounds.
//  - A round works on the bidding rows only (~14 of 64 a round on a
//    tie-heavy 64 x 48), which the previous round left as a list in shared
//    memory. (1) Each group takes bidders from the list (every group of a
//    warp the same number of passes, so its shuffles take the full warp),
//    finds the row's best and second value (a lane-local scan over every
//    G-th column, then a butterfly, both branch-free), and its bid; the
//    bid's key goes to its column by a shared-memory atomicMax. (2) Each
//    bidder whose bid is within 1e-12 of its column's top bid offers its row
//    by atomicMin. (3) Each row settles itself: a bidder that won takes the
//    column and sets its price to the top bid, a holder whose column was
//    taken is evicted, and the rows left without a column append themselves
//    to the next round's list (a ballot and one atomicAdd a warp; a ballot
//    word a warp instead, with each group finding its bidder's bit,
//    measured slower); __syncthreads_count of them is the next round's
//    bidder count and the all-assigned test. Three barriers a round; the
//    column slots are double-buffered by round, so each is reset a round
//    after its use without a barrier of its own. (A 64-bit key of bid and
//    row, which would settle most rounds without step 2, compiles to a
//    compare-and-swap loop in shared memory and measured no faster; a fully
//    unrolled scan measured slower than the loop.)
//  The previous version: 1,024 threads at k 64, a warp per row and per
//  column over all k rows, four barriers a round: 2.7 us a round (PERF.md).
//
// The column key: every bid is > 0 (prices start at 0 and only take bids,
// best - second >= 0, eps > 0), so a bid's float32 bits, read as an
// unsigned int, order as the bids do; 0 is below every key.
//
// Exactness: the same float32 operations in the same order as the plain
// version, each rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn; -fmad=false too): the bid is (price[j] + (best - second)) +
// eps, argmax takes the first index among equal values, a bid wins when it
// is >= (column bid - 1e-12f), the lowest such row takes the column, the
// shrink is eps * 0.1f, and scale, eps_final and the tie-break are formed as
// the plain version forms them. The assignment and the round count equal
// the plain version's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;  // max(n, m): one block
constexpr int kSmemMaxK = 224;  // the formed benefit fits a block's shared memory up to here
constexpr int kSmemMaxThreads = 256;  // the block's size cap up to kSmemMaxK
constexpr float kNeg = -1e9f;  // NEG of ops/assignment.py

__host__ __device__ constexpr int threads_for(int k) {
  return k > kSmemMaxK ? 1024 : 32 * ((k + 3) / 4) < kSmemMaxThreads ? 32 * ((k + 3) / 4) : kSmemMaxThreads;
}
// lanes of the group that serves one bidder: a power of two, so a group
// never straddles a warp and its butterfly stays inside it
__host__ __device__ constexpr int lanes_for(int k) { return k <= 16 ? 4 : k <= 64 ? 8 : k <= kSmemMaxK ? 16 : 32; }
// floats between rows of the formed benefit in shared memory (odd)
__host__ __device__ constexpr int stride_for(int k) { return k <= kSmemMaxK ? (k | 1) : 0; }
// the formed benefit [k][stride] when k <= kSmemMaxK, then eight [k] arrays
// (price, best_of, bid_of, list, col_key[2], col_win[2]) and four words
__host__ __device__ constexpr int shared_bytes_for(int k) { return k * stride_for(k) * 4 + 8 * k * 4 + 16; }

struct Problem {
  const float* benefit;  // [n, m]
  const uint8_t* row_mask;  // [n]
  const uint8_t* col_mask;  // [m]
  int n, m;
  float tie_scale;  // scale * 1e-7f
};

__device__ __forceinline__ bool is_real(const Problem& p, int r, int j) {
  return r < p.n && j < p.m && p.row_mask[r] && p.col_mask[j];
}

// the squared-up benefit's dummy entries: -|r - j| * (scale * 1e-7)
__device__ __forceinline__ float tie_break(const Problem& p, int r, int j) {
  return __fmul_rn(-static_cast<float>(r > j ? r - j : j - r), p.tie_scale);
}

// the squared-up benefit: real entries as given, else the tie-break
__device__ __forceinline__ float formed(const Problem& p, int r, int j) {
  return is_real(p, r, j) ? p.benefit[r * p.m + j] : tie_break(p, r, j);
}

// A bidder's best value, its column and its second value, as the plain
// version's argmax (the first index among equal values) and its max with the
// best entry set to NEG give them. Each lane scans its columns in increasing
// order (a new best must be strictly larger, so a tie keeps the lower
// column; the old best joins the second values), then the group merges by a
// butterfly: the larger best wins, the lower column among equal ones, and
// the loser's best joins the winner's second values. An empty set is
// (-inf, -1, NEG). Max is exact, so any merge order gives the values of a
// scan in column order.
struct Best {
  float bv;
  int bj;
  float sv;
};

__device__ __forceinline__ void scan_in(Best& a, float v, int j) {
  const bool better = v > a.bv;
  const float lost = better ? a.bv : v;
  a.sv = lost > a.sv ? lost : a.sv;
  a.bj = better ? j : a.bj;
  a.bv = better ? v : a.bv;
}

__device__ __forceinline__ void merge_in(Best& a, const Best& o) {
  const bool other = o.bv > a.bv || (o.bv == a.bv && o.bj < a.bj);
  const float lost = other ? a.bv : o.bv, kept = other ? o.sv : a.sv;
  a.sv = lost > kept ? lost : kept;
  a.bj = other ? o.bj : a.bj;
  a.bv = other ? o.bv : a.bv;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

#ifdef AUCTION_TIMING
// thread 0's SM clock cycles: [0] the whole kernel, [1] set-up (load, scale,
// tie-break), then summed over the rounds [2] bids, [3] winners, [4]
// settling, and within its own bids [5] the scan, [6] the butterfly, [7]
// the bid and its atomic
__device__ unsigned long long auction_cycles[8];
#define TICK(v) const long long v = threadIdx.x == 0 ? clock64() : 0
#define ADD(k, from, to) do { if (threadIdx.x == 0) acc[k] += (to) - (from); } while (0)
#else
#define TICK(v) do {} while (0)
#define ADD(k, from, to) do {} while (0)
#endif

template <bool kSmem, int G>
__global__ void __launch_bounds__(1024)
auction_kernel(const float* __restrict__ benefit, const uint8_t* __restrict__ row_mask,
               const uint8_t* __restrict__ col_mask, int n, int m, int max_iters, int32_t* __restrict__ out,
               int32_t* __restrict__ rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
#ifdef AUCTION_TIMING
  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#endif
  TICK(c_start);
  const int k = max(n, m), T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = T >> 5;
  const int ks = stride_for(k);
  float* b = reinterpret_cast<float*>(smem);  // [k][ks], kSmem only
  float* price = b + k * ks;
  int* best_of = reinterpret_cast<int*>(price + k);  // the column a bidding row bids on
  float* bid_of = reinterpret_cast<float*>(best_of + k);
  int* list = reinterpret_cast<int*>(bid_of + k);  // this round's bidding rows
  unsigned* col_key = reinterpret_cast<unsigned*>(list + k);  // [2][k]: the top bid's bits
  int* col_win = reinterpret_cast<int*>(col_key + 2 * k);  // [2][k]: the lowest winning row
  unsigned* scale_bits = reinterpret_cast<unsigned*>(col_win + 2 * k);
  unsigned* fill = scale_bits + 1;  // the next round's list length

  // the real rectangle of the benefit into shared memory, asynchronously (a
  // row a warp, its columns across the lanes)
  if (kSmem) {
    for (int r = warp; r < n; r += warps) {
      for (int j = lane; j < m; j += 32) cp_async4(b + r * ks + j, benefit + r * m + j);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // meanwhile the masks, once: bit q of cbits = column lane + 32q is real,
  // bit q of rbits = row warp + q * warps is real (at most 32 of each)
  unsigned cbits = 0u, rbits = 0u;
  for (int q = 0, j = lane; j < k; ++q, j += 32) cbits |= (j < m && col_mask[j]) ? 1u << q : 0u;
  for (int q = 0, r = warp; r < k; ++q, r += warps) rbits |= (r < n && row_mask[r]) ? 1u << q : 0u;
  if (t == 0) *scale_bits = 0u;
  if (t < k) {
    price[t] = 0.0f;
    list[t] = t;  // every row bids in the first round
    col_key[t] = col_key[k + t] = 0u;
    col_win[t] = col_win[k + t] = INT_MAX;
  }
  if (kSmem) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // scale = max(max |real benefit|, 1e-6): |x| >= 0, so its bits order as unsigned ints
  Problem p{benefit, row_mask, col_mask, n, m, 0.0f};
  unsigned local = 0u;
  for (int qr = 0, r = warp; r < n; ++qr, r += warps) {
    if (!((rbits >> qr) & 1u)) continue;  // uniform over the warp
    for (int qc = 0, j = lane; j < m; ++qc, j += 32) {
      if ((cbits >> qc) & 1u) local = max(local, __float_as_uint(fabsf(kSmem ? b[r * ks + j] : benefit[r * m + j])));
    }
  }
  local = __reduce_max_sync(0xffffffffu, local);
  if (lane == 0) atomicMax(scale_bits, local);
  __syncthreads();
  float scale = __uint_as_float(*scale_bits);
  scale = scale < 1e-6f ? 1e-6f : scale;
  p.tie_scale = __fmul_rn(scale, 1e-7f);
  const float eps_final = __fdiv_rn(scale, __fmul_rn(1e4f, __fadd_rn(static_cast<float>(k), 1.0f)));
  float eps = __fadd_rn(__fmul_rn(scale, 0.25f), eps_final);  // scale / 4 (exact) + eps_final

  if (kSmem) {  // the dummy and masked entries
    for (int qr = 0, r = warp; r < k; ++qr, r += warps) {
      const bool real_row = (rbits >> qr) & 1u;
      for (int qc = 0, j = lane; j < k; ++qc, j += 32) {
        if (!(real_row && ((cbits >> qc) & 1u))) b[r * ks + j] = tie_break(p, r, j);
      }
    }
    __syncthreads();
  }

  const int groups = T / G, g = t / G, gl = t & (G - 1);
  int col = -1;  // the column row t holds (t < k)
  int count = k;  // rows bidding in this round: list[0, count)
  int it = 0, reads = 0, bids = 0, par = 0;
  TICK(c_setup);
  ADD(1, c_start, c_setup);
  while (it < max_iters) {
    ++reads;
    if (count == 0 && !(eps > eps_final)) break;
    bids += count;
    TICK(c_round);
    unsigned* key = col_key + par * k;
    int* win = col_win + par * k;

    // (1) bids: a group of G lanes a bidding row; every group of a warp
    // makes the same passes, so the butterfly's shuffles take the whole warp
    if (t == 0) *fill = 0u;
    if (t < k) {  // the other parity's slots, last used a round ago
      col_key[(par ^ 1) * k + t] = 0u;
      col_win[(par ^ 1) * k + t] = INT_MAX;
    }
    for (int s = g; s - g < count; s += groups) {
      const bool active = s < count;
      if (!__any_sync(0xffffffffu, active)) break;  // uniform over the warp
      TICK(c_s0);
      const int r = list[active ? s : 0];
      Best mine{-__int_as_float(0x7f800000), -1, kNeg};
#pragma unroll 4
      for (int j = gl; j < k; j += G) scan_in(mine, __fsub_rn(kSmem ? b[r * ks + j] : formed(p, r, j), price[j]), j);
      TICK(c_scan);
#pragma unroll
      for (int d = G >> 1; d > 0; d >>= 1) {
        const Best other{__shfl_xor_sync(0xffffffffu, mine.bv, d), __shfl_xor_sync(0xffffffffu, mine.bj, d),
                         __shfl_xor_sync(0xffffffffu, mine.sv, d)};
        merge_in(mine, other);
      }
      TICK(c_fly);
      if (active && gl == 0) {
        const float bid = __fadd_rn(__fadd_rn(price[mine.bj], __fsub_rn(mine.bv, mine.sv)), eps);
        best_of[r] = mine.bj;
        bid_of[r] = bid;
        atomicMax(key + mine.bj, __float_as_uint(bid));
      }
      TICK(c_bid);
      ADD(5, c_s0, c_scan);
      ADD(6, c_scan, c_fly);
      ADD(7, c_fly, c_bid);
    }
    __syncthreads();
    TICK(c_bids);
    ADD(2, c_round, c_bids);

    // (2) each bidder within 1e-12 of its column's top bid offers its row
    const bool bidding = t < k && col < 0;
    int want = -1;
    if (bidding) {
      want = best_of[t];
      if (bid_of[t] >= __fsub_rn(__uint_as_float(key[want]), 1e-12f)) atomicMin(win + want, t);
    }
    __syncthreads();
    TICK(c_win);
    ADD(3, c_bids, c_win);

    // (3) each row settles itself; the rows left without a column list themselves
    if (bidding) {
      if (win[want] == t) {
        col = want;
        price[want] = __uint_as_float(key[want]);
      }
    } else if (t < k && win[col] != INT_MAX) {
      col = -1;  // another row took this row's column
    }
    const bool next = t < k && col < 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, next);
    unsigned base = 0u;
    if (lane == 0 && ballot) base = atomicAdd(fill, static_cast<unsigned>(__popc(ballot)));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (next) list[base + __popc(ballot & ((1u << lane) - 1u))] = t;
    count = __syncthreads_count(next);
    TICK(c_settle);
    ADD(4, c_win, c_settle);
    if (count == 0 && eps > eps_final) {  // shrink and restart (uniform over the block)
      eps = __fmul_rn(eps, 0.1f);
      col = -1;
      if (t < k) list[t] = t;
      count = k;
      __syncthreads();
    }
    par ^= 1;
    ++it;
  }

  if (t < n) out[t] = (row_mask[t] && col >= 0 && col < m && col_mask[col]) ? col : -1;
  if (t == 0 && rounds != nullptr) {
    atomicAdd(rounds, reads);
    atomicAdd(rounds + 1, bids);
  }
#ifdef AUCTION_TIMING
  if (t == 0) {
    acc[0] = clock64() - c_start;
    for (int q = 0; q < 8; ++q) auction_cycles[q] = acc[q];
  }
#endif
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = cudaSuccess). The wrapper
// (ops/assignment.py) checks types, shapes and devices and passes the
// threads, lanes a bidder and dynamic shared memory its launch_plan
// computed, which must equal this file's rule. `rounds` (two int32 on the
// card, or null): the first is increased by the loop's rounds, counted as
// the plain version counts its host reads, the second by the rows that bid,
// summed over the rounds (the work these inputs needed).
int auction(const void* benefit, const void* row_mask, const void* col_mask, int n, int m, int max_iters,
            void* out, void* rounds, int threads, int lanes, int shared_bytes, void* stream) {
  const int k = n > m ? n : m;
  if (n < 0 || m < 0 || k < 1 || k > kMaxK || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads != threads_for(k) || lanes != lanes_for(k) || shared_bytes != shared_bytes_for(k)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  void (*kernel)(const float*, const uint8_t*, const uint8_t*, int, int, int, int32_t*, int32_t*) =
      k > kSmemMaxK ? auction_kernel<false, 32>
      : lanes == 4  ? auction_kernel<true, 4>
      : lanes == 8  ? auction_kernel<true, 8>
      : lanes == 16 ? auction_kernel<true, 16>
                    : auction_kernel<true, 32>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<1, threads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(benefit), static_cast<const uint8_t*>(row_mask), static_cast<const uint8_t*>(col_mask),
      n, m, max_iters, static_cast<int32_t*>(out), static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

#ifdef AUCTION_TIMING
int auction_read_cycles(void* host) { return (int)cudaMemcpyFromSymbol(host, auction_cycles, sizeof(auction_cycles)); }
#endif

const char* kernel_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
