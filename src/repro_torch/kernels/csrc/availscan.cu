// Availability-rectangle scan of Algorithm 3 on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/availscan.py:
//   availscan_rects   <- availscan (l.146, body _availscan_kernel l.112)
//   availscan_select  <- availscan_select (l.373, body
//                        _availscan_select_kernel l.306)
//
// What it computes, per candidate start s (live iff s < T_INF), for the
// job window [a, b) with a = min(s, T_INF - t_du), b = a + t_du:
//   busy    = OR of occ[k] over records k overlapping [a, b)
//   n_free  = n_pe - popcount(busy)
//   a record blocks iff (~busy & occ[k]) != 0
//   t_begin = end of the latest blocking record ending at or before a,
//             clamped to [t_now, a] (-T_INF before clamping if none)
//   t_end   = start of the earliest blocking record at or after b
//             (T_INF if none)
// Dead candidates report zeros.  availscan_select then scores every
// live candidate with the policies' exact integer keys and returns the
// lexicographic minimum of (key1, key2, start_key, index) as one row of
// eight int32: key1, key2, start_key, best_index, n_free, t_begin,
// t_end, feasible.  The plain PyTorch versions are in ../ref.py.
//
// Design.  The TPU kernels bit-expand occupancy to f32 and contract it
// on the matrix unit.  Here the words stay packed (int32 with uint32
// bits): one warp takes one candidate, lane w holds words w and w + 32
// (n_pe <= 2048, so W <= 64), and the record axis is walked, not
// multiplied:
//   * two warp-uniform binary searches over the sorted times find the
//     overlapping record range [lo, hi);
//   * one loop ORs those rows (coalesced 128-byte row reads) and a
//     __popc + shuffle sum gives n_free;
//   * the blocking test runs outward from the window, left from lo - 1
//     and right from hi, with __any_sync, and stops at the first
//     blocking record; since times are sorted that record holds the
//     max end / min start the definitions ask for.
// The work therefore follows the live records near each window, not
// the capacity S, and occupancy is read from global memory / L1 / L2
// with no shared-memory staging, so any S works.
//
// Bound.  At the paper's size (S = 128 records, P = 258 candidates,
// W = 32 words, ~25 live records) a call reads the live records' rows,
// the times and the starts, ~5 KB, and does ~10^4 word operations: the
// card could finish it in a few nanoseconds, so a call costs its launch
// latency.  The design keeps it to two launches (scan +
// select, then a one-block reduction) and one int32[8] result; fewer
// launches per admit step is the next lever, not this kernel's speed.
//
// Cross-block reduction.  TPU grid steps run in order and fold into one
// accumulator; CUDA blocks do not.  Each block writes its best row to
// partial[block] (a block with no live candidate writes the sentinel
// row: INT32_MAX in all four keys, zeros elsewhere) and a second launch
// of one block reduces them.  The index key is unique, so the order of
// the reduction never matters.
#include <cuda_runtime.h>

namespace {

constexpr int kTInf = 2147483647;
constexpr int kBig = 2147483647;
constexpr int kWarpsPerBlock = 8;    // candidates per block
constexpr int kReduceThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Rect {
  int n_free;
  int t_begin;
  int t_end;
};

// first index k in [0, S) with times[k] > v (S if none)
__device__ __forceinline__ int upper_bound(const int* times, int S, int v) {
  int lo = 0, hi = S;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (times[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index k in [0, S) with times[k] >= v (S if none)
__device__ __forceinline__ int lower_bound(const int* times, int S, int v) {
  int lo = 0, hi = S;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (times[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One warp: the rectangle of window [a, b).  All lanes get the result.
__device__ Rect scan_window(const int* __restrict__ times,
                            const unsigned* __restrict__ occ, int S, int W,
                            int a, int b, int t_now, int n_pe, int lane) {
  // record k overlaps [a, b) iff times[k] < b and next(k) > a, where
  // next(k) = times[k + 1] (T_INF past the end).  Both are monotone in
  // k, so the overlapping records are [lo, hi).
  const int lo = max(upper_bound(times, S, a) - 1, 0);
  const int hi = lower_bound(times, S, b);
  const bool has0 = lane < W;
  const bool has1 = lane + 32 < W;
  unsigned busy0 = 0u, busy1 = 0u;
  for (int k = lo; k < hi; ++k) {
    const unsigned* row = occ + (size_t)k * W;
    if (has0) busy0 |= row[lane];
    if (has1) busy1 |= row[lane + 32];
  }
  int cnt = __popc(busy0) + __popc(busy1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
  const unsigned free0 = has0 ? ~busy0 : 0u;
  const unsigned free1 = has1 ? ~busy1 : 0u;
  // left: records [0, lo) end at or before a; the nearest blocking one
  // has the largest end
  int tb = -kTInf;
  for (int k = lo - 1; k >= 0; --k) {
    const unsigned* row = occ + (size_t)k * W;
    unsigned hit = 0u;
    if (has0) hit |= row[lane] & free0;
    if (has1) hit |= row[lane + 32] & free1;
    if (__any_sync(kFull, hit != 0u)) {
      tb = times[k + 1];
      break;
    }
  }
  // right: records [hi, S) start at or after b; padding never blocks
  int te = kTInf;
  for (int k = hi; k < S; ++k) {
    const int t = times[k];
    if (t == kTInf) break;
    const unsigned* row = occ + (size_t)k * W;
    unsigned hit = 0u;
    if (has0) hit |= row[lane] & free0;
    if (has1) hit |= row[lane + 32] & free1;
    if (__any_sync(kFull, hit != 0u)) {
      te = t;
      break;
    }
  }
  Rect r;
  r.n_free = n_pe - cnt;
  r.t_begin = min(max(tb, t_now), a);
  r.t_end = te;
  return r;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
availscan_rects_kernel(const int* __restrict__ times,
                       const unsigned* __restrict__ occ,
                       const int* __restrict__ starts,
                       int* __restrict__ n_free, int* __restrict__ t_begin,
                       int* __restrict__ t_end, int S, int W, int P,
                       int t_du, int t_now, int n_pe) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= P) return;                     // warp-uniform
  const int s = starts[p];
  Rect r = {0, 0, 0};
  if (s < kTInf) {                        // warp-uniform
    const int a = min(s, kTInf - t_du);
    r = scan_window(times, occ, S, W, a, a + t_du, t_now, n_pe, lane);
  }
  if (lane == 0) {
    n_free[p] = r.n_free;
    t_begin[p] = r.t_begin;
    t_end[p] = r.t_end;
  }
}

// lexicographic (key1, key2, start_key, index) less-than
__device__ __forceinline__ bool row_less(const int* x, const int* y) {
  if (x[0] != y[0]) return x[0] < y[0];
  if (x[1] != y[1]) return x[1] < y[1];
  if (x[2] != y[2]) return x[2] < y[2];
  return x[3] < y[3];
}

__device__ __forceinline__ void sentinel_row(int* row) {
  row[0] = row[1] = row[2] = row[3] = kBig;
  row[4] = row[5] = row[6] = row[7] = 0;
}

// exact policy keys of repro.core.policies.integer_keys: the product
// n_free * duration as (p_hi, p_lo) with p_lo < 2**16
__device__ __forceinline__ void policy_keys(int policy, int nf, int du,
                                            int* key1, int* key2) {
  const int du_hi = du >> 16;
  const int du_lo = du & 0xFFFF;
  const int p_lo_raw = nf * du_lo;
  const int p_hi = nf * du_hi + (p_lo_raw >> 16);
  const int p_lo = p_lo_raw & 0xFFFF;
  int k1 = 0, k2 = 0;
  switch (policy) {
    case 1: k1 = nf; break;
    case 2: k1 = -nf; break;
    case 3: k1 = du; break;
    case 4: k1 = -du; break;
    case 5: k1 = p_hi; k2 = p_lo; break;
    case 6: k1 = -p_hi; k2 = -p_lo; break;
    default: break;
  }
  *key1 = k1;
  *key2 = k2;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
availscan_select_kernel(const int* __restrict__ times,
                        const unsigned* __restrict__ occ,
                        const int* __restrict__ starts,
                        int* __restrict__ partial, int S, int W, int P,
                        int t_du, int t_now, int n_req, int policy,
                        int n_pe) {
  __shared__ int rows[kWarpsPerBlock][8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  const int s = p < P ? starts[p] : kTInf;
  if (s < kTInf) {                        // warp-uniform
    const int a = min(s, kTInf - t_du);
    const Rect r = scan_window(times, occ, S, W, a, a + t_du, t_now, n_pe,
                               lane);
    if (lane == 0) {
      const bool feasible = r.n_free >= n_req;
      // duration wraps like the reference's int32 subtraction
      const int du = (int)((unsigned)r.t_end - (unsigned)r.t_begin);
      int key1, key2;
      policy_keys(policy, r.n_free, du, &key1, &key2);
      int* row = rows[warp];
      row[0] = feasible ? key1 : kBig;
      row[1] = feasible ? key2 : kBig;
      row[2] = feasible ? s : kBig;
      row[3] = p;
      row[4] = r.n_free;
      row[5] = r.t_begin;
      row[6] = r.t_end;
      row[7] = feasible ? 1 : 0;
    }
  } else if (lane == 0) {
    sentinel_row(rows[warp]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = 0;
    for (int w = 1; w < kWarpsPerBlock; ++w)
      if (row_less(rows[w], rows[best])) best = w;
    int* out = partial + (size_t)blockIdx.x * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j] = rows[best][j];
  }
}

__global__ void __launch_bounds__(kReduceThreads)
select_reduce_kernel(const int* __restrict__ partial, int n_rows,
                     int* __restrict__ out) {
  __shared__ int rows[kReduceThreads][8];
  int* mine = rows[threadIdx.x];
  sentinel_row(mine);
  for (int i = threadIdx.x; i < n_rows; i += kReduceThreads) {
    const int* r = partial + (size_t)i * 8;
    if (row_less(r, mine)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mine[j] = r[j];
    }
  }
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride && row_less(rows[threadIdx.x + stride], mine)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mine[j] = rows[threadIdx.x + stride][j];
    }
    __syncthreads();
  }
  if (threadIdx.x < 8) out[threadIdx.x] = rows[0][threadIdx.x];
}

int n_blocks(int P) { return (P + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" {

int availscan_candidates_per_block(void) { return kWarpsPerBlock; }

const char* availscan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// n_free / t_begin / t_end: int32[P] outputs.  Returns cudaGetLastError().
int availscan_rects(const void* times, const void* occ, const void* starts,
                    void* n_free, void* t_begin, void* t_end, int S, int W,
                    int P, int t_du, int t_now, int n_pe, void* stream) {
  availscan_rects_kernel<<<n_blocks(P), 32 * kWarpsPerBlock, 0,
                           (cudaStream_t)stream>>>(
      (const int*)times, (const unsigned*)occ, (const int*)starts,
      (int*)n_free, (int*)t_begin, (int*)t_end, S, W, P, t_du, t_now, n_pe);
  return (int)cudaGetLastError();
}

// partial: int32[ceil(P / candidates_per_block), 8] scratch; out:
// int32[8].  Returns cudaGetLastError() after both launches.
int availscan_select(const void* times, const void* occ, const void* starts,
                     void* partial, void* out, int S, int W, int P, int t_du,
                     int t_now, int n_req, int policy, int n_pe,
                     void* stream) {
  const int nb = n_blocks(P);
  availscan_select_kernel<<<nb, 32 * kWarpsPerBlock, 0,
                            (cudaStream_t)stream>>>(
      (const int*)times, (const unsigned*)occ, (const int*)starts,
      (int*)partial, S, W, P, t_du, t_now, n_req, policy, n_pe);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_reduce_kernel<<<1, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const int*)partial, nb, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
