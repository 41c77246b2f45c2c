// Availability-rectangle scan of Algorithm 3 on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/availscan.py:
//   availscan_rects     <- availscan (l.146, body _availscan_kernel l.112)
//   availscan_select    <- availscan_select (l.373, body
//                          _availscan_select_kernel l.306)
//   availscan_rects_mr  <- availscan_mr (l.228, body _availscan_kernel_mr
//                          l.204, _tile_rects_mr l.79)
//   availscan_select_mr <- availscan_select_mr (l.494, body
//                          _availscan_select_kernel_mr l.429)
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
// Multi-resource (the _mr kernels).  The occupancy word axis holds one
// bitplane per resource; plane[w] names word w's plane and valid[w] its
// live units.  free = ~busy & valid, so padding and dead units (a
// heterogeneous lane) are never free and never block; each plane's free
// units are counted separately (n_free is plane 0's), a candidate is
// feasible iff plane 0 covers n_req and every plane q >= 1 its demand
// demand[q - 1], and the keys score plane 0.  The TPU kernels route the
// counts through an MXU product with a plane-selector matrix, padded to
// 128 lanes (R <= 128) under an 8 MiB budget; here each warp adds its
// words' popcounts into R shared counters, lane w holds words w + 32 j
// for j < NW (NW in {1, 2, 4, 8, 16}, a template argument), so any
// layout of up to 512 words (R <= W) at any capacity runs.
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
// W = 32 words, ~25 live records; 46 words for the four-resource
// machine) a call reads the live records' rows, the times and the
// starts, ~5-10 KB, and does ~10^4 word operations: the card could
// finish it in a few nanoseconds, so a call costs its launch latency.
// The design keeps it to two launches (scan + select, then a one-block
// reduction) and one int32[8] result; fewer launches per admit step is
// the next lever, not this kernel's speed.
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
constexpr int kMaxWordsMr = 512;     // multi-resource: 16 words per lane
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

// record k overlaps [a, b) iff times[k] < b and next(k) > a, where
// next(k) = times[k + 1] (T_INF past the end).  Both are monotone in
// k, so the overlapping records are [lo, hi).
__device__ __forceinline__ void overlap_range(const int* times, int S, int a,
                                              int b, int* lo, int* hi) {
  *lo = max(upper_bound(times, S, a) - 1, 0);
  *hi = lower_bound(times, S, b);
}

// A warp's share of one occupancy row: lane holds words lane + 32 j,
// j < NW, so a row read is coalesced.  busy = OR of rows [lo, hi).
template <int NW>
__device__ __forceinline__ void window_busy(const unsigned* __restrict__ occ,
                                            int W, int lo, int hi, int lane,
                                            unsigned (&busy)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) busy[j] = 0u;
  for (int k = lo; k < hi; ++k) {
    const unsigned* row = occ + (size_t)k * W;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int w = lane + 32 * j;
      if (w < W) busy[j] |= row[w];
    }
  }
}

// whether a row occupies any of the warp's free units (all lanes agree)
template <int NW>
__device__ __forceinline__ bool row_blocks(const unsigned* __restrict__ row,
                                           int W, int lane,
                                           const unsigned (&fr)[NW]) {
  unsigned hit = 0u;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = lane + 32 * j;
    if (w < W) hit |= row[w] & fr[j];
  }
  return __any_sync(kFull, hit != 0u);
}

// The outward scans, from the window to the first blocking record on
// each side; since times are sorted that record holds the max end /
// min start the definitions ask for.
template <int NW>
__device__ __forceinline__ void outward_scans(const int* __restrict__ times,
                                              const unsigned* __restrict__ occ,
                                              int S, int W, int lo, int hi,
                                              int a, int t_now, int lane,
                                              const unsigned (&fr)[NW],
                                              Rect* r) {
  // left: records [0, lo) end at or before a
  int tb = -kTInf;
  for (int k = lo - 1; k >= 0; --k) {
    if (row_blocks<NW>(occ + (size_t)k * W, W, lane, fr)) {
      tb = times[k + 1];
      break;
    }
  }
  // right: records [hi, S) start at or after b; padding never blocks
  int te = kTInf;
  for (int k = hi; k < S; ++k) {
    const int t = times[k];
    if (t == kTInf) break;
    if (row_blocks<NW>(occ + (size_t)k * W, W, lane, fr)) {
      te = t;
      break;
    }
  }
  r->t_begin = min(max(tb, t_now), a);
  r->t_end = te;
}

// One warp: the rectangle of window [a, b).  All lanes get the result.
__device__ Rect scan_window(const int* __restrict__ times,
                            const unsigned* __restrict__ occ, int S, int W,
                            int a, int b, int t_now, int n_pe, int lane) {
  int lo, hi;
  overlap_range(times, S, a, b, &lo, &hi);
  unsigned busy[2];
  window_busy<2>(occ, W, lo, hi, lane, busy);
  int cnt = __popc(busy[0]) + __popc(busy[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(kFull, cnt, off);
  unsigned fr[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) fr[j] = lane + 32 * j < W ? ~busy[j] : 0u;
  Rect r;
  r.n_free = n_pe - cnt;
  outward_scans<2>(times, occ, S, W, lo, hi, a, t_now, lane, fr, &r);
  return r;
}

// One warp, multi-resource: free = ~busy & valid, so padding and dead
// units are never free; plane q's free units are counted into cnt[q]
// (the warp's own shared counters: a plane's words may sit in several
// lanes, and a lane's words in several planes).  n_free is plane 0's
// count.  All lanes get the result; cnt holds every plane's count.
template <int NW>
__device__ Rect scan_window_mr(const int* __restrict__ times,
                               const unsigned* __restrict__ occ,
                               const unsigned* __restrict__ valid,
                               const int* __restrict__ plane, int* cnt,
                               int S, int W, int R, int a, int b, int t_now,
                               int lane) {
  int lo, hi;
  overlap_range(times, S, a, b, &lo, &hi);
  unsigned busy[NW];
  window_busy<NW>(occ, W, lo, hi, lane, busy);
  for (int q = lane; q < R; q += 32) cnt[q] = 0;
  __syncwarp();
  unsigned fr[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = lane + 32 * j;
    fr[j] = 0u;
    if (w < W) {
      fr[j] = ~busy[j] & valid[w];
      const int c = __popc(fr[j]);
      if (c) atomicAdd(&cnt[plane[w]], c);
    }
  }
  __syncwarp();
  Rect r;
  r.n_free = cnt[0];
  outward_scans<NW>(times, occ, S, W, lo, hi, a, t_now, lane, fr, &r);
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

// a live candidate's row: the policy keys of (n_free, t_end - t_begin)
// when feasible, INT32_MAX keys otherwise
__device__ __forceinline__ void candidate_row(int* row, int policy, int s,
                                              int p, const Rect& r,
                                              bool feasible) {
  // duration wraps like the reference's int32 subtraction
  const int du = (int)((unsigned)r.t_end - (unsigned)r.t_begin);
  int key1, key2;
  policy_keys(policy, r.n_free, du, &key1, &key2);
  row[0] = feasible ? key1 : kBig;
  row[1] = feasible ? key2 : kBig;
  row[2] = feasible ? s : kBig;
  row[3] = p;
  row[4] = r.n_free;
  row[5] = r.t_begin;
  row[6] = r.t_end;
  row[7] = feasible ? 1 : 0;
}

// thread 0 writes the block's best candidate row to partial[block]
__device__ __forceinline__ void block_best(int (*rows)[8],
                                           int* __restrict__ partial) {
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
    if (lane == 0) candidate_row(rows[warp], policy, s, p, r, r.n_free >= n_req);
  } else if (lane == 0) {
    sentinel_row(rows[warp]);
  }
  block_best(rows, partial);
}

// Multi-resource twins.  NW = occupancy words per lane (W <= 32 NW);
// every warp owns kMaxWordsMr plane counters in shared memory, since
// R <= W.
template <int NW>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
availscan_rects_mr_kernel(const int* __restrict__ times,
                          const unsigned* __restrict__ occ,
                          const unsigned* __restrict__ valid,
                          const int* __restrict__ plane,
                          const int* __restrict__ starts,
                          int* __restrict__ n_free, int* __restrict__ t_begin,
                          int* __restrict__ t_end, int* __restrict__ tail,
                          int S, int W, int R, int P, int t_du, int t_now) {
  __shared__ int counts[kWarpsPerBlock][kMaxWordsMr];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= P) return;                     // warp-uniform
  const int s = starts[p];
  int* cnt = counts[warp];
  int* my_tail = tail + (size_t)p * (R - 1);
  Rect r = {0, 0, 0};
  if (s < kTInf) {                        // warp-uniform
    const int a = min(s, kTInf - t_du);
    r = scan_window_mr<NW>(times, occ, valid, plane, cnt, S, W, R, a,
                           a + t_du, t_now, lane);
    for (int q = 1 + lane; q < R; q += 32) my_tail[q - 1] = cnt[q];
  } else {
    for (int q = 1 + lane; q < R; q += 32) my_tail[q - 1] = 0;
  }
  if (lane == 0) {
    n_free[p] = r.n_free;
    t_begin[p] = r.t_begin;
    t_end[p] = r.t_end;
  }
}

template <int NW>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
availscan_select_mr_kernel(const int* __restrict__ times,
                           const unsigned* __restrict__ occ,
                           const unsigned* __restrict__ valid,
                           const int* __restrict__ plane,
                           const int* __restrict__ demand,
                           const int* __restrict__ starts,
                           int* __restrict__ partial, int S, int W, int R,
                           int P, int t_du, int t_now, int n_req,
                           int policy) {
  __shared__ int rows[kWarpsPerBlock][8];
  __shared__ int counts[kWarpsPerBlock][kMaxWordsMr];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  const int s = p < P ? starts[p] : kTInf;
  if (s < kTInf) {                        // warp-uniform
    const int a = min(s, kTInf - t_du);
    int* cnt = counts[warp];
    const Rect r = scan_window_mr<NW>(times, occ, valid, plane, cnt, S, W,
                                      R, a, a + t_du, t_now, lane);
    // vector fit: plane 0 covers n_req, plane q >= 1 its demand (the
    // demand tail is never read when R == 1)
    bool short_of = r.n_free < n_req;
    for (int q = 1 + lane; q < R; q += 32) short_of |= cnt[q] < demand[q - 1];
    const bool feasible = !__any_sync(kFull, short_of);
    if (lane == 0) candidate_row(rows[warp], policy, s, p, r, feasible);
  } else if (lane == 0) {
    sentinel_row(rows[warp]);
  }
  block_best(rows, partial);
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

struct MrArgs {
  const int* times;
  const unsigned* occ;
  const unsigned* valid;
  const int* plane;
  const int* starts;
  int S, W, R, P, t_du, t_now;
};

template <int NW>
void launch_rects_mr(const MrArgs& m, int* n_free, int* t_begin, int* t_end,
                     int* tail, cudaStream_t stream) {
  availscan_rects_mr_kernel<NW><<<n_blocks(m.P), 32 * kWarpsPerBlock, 0,
                                  stream>>>(
      m.times, m.occ, m.valid, m.plane, m.starts, n_free, t_begin, t_end,
      tail, m.S, m.W, m.R, m.P, m.t_du, m.t_now);
}

template <int NW>
void launch_select_mr(const MrArgs& m, const int* demand, int* partial,
                      int n_req, int policy, cudaStream_t stream) {
  availscan_select_mr_kernel<NW><<<n_blocks(m.P), 32 * kWarpsPerBlock, 0,
                                   stream>>>(
      m.times, m.occ, m.valid, m.plane, demand, m.starts, partial, m.S, m.W,
      m.R, m.P, m.t_du, m.t_now, n_req, policy);
}

// the smallest instantiated words-per-lane count covering W
int words_per_lane(int W) {
  return W <= 32 ? 1 : W <= 64 ? 2 : W <= 128 ? 4 : W <= 256 ? 8 : 16;
}

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

int availscan_mr_max_words(void) { return kMaxWordsMr; }

// Multi-resource rectangles.  valid, plane: int32[W] (plane ids in
// [0, R), 1 <= R <= W <= availscan_mr_max_words()); n_free / t_begin /
// t_end: int32[P]; tail: int32[P, R - 1].  Returns cudaGetLastError().
int availscan_rects_mr(const void* times, const void* occ, const void* valid,
                       const void* plane, const void* starts, void* n_free,
                       void* t_begin, void* t_end, void* tail, int S, int W,
                       int R, int P, int t_du, int t_now, void* stream) {
  if (W < 1 || W > kMaxWordsMr || R < 1 || R > W)
    return (int)cudaErrorInvalidValue;
  const MrArgs m = {(const int*)times, (const unsigned*)occ,
                    (const unsigned*)valid, (const int*)plane,
                    (const int*)starts, S, W, R, P, t_du, t_now};
  int* nf = (int*)n_free;
  int* tb = (int*)t_begin;
  int* te = (int*)t_end;
  int* tl = (int*)tail;
  cudaStream_t st = (cudaStream_t)stream;
  switch (words_per_lane(W)) {
    case 1: launch_rects_mr<1>(m, nf, tb, te, tl, st); break;
    case 2: launch_rects_mr<2>(m, nf, tb, te, tl, st); break;
    case 4: launch_rects_mr<4>(m, nf, tb, te, tl, st); break;
    case 8: launch_rects_mr<8>(m, nf, tb, te, tl, st); break;
    default: launch_rects_mr<16>(m, nf, tb, te, tl, st); break;
  }
  return (int)cudaGetLastError();
}

// Multi-resource fused select.  demand: int32[R - 1] (unread when
// R == 1); partial, out as for availscan_select.  Returns
// cudaGetLastError() after both launches.
int availscan_select_mr(const void* times, const void* occ, const void* valid,
                        const void* plane, const void* demand,
                        const void* starts, void* partial, void* out, int S,
                        int W, int R, int P, int t_du, int t_now, int n_req,
                        int policy, void* stream) {
  if (W < 1 || W > kMaxWordsMr || R < 1 || R > W)
    return (int)cudaErrorInvalidValue;
  const MrArgs m = {(const int*)times, (const unsigned*)occ,
                    (const unsigned*)valid, (const int*)plane,
                    (const int*)starts, S, W, R, P, t_du, t_now};
  const int* d = (const int*)demand;
  int* part = (int*)partial;
  cudaStream_t st = (cudaStream_t)stream;
  switch (words_per_lane(W)) {
    case 1: launch_select_mr<1>(m, d, part, n_req, policy, st); break;
    case 2: launch_select_mr<2>(m, d, part, n_req, policy, st); break;
    case 4: launch_select_mr<4>(m, d, part, n_req, policy, st); break;
    case 8: launch_select_mr<8>(m, d, part, n_req, policy, st); break;
    default: launch_select_mr<16>(m, d, part, n_req, policy, st); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  select_reduce_kernel<<<1, kReduceThreads, 0, st>>>(part, n_blocks(P),
                                                      (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
