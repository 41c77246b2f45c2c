// Availability-rectangle scan of Algorithm 3 on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/availscan.py:
//   availscan_rects, availscan_one        <- availscan (l.146, body
//                                            _availscan_kernel l.112)
//   availscan_select                      <- availscan_select (l.373, body
//                                            _availscan_select_kernel l.306)
//   availscan_rects_mr, availscan_one_mr  <- availscan_mr (l.228, body
//                                            _availscan_kernel_mr l.204,
//                                            _tile_rects_mr l.79)
//   availscan_select_mr                   <- availscan_select_mr (l.494, body
//                                            _availscan_select_kernel_mr
//                                            l.429)
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
// t_end, feasible.  An infeasible live candidate carries INT32_MAX in
// its three keys, so with nothing feasible the lowest live index wins;
// with no live candidate the row is INT32_MAX in the four keys and 0
// elsewhere.  The plain PyTorch versions are in ../ref.py.
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
// layout of up to 512 words (R <= W) at any capacity runs.  R = 1 and
// the multi-resource select differ only in how free units are counted
// and how feasibility is tested, so both are one templated device body
// (kMr).
//
// Packed words, no tensor cores.  The TPU kernels bit-expand occupancy
// to f32 and contract it on the matrix unit.  The work is bitwise OR,
// AND and popcount over a few KB: wgmma has no 1-bit type, and the
// bit-expanded f32 form would multiply the bytes by 32 for nothing.
// So the words stay packed (int32 with uint32 bits): lane w of a warp
// holds words w + 32 j, and the record axis is walked, not multiplied.
// Two modes share that arithmetic.  With many candidates one warp takes
// one candidate:
//   * two warp-uniform 32-ary searches over the sorted times (the lanes
//     probe 32 times at once, a ballot keeps one chunk: one round up to
//     32 records, two up to 1024) find the overlapping records [lo, hi);
//   * one loop ORs those rows, eight rows' reads in flight, and a __popc
//     + warp sum gives n_free;
//   * the blocking test runs outward from the window, left from lo - 1
//     and right from hi, four records a step with __any_sync, and stops
//     at the first blocking record; since times are sorted that record
//     holds the max end / min start the definitions ask for.
// The early reject's one window has an entry of its own, where the
// whole block takes the candidate; see "Design of the one-window mode"
// below.
//
// Bound.  At the paper's size (S = 128 records, P = 258 candidates,
// W = 32 words, ~25 live records; 46 words for the four-resource
// machine) a call reads the live records' rows, the times and the
// starts, ~5-10 KB, and does ~10^4 word operations: the card could do
// that in a few nanoseconds.  The early reject (P = 1) reads the live
// times (~1 KB at S = 256) and a handful of rows.  What bounds a call
// on this card is latency: the launch, the first reads from global
// memory (hundreds of cycles), the chain of dependent reads and votes a
// warp walks per candidate, and the cross-block reduction's round trips
// to L2 (a release-acquire atomic, then the rows).  The designs below
// keep each of those to once per call.  Per mode: the many-candidate
// mode pays one staging round per block, then works in shared memory;
// the one-window mode pays its dependent rounds of reads (two, or three
// when a far band runs) and its barriers, all inside one block, so at
// P = 1 the card's width buys nothing and latency is the whole cost.
// tools/select_stamps.py shows where a call's cycles go on the card.
//
// Design of the many-candidate mode (the select kernels, and the
// rectangle kernels on a starts tensor of any P): one launch per call,
// one device body (availscan_select_kernel<NW, kMr, kRects>).
//   * Staging.  At the start each block issues every read that needs no
//     earlier one, before it uses any of them: times[0 : min(S,
//     rows_cap + 1)] (stored to shared memory and counted), the block's
//     starts, occ's first rows (up to kFirstBytes, by 16-byte
//     cp.async), the demand tail and the lane's layout words.  After
//     one barrier the warps' counts give the live count n_live (times
//     are sorted, T_INF padding last); the host never reads it.  If
//     the live rows fit the budget (rows_cap, from S, W and
//     kSmemBudget) but not the first copy, the rest follow by
//     cp.async.  The searches, the OR and the outward scans then read
//     shared memory.  When the live rows exceed the budget, the same
//     body walks global memory; the branch is chosen on the card from
//     n_live.  At the paper's shape the live rows fit the first copy,
//     so a block pays one round trip before it computes.  The copies
//     are cp.async rather than a TMA bulk copy: on the card the bulk
//     copy's mbarrier set-up delayed the issuing warp's own loads by
//     more than the whole 6 KB copy takes by cp.async.
//   * Grid.  kWarps warps a block, one candidate a warp at a time, a
//     grid-stride loop over candidates; at most kMaxBlocks blocks (two
//     per SM of an H100, one wave).  A block whose candidates are all
//     dead (the T_INF tail candidate_starts leaves) computes nothing.
//   * Cross-block reduction.  TPU grid steps run in order and fold into
//     one accumulator; CUDA blocks do not.  Each block folds its warps'
//     rows in warp 0 (hardware min reductions over the keys), writes its
//     best row to scratch and draws a ticket from a counter in the same
//     scratch with one device-scope acquire-release atomic add; the
//     block that draws the last ticket reduces the rows in one warp,
//     writes out[8] and resets the counter to 0, so back-to-back calls
//     (and a captured CUDA graph) find it at 0.  The index key is
//     unique, so the order of the reduction never matters.  A grid of
//     one block writes out[8] directly.  A thread-block cluster of 8
//     blocks meeting in one block's shared memory (at up to 5
//     candidates a warp) was tried in place of the ticket at the
//     paper's shape and gained less than two calls of the same code
//     differ, so the one path stays.
//   * Rectangles.  With kRects the same body writes each candidate's
//     n_free / t_begin / t_end (and on _mr its R - 1 plane counts) to
//     one int32 buffer and stops: no ticket, no reduction.  A dead
//     candidate writes zeros; a block whose candidates are all dead
//     reads nothing.
//
// Design of the one-window mode (availscan_one_kernel<NW, kMr>, P = 1:
// the early reject's rectangle).  The first design gave the candidate
// one warp of a 256-thread block (the other seven returned at once),
// and that warp walked a chain of dependent global reads: the two
// 32-ary searches, the OR over the window's rows, then the scans four
// records a step, out to the first blocking record or to the end (on
// the saturated stream 180 of 480 probes have no blocking record on
// either side: ~360 records, ~90 steps).  Here the whole block takes the
// candidate:
//   1. every thread reads its share of times[0, S) (one coalesced round
//      at S <= 256, strided above), keeps it in shared memory (S <=
//      kOneTimes; global memory serves the lookups above) and counts
//      #{t <= a}, #{t < b} and the live records; with the layout words
//      on _mr that is all the round reads.  A block sum gives lo, hi and
//      n_live, so the overlap search costs no read of its own.
//   2. the eight warps take the window's rows [lo, hi) in stripes, and
//      each also takes the near band's record on either side (lo - 1 -
//      warp and hi + warp), all issued before any is used.  The partial
//      ORs fold by shared-memory atomicOr; after one barrier every warp
//      tests its band rows against the free words, and the nearest
//      blocking record on each side is a block-wide atomicMax (left) or
//      atomicMin (right) of the blocking indices: a warp farther out may
//      find one while the nearest finds none.
//   3. only for a side whose near band holds no blocking record: the
//      far bands, kThreads records a side a round, one a thread, nearest
//      first, each tested on the words that hold free units only (warp
//      0 lists them once busy is known: a record can block only there),
//      kFarBatch words' reads in flight at once (left to the register
//      allocator, the R = 4 far probes took 4.3 us a call, not 3.7);
//      block-wide max / min again.  The right side ends at n_live (T_INF
//      padding never blocks).
// So a call takes two dependent rounds of global reads after the launch
// when a blocking record lies within eight records of the window on
// each side, and one more per 256 records a side scans beyond that.
// The near band is eight records a side because on the saturated
// stream's timeline every probe that has a blocking record has it
// within seven records (counted on the CPU from that timeline), and
// clock stamps (tools/select_stamps.py) put the near-band test at ~620
// cycles against ~1,550 for a far round.  A first far band that staged
// whole rows by cp.async and tested them a warp a row took 5.4 us a
// call against 2.3 us for the near probes (tools/rects_before_after.py,
// NVIDIA H100 80GB HBM3 at 700 W); the thread-a-record test on the free
// words replaced it (2.9 us).  On _mr one set of R plane counters in shared
// memory serves the block.  The start comes as a kernel argument (the
// search knows it on the host), and the kernel also writes the rejected
// search result's t_s, t_e, found (0) and empty PE mask, so an early
// reject is this one launch and views of its output.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTInf = 2147483647;
constexpr int kBig = 2147483647;
constexpr int kWarps = 8;                 // candidates per block at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 264;           // select grid: 2 per SM, 132 SMs
constexpr int kScratchHead = 16;          // ints before the rows (counter)
constexpr int kSmemBudget = 96 * 1024;    // dynamic shared memory, bytes
constexpr int kFirstBytes = 6 * 1024;     // occ staged before n_live is known
constexpr int kMaxWordsMr = 512;          // multi-resource: 16 words per lane
constexpr int kOneTimes = 4096;           // times the one-window mode keeps
constexpr int kFarBatch = 8;              // far-band words read at once
constexpr unsigned kFull = 0xffffffffu;

struct Rect {
  int n_free;
  int t_begin;
  int t_end;
};

// The warp's count of sorted times[0, L) below v: #{k : times[k] < v},
// or #{k : times[k] <= v} (or_equal).  A 32-ary search: the lanes
// probe the last time of 32 equal chunks of the open range and a ballot
// keeps the chunk that holds the boundary, so ceil(log32 L) rounds of
// independent reads (one round up to 32 records, two up to 1024) where
// a binary search chains log2 L.  All lanes get the count.
struct Narrow {
  int lo, hi;           // the count lies in [lo, hi]; times [lo, hi) open
  int step;
};

__device__ __forceinline__ bool narrow_probe(Narrow& n, const int* times,
                                             int L, int v, bool or_equal,
                                             int lane) {
  n.step = (n.hi - n.lo + 31) >> 5;
  const int i = n.lo + (lane + 1) * n.step - 1;
  // an unconditional read of a valid index (L >= 1 while any search is
  // open), so no branch guards the load
  const int t = times[min(i, L - 1)];
  return n.lo < n.hi && i < n.hi && (or_equal ? t <= v : t < v);
}

__device__ __forceinline__ void narrow_apply(Narrow& n, bool ok) {
  const int c = __popc(__ballot_sync(kFull, ok));
  if (n.lo < n.hi) {
    const int lo = n.lo + c * n.step;
    n.hi = min(lo + n.step - 1, n.hi);
    n.lo = lo;
  }
}

// record k overlaps [a, b) iff times[k] < b and next(k) > a, where
// next(k) = times[k + 1] (T_INF past the end).  Both are monotone in
// k, so the overlapping records are [lo, hi): lo = #{times <= a} - 1
// (at least 0), hi = #{times < b}; the two searches run interleaved.
// L is S, or the live count n_live (every record past it is T_INF
// padding, which changes neither count since a < T_INF and b <= T_INF).
__device__ __forceinline__ void overlap_range(const int* times, int L, int a,
                                              int b, int lane, int* lo,
                                              int* hi) {
  if (L <= 32) {                                    // one read a lane
    const int t = times[min(lane, max(L - 1, 0))];
    const bool in = lane < L;
    *lo = max(__popc(__ballot_sync(kFull, in && t <= a)) - 1, 0);
    *hi = __popc(__ballot_sync(kFull, in && t < b));
    return;
  }
  Narrow na = {0, L, 0}, nb = {0, L, 0};
  while (na.lo < na.hi || nb.lo < nb.hi) {          // warp-uniform
    const bool oka = narrow_probe(na, times, L, a, true, lane);
    const bool okb = narrow_probe(nb, times, L, b, false, lane);
    narrow_apply(na, oka);
    narrow_apply(nb, okb);
  }
  *lo = max(na.lo - 1, 0);
  *hi = nb.lo;
}

// A warp's share of one occupancy row: lane holds words lane + 32 j,
// j < NW, so a row read is coalesced.  busy = OR of rows [lo, hi), up
// to eight rows' reads in flight at a time.
template <int NW>
__device__ __forceinline__ void window_busy(const unsigned* __restrict__ occ,
                                            int W, int lo, int hi, int lane,
                                            unsigned (&busy)[NW]) {
  bool in[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    busy[j] = 0u;
    in[j] = lane + 32 * j < W;
  }
  // rows in flight: eight while that keeps registers low, fewer with
  // many words a lane
  constexpr int kRows = NW <= 2 ? 8 : NW <= 4 ? 4 : 2;
  const unsigned* row = occ + (size_t)lo * W + lane;
  int k = lo;
  for (; k + kRows <= hi; k += kRows, row += kRows * W) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
#pragma unroll
      for (int j = 0; j < NW; ++j)
        if (in[j]) busy[j] |= row[u * W + 32 * j];
    }
  }
  for (; k < hi; ++k, row += W) {
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (in[j]) busy[j] |= row[32 * j];
  }
}

// the lane's share of whether a row occupies one of the free units
template <int NW>
__device__ __forceinline__ unsigned lane_hit(const unsigned* __restrict__ row,
                                             int W, int lane,
                                             const unsigned (&fr)[NW]) {
  unsigned hit = 0u;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = lane + 32 * j;
    if (w < W) hit |= row[w] & fr[j];
  }
  return hit;
}

// The outward scans, from the window to the first blocking record on
// each side (four records' reads in flight at a time); since times are
// sorted that record holds the max end / min start the definitions ask
// for.
template <int NW>
__device__ __forceinline__ void outward_scans(const int* __restrict__ times,
                                              const unsigned* __restrict__ occ,
                                              int L, int W, int lo, int hi,
                                              int a, int t_now, int lane,
                                              const unsigned (&fr)[NW],
                                              Rect* r) {
  // left: records [0, lo) end at or before a
  int tb = -kTInf;
  for (int k = lo - 1; k >= 0; k -= 4) {
    unsigned hit[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned h =
          lane_hit<NW>(occ + (size_t)max(k - u, 0) * W, W, lane, fr);
      hit[u] = k - u >= 0 ? h : 0u;
    }
    int found = -1;                       // the blocking record nearest a
#pragma unroll
    for (int u = 3; u >= 0; --u)
      if (__any_sync(kFull, hit[u] != 0u)) found = k - u;
    if (found >= 0) {
      tb = times[found + 1];
      break;
    }
  }
  // right: records [hi, L) start at or after b; padding never blocks
  int te = kTInf;
  for (int k = hi; k < L; k += 4) {
    int t[4];
    unsigned hit[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = min(k + u, L - 1);
      const int tk = times[kk];
      const unsigned h = lane_hit<NW>(occ + (size_t)kk * W, W, lane, fr);
      t[u] = k + u < L ? tk : kTInf;
      hit[u] = t[u] != kTInf ? h : 0u;
    }
    bool found = false;                   // the blocking record nearest b
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      if (__any_sync(kFull, hit[u] != 0u)) {
        found = true;
        te = t[u];
      }
    }
    if (found || t[3] == kTInf) break;
  }
  r->t_begin = min(max(tb, t_now), a);
  r->t_end = te;
}

// A lane's words of the layout: the valid mask (all ones on R = 1) and
// the plane ids, zero past W.
template <int NW, bool kMr>
__device__ __forceinline__ void lane_layout(const unsigned* __restrict__ valid,
                                            const int* __restrict__ plane,
                                            int W, int lane,
                                            unsigned (&vm)[NW],
                                            int (&pl)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = lane + 32 * j;
    vm[j] = w < W ? (kMr ? valid[w] : kFull) : 0u;
    pl[j] = kMr && w < W ? plane[w] : 0;
  }
}

// One warp: the rectangle of window [a, b) over records [0, L) of
// times / occ (global or shared memory).  R = 1 (kMr false): n_free =
// n_pe - popcount(busy), the free words ~busy.  Multi-resource: free =
// ~busy & valid, so padding and dead units are never free; plane q's
// free units are counted into cnt[q] (the warp's own shared counters: a
// plane's words may sit in several lanes, and a lane's words in several
// planes) and n_free is plane 0's count.  All lanes get the result.
template <int NW, bool kMr>
__device__ __forceinline__ Rect scan_window(const int* __restrict__ times,
                                            const unsigned* __restrict__ occ,
                                            int L, int W, int a, int b,
                                            int t_now, int n_pe, int lane,
                                            const unsigned (&vm)[NW],
                                            const int (&pl)[NW], int* cnt,
                                            int R) {
  int lo, hi;
  overlap_range(times, L, a, b, lane, &lo, &hi);
  unsigned busy[NW];
  window_busy<NW>(occ, W, lo, hi, lane, busy);
  unsigned fr[NW];
  Rect r;
  if (!kMr) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += __popc(busy[j]);
      fr[j] = ~busy[j] & vm[j];
    }
    r.n_free = n_pe - __reduce_add_sync(kFull, c);
  } else {
    for (int q = lane; q < R; q += 32) cnt[q] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      fr[j] = ~busy[j] & vm[j];
      const int c = __popc(fr[j]);
      if (c) atomicAdd(&cnt[pl[j]], c);
    }
    __syncwarp();
    r.n_free = cnt[0];
  }
  outward_scans<NW>(times, occ, L, W, lo, hi, a, t_now, lane, fr, &r);
  return r;
}

// ---------------------------------------------------------------------------
// the many-candidate mode: the select kernels and the rectangles at P > 1
// ---------------------------------------------------------------------------

// lexicographic (key1, key2, start_key, index) less-than, without
// branches
__device__ __forceinline__ bool row_less(const int (&x)[8],
                                         const int (&y)[8]) {
  return (x[0] < y[0]) |
         ((x[0] == y[0]) &
          ((x[1] < y[1]) |
           ((x[1] == y[1]) &
            ((x[2] < y[2]) | ((x[2] == y[2]) & (x[3] < y[3]))))));
}

__device__ __forceinline__ void sentinel_row(int (&row)[8]) {
  row[0] = row[1] = row[2] = row[3] = kBig;
  row[4] = row[5] = row[6] = row[7] = 0;
}

__device__ __forceinline__ void take_if_less(int (&best)[8],
                                             const int (&row)[8]) {
  const bool less = row_less(row, best);
#pragma unroll
  for (int j = 0; j < 8; ++j) best[j] = less ? row[j] : best[j];
}

__device__ __forceinline__ void write_row(int* __restrict__ out,
                                          const int (&row)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = row[j];
}

// The warp's minimum row, in every lane: one hardware min reduction
// (redux.sync) a key over the lanes still tied, then the winner's row
// by shuffle.  Some lane always stays tied, and the index key is unique
// among live rows (sentinel rows are equal), so the winner's row is the
// lexicographic minimum.
__device__ __forceinline__ void warp_min_row(int (&row)[8]) {
  bool tied = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = __reduce_min_sync(kFull, tied ? row[j] : kBig);
    tied = tied && row[j] == m;
  }
  const int src = __ffs(__ballot_sync(kFull, tied)) - 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) row[j] = __shfl_sync(kFull, row[j], src);
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
  // a select chain, not a switch: no branch on the policy
  const int k1 = policy == 1 ? nf : policy == 2 ? -nf : policy == 3 ? du
               : policy == 4 ? -du : policy == 5 ? p_hi
               : policy == 6 ? -p_hi : 0;
  const int k2 = policy == 5 ? p_lo : policy == 6 ? -p_lo : 0;
  *key1 = k1;
  *key2 = k2;
}

// a live candidate's row: the policy keys of (n_free, t_end - t_begin)
// when feasible, INT32_MAX keys otherwise
__device__ __forceinline__ void candidate_row(int (&row)[8], int policy,
                                              int s, int p, const Rect& r,
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous global -> shared copies: cp.async, 16 or 4 bytes a thread.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Words [begin, end) of src into the same offsets of dst (16-byte
// aligned), by the block's threads with cp.async: 16 bytes a copy where
// src is 16-byte aligned, 4 bytes at the edges and otherwise.
__device__ __forceinline__ void stage_words(unsigned* dst,
                                            const unsigned* src,
                                            unsigned begin, unsigned end,
                                            int tid) {
  unsigned b16 = begin, e16 = begin;      // the 16-byte body [b16, e16)
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    b16 = min((begin + 3u) & ~3u, end);
    e16 = max(b16, end & ~3u);
  }
  for (unsigned i = begin + tid; i < b16; i += kThreads)
    cp_async4(dst + i, src + i);
  for (unsigned i = b16 + 4u * tid; i < e16; i += 4u * kThreads)
    cp_async16(dst + i, src + i);
  for (unsigned i = e16 + tid; i < end; i += kThreads)
    cp_async4(dst + i, src + i);
}

// ticket counter: add with release (the block's row is written) and
// acquire (so is every earlier block's) semantics at device scope
__device__ __forceinline__ unsigned ticket_add(int* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

struct SelectArgs {
  const int* times;
  const unsigned* occ;
  const unsigned* valid;      // multi-resource only
  const int* plane;           // multi-resource only
  const int* demand;          // multi-resource only, int32[R - 1]
  const int* starts;
  int S, W, R, P, t_du, t_now, n_req, policy, n_pe;
  int rows_cap;               // live rows the shared-memory branch takes
  int rows_first;             // rows staged before n_live is known
};

// Rectangle mode: candidate p's n_free, t_begin, t_end into out, an
// int32[3, P] block followed on _mr by the int32[P, R - 1] plane
// counts; a dead candidate (live false) writes zeros.
template <bool kMr>
__device__ __forceinline__ void write_rect(const SelectArgs& g,
                                           int* __restrict__ out, int p,
                                           const Rect& r, const int* cnt,
                                           bool live, int lane) {
  if (lane == 0) {
    out[p] = r.n_free;
    out[g.P + p] = r.t_begin;
    out[2 * g.P + p] = r.t_end;
  }
  if (kMr) {
    int* tail = out + 3 * (size_t)g.P + (size_t)p * (g.R - 1);
    for (int q = 1 + lane; q < g.R; q += 32) tail[q - 1] = live ? cnt[q] : 0;
    __syncwarp();                         // cnt is rezeroed next
  }
}

// One warp: its candidates p = blockIdx.x * kWarps + warp + k * gridDim.x
// * kWarps, over records [0, L) of times / occ.  Select: best holds the
// lowest row, in every lane.  Rectangles (kRects): each candidate's
// rectangle goes to out.  The first kThreads / kWarps starts of each
// warp come from s_starts.
template <int NW, bool kMr, bool kRects>
__device__ __forceinline__ void warp_candidates(
    const SelectArgs& g, const int* __restrict__ times,
    const unsigned* __restrict__ occ, int L, const int* s_starts,
    const unsigned (&vm)[NW], const int (&pl)[NW], int* cnt, const int* dem,
    int lane, int warp, int* __restrict__ out, int (&best)[8]) {
  int j = 0;
  for (int p = blockIdx.x * kWarps + warp; p < g.P;
       p += gridDim.x * kWarps, ++j) {
    const int s = j < kThreads / kWarps ? s_starts[j * kWarps + warp]
                                        : g.starts[p];
    if (kRects) {
      Rect r = {0, 0, 0};
      if (s < kTInf) {                    // warp-uniform
        const int a = min(s, kTInf - g.t_du);
        r = scan_window<NW, kMr>(times, occ, L, g.W, a, a + g.t_du, g.t_now,
                                 g.n_pe, lane, vm, pl, cnt, g.R);
      }
      write_rect<kMr>(g, out, p, r, cnt, s < kTInf, lane);
      continue;
    }
    if (s >= kTInf) continue;             // warp-uniform
    const int a = min(s, kTInf - g.t_du);
    const Rect r = scan_window<NW, kMr>(times, occ, L, g.W, a, a + g.t_du,
                                        g.t_now, g.n_pe, lane, vm, pl, cnt,
                                        g.R);
    bool feasible;
    if (kMr) {
      // vector fit: plane 0 covers n_req, plane q >= 1 its demand (no
      // demand is read when R == 1)
      bool short_of = r.n_free < g.n_req;
      for (int q = 1 + lane; q < g.R; q += 32) short_of |= cnt[q] < dem[q - 1];
      feasible = !__any_sync(kFull, short_of);
      __syncwarp();                       // cnt is rezeroed next
    } else {
      feasible = r.n_free >= g.n_req;
    }
    int row[8];
    candidate_row(row, g.policy, s, p, r, feasible);
    take_if_less(best, row);
  }
}

// The many-candidate body.  Select: the fused scan + select, one
// int32[8] row in out; scratch: int32[kScratchHead + 8 * kMaxBlocks],
// scratch[0] the ticket counter (0 between calls), the block rows from
// kScratchHead on.  Rectangles (kRects): every candidate's rectangle in
// out (see write_rect), scratch unused.  Dynamic shared memory: occ rows
// [0, rows_cap), then times [0, rows_cap + 1).
template <int NW, bool kMr, bool kRects>
__global__ void __launch_bounds__(kThreads)
availscan_select_kernel(const SelectArgs g, int* __restrict__ scratch,
                        int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int s_starts[kThreads];      // one start a thread
  __shared__ int warp_live[kWarps];
  __shared__ int warp_rows[kWarps][8];
  __shared__ int counts[kMr ? kWarps : 1][kMr ? kMaxWordsMr : 1];
  __shared__ int dem[kMr ? kMaxWordsMr : 1];
  unsigned* s_occ = reinterpret_cast<unsigned*>(dyn_smem);
  int* s_times = reinterpret_cast<int*>(s_occ + (size_t)g.rows_cap * g.W);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Everything that needs no earlier read, issued before any of it is
  // used: the thread's first time and first start (a thread's start is
  // its slot of the block's first kThreads candidates), occ's first
  // rows_first rows (cp.async), the demand tail and the lane's layout
  // words; then the rest of times[0 : rows_cap + 1] and of the starts.
  const int n_times = min(g.S, g.rows_cap + 1);
  const int p0 = ((tid / kWarps) * gridDim.x + blockIdx.x) * kWarps +
                 tid % kWarps;
  const int t0 = tid < n_times ? g.times[tid] : kTInf;
  const int s0 = p0 < g.P ? g.starts[p0] : kTInf;
  const unsigned first = (unsigned)g.rows_first * (unsigned)g.W;
  stage_words(s_occ, g.occ, 0u, first, tid);
  if (kMr && !kRects)
    for (int q = tid; q < g.R - 1; q += kThreads) dem[q] = g.demand[q];
  unsigned vm[NW];
  int pl[NW];
  lane_layout<NW, kMr>(g.valid, g.plane, g.W, lane, vm, pl);
  // the times staged and counted (sorted, T_INF padding last), whether
  // any of the block's candidates is live
  if (tid < n_times) s_times[tid] = t0;
  int n_below = t0 < kTInf;
  for (int i = tid + kThreads; i < n_times; i += kThreads) {
    const int t = g.times[i];
    s_times[i] = t;
    n_below += t < kTInf;
  }
  s_starts[tid] = s0;
  bool mine = s0 < kTInf;
  for (int i = tid + kThreads;; i += kThreads) {
    const int p = ((i / kWarps) * gridDim.x + blockIdx.x) * kWarps +
                  i % kWarps;
    if (p >= g.P) break;
    mine |= g.starts[p] < kTInf;
  }
  n_below = __reduce_add_sync(kFull, n_below);
  if (lane == 0) warp_live[warp] = n_below;
  cp_async_wait_all();
  const bool any_live = __syncthreads_or(mine);

  int best[8];
  sentinel_row(best);
  int* cnt = kMr ? counts[warp] : nullptr;
  if (any_live) {                         // block-uniform
    // the live count: times are sorted, T_INF padding last
    int n_live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n_live += warp_live[w];
    if (n_live <= g.rows_cap) {           // block-uniform
      if (n_live > g.rows_first) {
        stage_words(s_occ, g.occ, first, (unsigned)n_live * g.W, tid);
        cp_async_wait_all();
      }
      __syncthreads();
      warp_candidates<NW, kMr, kRects>(g, s_times, s_occ, n_live, s_starts,
                                       vm, pl, cnt, dem, lane, warp, out,
                                       best);
    } else {
      warp_candidates<NW, kMr, kRects>(g, g.times, g.occ, g.S, s_starts, vm,
                                       pl, cnt, dem, lane, warp, out, best);
    }
  } else if (kRects) {
    // every candidate of the block is dead: zeros, nothing read
    warp_candidates<NW, kMr, kRects>(g, g.times, g.occ, 0, s_starts, vm, pl,
                                     cnt, dem, lane, warp, out, best);
  }
  if (kRects) return;                     // no row to combine

  // the block's row: fold the warps' rows in warp 0
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) warp_rows[warp][j] = best[j];
  }
  __syncthreads();
  if (warp != 0) return;
  int row[8];
  if (lane < kWarps) {
#pragma unroll
    for (int j = 0; j < 8; ++j) row[j] = warp_rows[lane][j];
  } else {
    sentinel_row(row);
  }
  warp_min_row(row);
  if (gridDim.x == 1) {
    if (lane == 0) write_row(out, row);
    return;
  }
  int* counter = scratch;
  int4* rows = reinterpret_cast<int4*>(scratch + kScratchHead);
  unsigned ticket = 0;
  if (lane == 0) {
    __stcg(rows + 2 * blockIdx.x, make_int4(row[0], row[1], row[2], row[3]));
    __stcg(rows + 2 * blockIdx.x + 1,
           make_int4(row[4], row[5], row[6], row[7]));
    ticket = ticket_add(counter);
  }
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != gridDim.x - 1) return;    // warp-uniform
  __syncwarp();
  // the last block's warp 0: every block's row is written
  sentinel_row(row);
  for (int i = lane; i < (int)gridDim.x; i += 32) {
    const int4 lo = __ldcg(rows + 2 * i);
    const int4 hi = __ldcg(rows + 2 * i + 1);
    const int other[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    take_if_less(row, other);
  }
  warp_min_row(row);
  if (lane == 0) {
    write_row(out, row);
    *reinterpret_cast<volatile int*>(counter) = 0;   // for the next call
  }
}

// ---------------------------------------------------------------------------
// the one-window mode: one candidate, the whole block (the early reject)
// ---------------------------------------------------------------------------

struct OneArgs {
  const int* times;
  const unsigned* occ;
  const unsigned* valid;      // multi-resource only
  const int* plane;           // multi-resource only
  int* out;
  int s, S, W, R, t_du, t_now, n_pe;
};

// the lane's words of record k (zeros for k < 0: no record)
template <int NW>
__device__ __forceinline__ void lane_row(const unsigned* __restrict__ occ,
                                         int W, int k, int lane,
                                         unsigned (&x)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = lane + 32 * j;
    x[j] = k >= 0 && w < W ? occ[(size_t)k * W + w] : 0u;
  }
}

// whether a row held in registers occupies one of the free units
template <int NW>
__device__ __forceinline__ bool warp_blocks(const unsigned (&x)[NW],
                                            const unsigned (&fr)[NW]) {
  unsigned hit = 0u;
#pragma unroll
  for (int j = 0; j < NW; ++j) hit |= x[j] & fr[j];
  return __any_sync(kFull, hit != 0u);
}

// The window's output: n_free, t_begin, t_end and the R - 1 plane
// counts (cnt[1..R-1], zeros without cnt), then the rejected search's
// t_s = s, t_e = s + t_du (int32 wrap, as the reference adds), found =
// 0 and W zero words of PE mask.
__device__ __forceinline__ void write_one(const OneArgs& g, int s, int n_free,
                                          int t_begin, int t_end,
                                          const int* cnt, int tid) {
  int* out = g.out;
  if (tid == 0) {
    out[0] = n_free;
    out[1] = t_begin;
    out[2] = t_end;
  }
  for (int q = 1 + tid; q < g.R; q += kThreads)
    out[2 + q] = cnt != nullptr ? cnt[q] : 0;
  int* tail = out + g.R + 2;
  if (tid == 0) {
    tail[0] = s;
    tail[1] = (int)((unsigned)s + (unsigned)g.t_du);
    tail[2] = 0;
  }
  for (int w = tid; w < g.W; w += kThreads) tail[3 + w] = 0;
}

// One launch of one block: the rectangle of the window at start s.
template <int NW, bool kMr>
__global__ void __launch_bounds__(kThreads)
availscan_one_kernel(const OneArgs g) {
  constexpr int kW = kMr ? kMaxWordsMr : 64;
  __shared__ int s_times[kOneTimes];      // times[0, S) when S <= kOneTimes
  __shared__ unsigned s_busy[kW];
  __shared__ int s_cnt[kMr ? kMaxWordsMr : 1];
  __shared__ int s_nz[kW];                // the words with free units
  __shared__ unsigned s_nz_free[kW];      // and their free bits
  __shared__ int s_sum[3][kWarps];
  __shared__ int s_left, s_right;         // nearest blocking records
  __shared__ int s_n_nz;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = g.s;
  if (s >= kTInf) {                       // block-uniform: a dead start
    write_one(g, s, 0, 0, 0, nullptr, tid);
    return;
  }
  const int a = min(s, kTInf - g.t_du);
  const int b = a + g.t_du;
  const bool staged_times = g.S <= kOneTimes;

  // Round 1: the layout words and every time, counted (and kept in
  // shared memory for the result's lookups).  Records [lo, hi) overlap
  // [a, b): lo = #{t <= a} - 1 (at least 0), hi = #{t < b}; the n_live
  // live records come first (sorted, T_INF padding last).
  unsigned vm[NW];
  int pl[NW];
  lane_layout<NW, kMr>(g.valid, g.plane, g.W, lane, vm, pl);
  int na = 0, nb = 0, nl = 0;
#pragma unroll 4
  for (int i = tid; i < g.S; i += kThreads) {
    const int t = g.times[i];
    if (staged_times) s_times[i] = t;
    na += t <= a;
    nb += t < b;
    nl += t < kTInf;
  }
  for (int w = tid; w < g.W; w += kThreads) s_busy[w] = 0u;
  if (kMr)
    for (int q = tid; q < g.R; q += kThreads) s_cnt[q] = 0;
  if (tid == 0) {
    s_left = -1;
    s_right = kBig;
  }
  na = __reduce_add_sync(kFull, na);
  nb = __reduce_add_sync(kFull, nb);
  nl = __reduce_add_sync(kFull, nl);
  if (lane == 0) {
    s_sum[0][warp] = na;
    s_sum[1][warp] = nb;
    s_sum[2][warp] = nl;
  }
  __syncthreads();
  na = nb = nl = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    na += s_sum[0][w];
    nb += s_sum[1][w];
    nl += s_sum[2][w];
  }
  const int lo = max(na - 1, 0);
  const int hi = nb;
  const int L = nl;

  // Round 2, every read issued before any is used: the near band, one
  // record a warp on each side (kl = lo - 1 - warp ends at or before a,
  // kr = hi + warp starts at or after b), then the warp's stripe of the
  // window's rows.
  const int kl = lo - 1 - warp;
  const int kr = hi + warp;
  unsigned left[NW], right[NW];
  lane_row<NW>(g.occ, g.W, kl, lane, left);
  lane_row<NW>(g.occ, g.W, kr < L ? kr : -1, lane, right);
  unsigned busy[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) busy[j] = 0u;
#pragma unroll 2
  for (int k = lo + warp; k < hi; k += kWarps) {
    unsigned x[NW];
    lane_row<NW>(g.occ, g.W, k, lane, x);
#pragma unroll
    for (int j = 0; j < NW; ++j) busy[j] |= x[j];
  }
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (busy[j]) atomicOr(&s_busy[lane + 32 * j], busy[j]);
  __syncthreads();

  // the window's busy and free words, in every warp; the counts
  unsigned fr[NW];
  int c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int w = lane + 32 * j;
    const unsigned bw = w < g.W ? s_busy[w] : 0u;
    c += __popc(bw);
    fr[j] = ~bw & vm[j];
  }
  const int n_busy = __reduce_add_sync(kFull, c);
  if (warp == 0) {
    // the plane counts, and the list of words with free units (a record
    // can block only through them), in word order
    int n_nz = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (kMr) {
        const int cf = __popc(fr[j]);
        if (cf) atomicAdd(&s_cnt[pl[j]], cf);
      }
      const unsigned m = __ballot_sync(kFull, fr[j] != 0u);
      if (fr[j] != 0u) {
        const int at = n_nz + __popc(m & ((1u << lane) - 1u));
        s_nz[at] = lane + 32 * j;
        s_nz_free[at] = fr[j];
      }
      n_nz += __popc(m);
    }
    if (lane == 0) s_n_nz = n_nz;
  }
  // the near band's tests: the nearest blocking record on each side is
  // the block's max (left) / min (right) of the warps' blocking ones
  if (kl >= 0 && warp_blocks<NW>(left, fr) && lane == 0)
    atomicMax(&s_left, kl);
  if (kr < L && warp_blocks<NW>(right, fr) && lane == 0)
    atomicMin(&s_right, kr);
  __syncthreads();

  // The far bands, only for a side whose near band holds no blocking
  // record: one record a thread on each open side a round (kThreads
  // records a side, nearest first), each tested on the free words only;
  // the nearest blocking one is the block's max / min again.
  const int n_nz = s_n_nz;
  int next_l = lo - kWarps;               // records [0, next_l) untested
  int next_r = hi + kWarps;               // records [next_r, L) untested
  for (;;) {
    const bool open_l = s_left < 0 && next_l > 0 && n_nz > 0;
    const bool open_r = s_right == kBig && next_r < L && n_nz > 0;
    if (!open_l && !open_r) break;        // block-uniform
    __syncthreads();                      // flags read before the writes
    const int fl = next_l - 1 - tid;
    const int fr_k = next_r + tid;
    const bool do_l = open_l && fl >= 0;
    const bool do_r = open_r && fr_k < L;
    const unsigned* row_l = g.occ + (size_t)(do_l ? fl : 0) * g.W;
    const unsigned* row_r = g.occ + (size_t)(do_r ? fr_k : 0) * g.W;
    // kFarBatch words' reads of each side in flight before any is used
    unsigned hit_l = 0u, hit_r = 0u;
    for (int i = 0; i < n_nz; i += kFarBatch) {
      unsigned xl[kFarBatch], xr[kFarBatch], f[kFarBatch];
#pragma unroll
      for (int u = 0; u < kFarBatch; ++u) {
        const bool in = i + u < n_nz;
        const int w = in ? s_nz[i + u] : 0;
        f[u] = in ? s_nz_free[i + u] : 0u;
        xl[u] = do_l && in ? row_l[w] : 0u;
        xr[u] = do_r && in ? row_r[w] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kFarBatch; ++u) {
        hit_l |= xl[u] & f[u];
        hit_r |= xr[u] & f[u];
      }
    }
    const int best_l = __reduce_max_sync(kFull, hit_l ? fl : -1);
    const int best_r = __reduce_min_sync(kFull, hit_r ? fr_k : kBig);
    if (lane == 0) {
      if (best_l >= 0) atomicMax(&s_left, best_l);
      if (best_r != kBig) atomicMin(&s_right, best_r);
    }
    __syncthreads();
    next_l -= kThreads;
    next_r += kThreads;
  }
  // t_begin: the end of the nearest blocking record on the left,
  // times[k + 1]; t_end: the start of the nearest on the right
  const int kb = s_left + 1;
  const int tb = s_left < 0 ? -kTInf : staged_times ? s_times[kb]
                                                    : g.times[kb];
  const int te = s_right == kBig ? kTInf
                 : staged_times ? s_times[s_right] : g.times[s_right];
  const int n_free = kMr ? s_cnt[0] : g.n_pe - n_busy;
  write_one(g, s, n_free, min(max(tb, g.t_now), a), te,
            kMr ? s_cnt : nullptr, tid);
}

__global__ void empty_kernel() {}

int n_blocks(int P) { return (P + kWarps - 1) / kWarps; }

int select_blocks(int P) {
  const int nb = n_blocks(P);
  return nb < kMaxBlocks ? nb : kMaxBlocks;
}

// live rows the shared-memory branch can stage at S x W (each row with
// its time, plus one time)
int smem_rows(int S, int W) {
  const int fit = (kSmemBudget / 4 - 1) / (W + 1);
  return S < fit ? S : fit;
}

// rows staged before the live count is known: up to kFirstBytes
int first_rows(int rows_cap, int W) {
  const int fit = kFirstBytes / (4 * W);
  return rows_cap < fit ? rows_cap : (fit > 0 ? fit : 1);
}

template <int NW, bool kMr, bool kRects>
int launch_select(SelectArgs g, int* scratch, int* out, cudaStream_t stream) {
  auto kernel = availscan_select_kernel<NW, kMr, kRects>;
  // the dynamic shared-memory limit, once per device for this variant
  static unsigned long long attr_set = 0ull;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(attr_set & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err != cudaSuccess) return (int)err;
    attr_set |= bit;
  }
  g.rows_cap = smem_rows(g.S, g.W);
  g.rows_first = first_rows(g.rows_cap, g.W);
  const size_t bytes = ((size_t)g.rows_cap * (g.W + 1) + 1) * 4;
  kernel<<<select_blocks(g.P), kThreads, bytes, stream>>>(g, scratch, out);
  return (int)cudaGetLastError();
}

template <int NW, bool kMr>
int launch_one(const OneArgs& g, cudaStream_t stream) {
  availscan_one_kernel<NW, kMr><<<1, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, NW>{}) for the smallest instantiated
// words-per-lane count NW covering W (1 or 2 on R = 1, W <= 64)
template <bool kMr, typename F>
int with_words(int W, F f) {
  if (W <= 32) return f(std::integral_constant<int, 1>{});
  if constexpr (!kMr) {
    return f(std::integral_constant<int, 2>{});
  } else {
    if (W <= 64) return f(std::integral_constant<int, 2>{});
    if (W <= 128) return f(std::integral_constant<int, 4>{});
    if (W <= 256) return f(std::integral_constant<int, 8>{});
    return f(std::integral_constant<int, 16>{});
  }
}

// The rectangles of P candidates: the many-candidate body in rectangle
// mode (the one-window kernel has entries of its own).
template <bool kMr>
int launch_rects(const SelectArgs& g, int* out, cudaStream_t stream) {
  return with_words<kMr>(g.W, [&](auto nw) {
    return launch_select<decltype(nw)::value, kMr, true>(g, nullptr, out,
                                                         stream);
  });
}

}  // namespace

extern "C" {

int availscan_candidates_per_block(void) { return kWarps; }

int availscan_select_max_blocks(void) { return kMaxBlocks; }

// int32 elements of the select kernels' scratch (zeroed once)
int availscan_select_scratch_ints(void) {
  return kScratchHead + 8 * kMaxBlocks;
}

// live records the select kernels stage in shared memory at S x W; more
// live records than this take the global-memory branch
int availscan_smem_rows(int S, int W) { return smem_rows(S, W); }

const char* availscan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// An empty kernel of this library at the given launch shape: the
// launch floor.  Returns cudaGetLastError().
int availscan_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Rectangles, R = 1 (W <= 64).  out: int32[3, P] (n_free, t_begin,
// t_end).  Returns cudaGetLastError() after the one launch.
int availscan_rects(const void* times, const void* occ, const void* starts,
                    void* out, int S, int W, int P, int t_du, int t_now,
                    int n_pe, void* stream) {
  if (W < 1 || W > 64 || P < 1) return (int)cudaErrorInvalidValue;
  const SelectArgs g = {(const int*)times, (const unsigned*)occ, nullptr,
                        nullptr, nullptr, (const int*)starts, S, W, 1, P,
                        t_du, t_now, 0, 0, n_pe, 0, 0};
  return launch_rects<false>(g, (int*)out, (cudaStream_t)stream);
}

// One window at start s (a host integer), R = 1 (W <= 64): the early
// reject's rectangle and search result.  out: int32[6 + W]: n_free,
// t_begin, t_end, t_s, t_e, found (0), then W zero words of PE mask.
// Returns cudaGetLastError() after the one launch.
int availscan_one(const void* times, const void* occ, int s, void* out,
                  int S, int W, int t_du, int t_now, int n_pe,
                  void* stream) {
  if (W < 1 || W > 64) return (int)cudaErrorInvalidValue;
  const OneArgs o = {(const int*)times, (const unsigned*)occ, nullptr,
                     nullptr, (int*)out, s, S, W, 1, t_du, t_now, n_pe};
  cudaStream_t st = (cudaStream_t)stream;
  return with_words<false>(W, [&](auto nw) {
    return launch_one<decltype(nw)::value, false>(o, st);
  });
}

// Fused scan + select, R = 1 (W <= 64).  scratch:
// int32[availscan_select_scratch_ints()], zeroed once, one per stream;
// out: int32[8].  Returns cudaGetLastError() after the one launch.
int availscan_select(const void* times, const void* occ, const void* starts,
                     void* scratch, void* out, int S, int W, int P, int t_du,
                     int t_now, int n_req, int policy, int n_pe,
                     void* stream) {
  if (W < 1 || W > 64) return (int)cudaErrorInvalidValue;
  const SelectArgs g = {(const int*)times, (const unsigned*)occ, nullptr,
                        nullptr, nullptr, (const int*)starts, S, W, 1, P,
                        t_du, t_now, n_req, policy, n_pe, 0, 0};
  int* sc = (int*)scratch;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return with_words<false>(W, [&](auto nw) {
    return launch_select<decltype(nw)::value, false, false>(g, sc, o, st);
  });
}

int availscan_mr_max_words(void) { return kMaxWordsMr; }

// Multi-resource rectangles.  valid, plane: int32[W] (plane ids in
// [0, R), 1 <= R <= W <= availscan_mr_max_words()); out: int32[3, P]
// (n_free, t_begin, t_end) followed by int32[P, R - 1] (the other
// planes' counts).  Returns cudaGetLastError() after the one launch.
int availscan_rects_mr(const void* times, const void* occ, const void* valid,
                       const void* plane, const void* starts, void* out,
                       int S, int W, int R, int P, int t_du, int t_now,
                       void* stream) {
  if (W < 1 || W > kMaxWordsMr || R < 1 || R > W || P < 1)
    return (int)cudaErrorInvalidValue;
  const SelectArgs g = {(const int*)times, (const unsigned*)occ,
                        (const unsigned*)valid, (const int*)plane, nullptr,
                        (const int*)starts, S, W, R, P, t_du, t_now, 0, 0, 0,
                        0, 0};
  return launch_rects<true>(g, (int*)out, (cudaStream_t)stream);
}

// Multi-resource one window at start s.  out: int32[R + 5 + W]: n_free,
// t_begin, t_end, the other planes' counts (R - 1), t_s, t_e, found
// (0), then W zero words of PE mask.  Returns cudaGetLastError() after
// the one launch.
int availscan_one_mr(const void* times, const void* occ, const void* valid,
                     const void* plane, int s, void* out, int S, int W,
                     int R, int t_du, int t_now, void* stream) {
  if (W < 1 || W > kMaxWordsMr || R < 1 || R > W)
    return (int)cudaErrorInvalidValue;
  const OneArgs o = {(const int*)times, (const unsigned*)occ,
                     (const unsigned*)valid, (const int*)plane, (int*)out,
                     s, S, W, R, t_du, t_now, 0};
  cudaStream_t st = (cudaStream_t)stream;
  return with_words<true>(W, [&](auto nw) {
    return launch_one<decltype(nw)::value, true>(o, st);
  });
}

// Multi-resource fused select.  demand: int32[R - 1] (unread when
// R == 1); scratch, out as for availscan_select.  Returns
// cudaGetLastError() after the one launch.
int availscan_select_mr(const void* times, const void* occ, const void* valid,
                        const void* plane, const void* demand,
                        const void* starts, void* scratch, void* out, int S,
                        int W, int R, int P, int t_du, int t_now, int n_req,
                        int policy, void* stream) {
  if (W < 1 || W > kMaxWordsMr || R < 1 || R > W)
    return (int)cudaErrorInvalidValue;
  const SelectArgs g = {(const int*)times, (const unsigned*)occ,
                        (const unsigned*)valid, (const int*)plane,
                        (const int*)demand, (const int*)starts, S, W, R, P,
                        t_du, t_now, n_req, policy, 0, 0, 0};
  int* sc = (int*)scratch;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  return with_words<true>(W, [&](auto nw) {
    return launch_select<decltype(nw)::value, true, false>(g, sc, o, st);
  });
}

}  // extern "C"
