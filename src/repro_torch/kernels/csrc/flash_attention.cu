// Fused causal attention on Hopper (sm_90a): online softmax, forward and
// backward, for kernels/flash.py.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA.  It
// was added because the eager chain it replaces (models/attention.py::
// _sdpa) writes the [B, H, T, T] logits to device memory in bf16 and
// float32 and passes over them about ten times forward and as often
// backward (4.3-8.6 GB a call at T = 4,096), so it is bound by bytes the
// model does not need.  The work here is the causal half of QK^T and PV
// forward, and of QK^T, dO V^T, dS K, dS^T Q and P^T dO backward (QK^T
// and dO V^T are taken twice: once for dK / dV, once for dQ, so that no
// output has two writers).  Its bytes are q, k, v, o and dO read about
// once each, so at T = 4,096 it is bound by the tensor cores.
//
// Layouts: q [B, T, H, D], k [B, T, Hkv, D], v [B, T, Hkv, DV] (strides
// given, last stride 1, rows 16-byte aligned), o and do [B, T, H, DV]
// and the gradients contiguous; the log-sum-exp and delta [B, H, T]
// float32.  Query head h reads kv head h / n_rep (GQA without copies).
// One library is built per head-dim case: -DFLASH_D / -DFLASH_DV.
//
// bf16 (the training and serving dtype): warp-level tensor-core products
// (mma.sync m16n8k16, bf16 in, float32 accumulate) fed by ldmatrix from
// shared memory, tiles brought in by cp.async, double buffered.  Each
// warp owns 16 rows of its block's tile, so a row's softmax statistics
// stay in the four lanes that hold it, and a product's float32 result
// becomes the next product's bf16 operand in registers, without shared
// memory (P for PV and P^T dO, dS for dS K and dS^T Q).  Rows of shared
// memory are padded by 16 bytes, so ldmatrix's eight row addresses fall
// in distinct banks.
//   attention_fwd: a block per (batch, head, BM queries), the last query
//     tiles (the most keys) first; it walks the key / value tiles up to
//     the causal bound (none wholly above the diagonal), keeping the
//     running max and denominator in float32 and P rounded to bf16
//     before PV; it writes O and the log-sum-exp, never the logits.
//   attention_bwd_pre: delta = rowsum(dO * O) in float32.
//   attention_bwd_dkdv: a block per (batch, kv head, BN keys), the first
//     key tiles (the most queries) first; it walks its kv head's n_rep
//     query heads and the query tiles at or after its keys, taking S^T =
//     K Q^T and dP^T = V dO^T so that P^T and dS^T land in the key rows
//     the warp owns, then dV += P^T dO and dK += dS^T Q.
//   attention_bwd_dq: a block per (batch, head, BM queries) over the key
//     tiles up to the diagonal: dQ += dS K.
// Every output row has one writer and every sum a fixed order: no
// atomics, the same bits from run to run.
//
// float32 (the float32 configs held against the CPU): the same three
// passes with full-float32 arithmetic on the CUDA cores, a thread a row
// (the tensor cores' float32 mode is TF32); small shapes only.  Built
// apart (-DFLASH_F32=1), so a bf16 run compiles the bf16 kernels alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef FLASH_D
#define FLASH_D 64
#endif
#ifndef FLASH_DV
#define FLASH_DV 64
#endif
#ifndef FLASH_F32
#define FLASH_F32 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = FLASH_D;
constexpr int kDV = FLASH_DV;
static_assert(kD % 16 == 0 && kDV % 16 == 0, "head dims are multiples of 16");

// Tiles, fixed per case (no autotuning): warps of each kernel, 16-row
// m-tiles a warp (MT: each B fragment read from shared memory then feeds
// MT x 2 products; on the H100 ldmatrix's shared-memory traffic, not
// mma.sync, paces these kernels at MT = 1) and the depth of the tile it
// walks.  Chosen on the card among 14 variants a case at the 4k cells'
// shapes, within the 255 registers a thread can have without spills.
constexpr bool kNarrow = kD <= 64 && kDV <= 64;  // stablelm, granite
constexpr bool kLatent = kD > 128;               // Kimi K2's 192 / 128
constexpr int kFwdWarps = kNarrow || kLatent ? 4 : 8;
constexpr int kFwdMT = kNarrow || kLatent ? 2 : 1;
constexpr int kFwdBN = kLatent ? 32 : 64;
constexpr int kKvWarps = 4;
constexpr int kKvMT = kNarrow ? 2 : 1;
constexpr int kKvBM = 32;
constexpr int kDqWarps = kNarrow ? 4 : 8;
constexpr int kDqMT = 1;
constexpr int kDqBN = 64;
constexpr int kF32Threads = 128;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // elements: batch, time, head of q, k, v
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Warp tiles.  A warp's accumulator c[N / 8][4] is 16 rows x N columns:
// lane l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) and + 1 of
// each 8-column group (mma's C layout).
// ---------------------------------------------------------------------------

// Rows [row0, row0 + ROWS) of a [T, COLS] view with row stride `stride`
// into shared memory (row pitch COLS + 8); rows at or past T are zeros.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long stride, int row0, int T) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < T;
    cp_async16(s + r * (COLS + 8) + c, g + (ok ? row : 0) * stride + c, ok);
  }
}

// c[MT x 16 x N] += A B^T over K: A's MT x 16 rows at `a` (pitch lda),
// B's N rows at `b` (pitch ldb), both row-major in shared memory.  Each
// B fragment read from shared memory feeds MT x 2 products.
template <int MT, int N, int K>
__device__ __forceinline__ void gemm_nt(float (&c)[MT][N / 8][4],
                                        const bf16* a, int lda, const bf16* b,
                                        int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm(af[i], a + (i * 16 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t bf[4];
      ldsm(bf, b + (n * 16 + (lane & 7) + (lane >> 4) * 8) * ldb + kk * 16 +
                   ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma(c[i][2 * n], af[i], bf[0], bf[1]);
        mma(c[i][2 * n + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// c[MT x 16 x N] += A B over K: A in registers (a[MT][K / 16][4], mma's
// A layout), B's K rows of N columns at `b` (pitch ldb), row-major in
// shared memory.
template <int MT, int N, int K>
__device__ __forceinline__ void gemm_nn(float (&c)[MT][N / 8][4],
                                        const uint32_t (&a)[MT][K / 16][4],
                                        const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      uint32_t bf[4];
      ldsm_t(bf, b + (kk * 16 + (lane & 15)) * ldb + n * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma(c[i][2 * n], a[i][kk], bf[0], bf[1]);
        mma(c[i][2 * n + 1], a[i][kk], bf[2], bf[3]);
      }
    }
  }
}

// Accumulators of MT x 16 x N as the bf16 A operand of a product over N.
template <int MT, int N>
__device__ __forceinline__ void to_operand(uint32_t (&a)[MT][N / 16][4],
                                           const float (&c)[MT][N / 8][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      a[i][kk][0] = pack_bf16(c[i][2 * kk][0], c[i][2 * kk][1]);
      a[i][kk][1] = pack_bf16(c[i][2 * kk][2], c[i][2 * kk][3]);
      a[i][kk][2] = pack_bf16(c[i][2 * kk + 1][0], c[i][2 * kk + 1][1]);
      a[i][kk][3] = pack_bf16(c[i][2 * kk + 1][2], c[i][2 * kk + 1][3]);
    }
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&c)[MT][N][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) c[i][n][0] = c[i][n][1] = c[i][n][2] = c[i][n][3] = 0.f;
}

// Stores a warp's MT x 16 x N accumulators, row r times mul[r / 8] (r
// counted from row0), as bf16 rows row0.. of a [.., N] view with row
// pitch `pitch`, rows below T only.
template <int MT, int N>
__device__ __forceinline__ void store_rows(bf16* g, long long pitch,
                                           const float (&c)[MT][N / 8][4],
                                           int row0, int T,
                                           const float (&mul)[MT][2]) {
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r0 = row0 + i * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(g + r0 * pitch + n * 8 + col) =
            pack_bf16(c[i][n][0] * mul[i][0], c[i][n][1] * mul[i][0]);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(g + r1 * pitch + n * 8 + col) =
            pack_bf16(c[i][n][2] * mul[i][1], c[i][n][3] * mul[i][1]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 kernels.  NW warps of MT x 16 rows each; the row a lane holds in
// element e of m-tile i: warp's first row + 16 i + lane / 4 + 8 (e / 2).
// ---------------------------------------------------------------------------

constexpr int kLdQ = kD + 8;   // shared-memory pitch of q / k rows
constexpr int kLdV = kDV + 8;  // of v / o / do rows

template <int NW, int MT, int BN>
__global__ void __launch_bounds__(NW * 32)
    attention_fwd(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                  const bf16* __restrict__ V, bf16* __restrict__ O,
                  float* __restrict__ LSE, Strides st, int T, int H,
                  int n_rep, float qk_scale) {
  constexpr int BM = 16 * MT * NW, THREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // BM x kLdQ
  bf16* sk = sq + BM * kLdQ;                 // 2 x BN x kLdQ
  bf16* sv = sk + 2 * BN * kLdQ;             // 2 x BN x kLdV

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / n_rep;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* q = Q + b * st.qb + h * st.qh;
  const bf16* k = K + b * st.kb + hk * st.kh;
  const bf16* v = V + b * st.vb + hk * st.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = m0 + warp * 16 * MT;  // the warp's first row

  load_rows<BM, kD, THREADS>(sq, q, st.qt, m0, T);
  load_rows<BN, kD, THREADS>(sk, k, st.kt, 0, T);
  load_rows<BN, kDV, THREADS>(sv, v, st.vt, 0, T);
  cp_commit();

  float o[MT][kDV / 8][4];
  zero(o);
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    m_run[i][0] = m_run[i][1] = -INFINITY, l_run[i][0] = l_run[i][1] = 0.f;
  const int n_tiles = (min(m0 + BM, T) + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int st1 = (j + 1) & 1;
      load_rows<BN, kD, THREADS>(sk + st1 * BN * kLdQ, k, st.kt, (j + 1) * BN, T);
      load_rows<BN, kDV, THREADS>(sv + st1 * BN * kLdV, v, st.vt, (j + 1) * BN, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sk + (j & 1) * BN * kLdQ;
    const bf16* vt = sv + (j & 1) * BN * kLdV;

    float s[MT][BN / 8][4];
    zero(s);
    gemm_nt<MT, BN, kD>(s, sq + warp * 16 * MT * kLdQ, kLdQ, kt, kLdQ);

    const int n0 = j * BN;
    const bool diag = n0 + BN - 1 > w0;
    float alpha[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = w0 + i * 16 + (lane >> 2);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + n * 8 + 2 * (lane & 3) + (e & 1);
          float x = s[i][n][e] * qk_scale;
          if (diag && col > r0 + 8 * (e >> 1)) x = -INFINITY;
          s[i][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[i][r], quad_max(mx[r]));
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[i][r] = exp2f(m_run[i][r] - m_use[r]);
        m_run[i][r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[i][n][e] - m_use[e >> 1]);
          s[i][n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[i][r] = l_run[i][r] * alpha[i][r] + sum[r];
#pragma unroll
      for (int n = 0; n < kDV / 8; ++n) {
        o[i][n][0] *= alpha[i][0];
        o[i][n][1] *= alpha[i][0];
        o[i][n][2] *= alpha[i][1];
        o[i][n][3] *= alpha[i][1];
      }
    }
    uint32_t p[MT][BN / 16][4];
    to_operand<MT, BN>(p, s);
    gemm_nn<MT, kDV, BN>(o, p, vt, kLdV);
    __syncthreads();
  }

  float inv[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[i][r]);
      inv[i][r] = 1.f / l;
      const int row = w0 + i * 16 + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < T)
        LSE[(static_cast<long long>(b) * H + h) * T + row] =
            (m_run[i][r] + log2f(l)) * kLn2;
    }
  store_rows<MT, kDV>(O + (static_cast<long long>(b) * T * H + h) * kDV,
                      static_cast<long long>(H) * kDV, o, w0, T, inv);
}

// delta[b, h, t] = sum over DV of do * o (float32), DV / VEC lanes a row
template <typename T, int VEC>
__global__ void attention_bwd_pre(const T* __restrict__ O,
                                  const T* __restrict__ DO,
                                  float* __restrict__ DELTA, int B, int Tn,
                                  int H) {
  constexpr int kLanes = kDV / VEC;  // 2 .. 32, a power of two
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = i / kLanes;  // (b * T + t) * H + h
  const int part = static_cast<int>(i % kLanes);
  float acc = 0.f;
  if (row < static_cast<long long>(B) * Tn * H) {
    const T* o = O + row * kDV + part * VEC;
    const T* d = DO + row * kDV + part * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc += static_cast<float>(o[e]) * static_cast<float>(d[e]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < static_cast<long long>(B) * Tn * H) {
    const long long h = row % H, bt = row / H;
    const long long t = bt % Tn, b = bt / Tn;
    DELTA[(b * H + h) * Tn + t] = acc;
  }
}

template <int NW, int MT, int BM>
__global__ void __launch_bounds__(NW * 32, 1)
    attention_bwd_dkdv(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                       const bf16* __restrict__ V, const bf16* __restrict__ DO,
                       const float* __restrict__ LSE,
                       const float* __restrict__ DELTA, bf16* __restrict__ DK,
                       bf16* __restrict__ DV, Strides st, int T, int H,
                       int n_rep, float qk_scale, float scale) {
  constexpr int BN = 16 * MT * NW, THREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // BN x kLdQ
  bf16* sv = sk + BN * kLdQ;                 // BN x kLdV
  bf16* sq = sv + BN * kLdV;                 // 2 x BM x kLdQ
  bf16* sdo = sq + 2 * BM * kLdQ;            // 2 x BM x kLdV
  float* slse = reinterpret_cast<float*>(sdo + 2 * BM * kLdV);  // 2 x BM
  float* sdelta = slse + 2 * BM;                                // 2 x BM

  const int hkv = H / n_rep;
  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int n0 = blockIdx.y * BN;
  const bf16* k = K + b * st.kb + hk * st.kh;
  const bf16* v = V + b * st.vb + hk * st.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = n0 + warp * 16 * MT;  // the warp's first key
  const long long do_pitch = static_cast<long long>(H) * kDV;

  const int i0 = n0 / BM, n_iq = (T + BM - 1) / BM - i0;
  const int steps = n_rep * n_iq;
  // step s: query head hk * n_rep + s / n_iq, query tile i0 + s % n_iq
  auto issue = [&](int s, int stage) {
    const int h = hk * n_rep + s / n_iq, m0 = (i0 + s % n_iq) * BM;
    load_rows<BM, kD, THREADS>(sq + stage * BM * kLdQ,
                               Q + b * st.qb + h * st.qh, st.qt, m0, T);
    load_rows<BM, kDV, THREADS>(sdo + stage * BM * kLdV,
                                DO + (static_cast<long long>(b) * T * H + h) * kDV,
                                do_pitch, m0, T);
    const long long base = (static_cast<long long>(b) * H + h) * T;
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const int row = m0 + r;
      slse[stage * BM + r] = row < T ? LSE[base + row] * kLog2e : INFINITY;
      sdelta[stage * BM + r] = row < T ? DELTA[base + row] : 0.f;
    }
  };

  load_rows<BN, kD, THREADS>(sk, k, st.kt, n0, T);
  load_rows<BN, kDV, THREADS>(sv, v, st.vt, n0, T);
  issue(0, 0);
  cp_commit();

  float dk[MT][kD / 8][4], dv[MT][kDV / 8][4];
  zero(dk);
  zero(dv);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1, (s + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int stage = s & 1, m0 = (i0 + s % n_iq) * BM;
    const bf16* qt = sq + stage * BM * kLdQ;
    const bf16* dot = sdo + stage * BM * kLdV;
    const float* lse = slse + stage * BM;
    const float* delta = sdelta + stage * BM;

    float pt[MT][BM / 8][4], dpt[MT][BM / 8][4];
    zero(pt);
    zero(dpt);
    gemm_nt<MT, BM, kD>(pt, sk + warp * 16 * MT * kLdQ, kLdQ, qt, kLdQ);
    gemm_nt<MT, BM, kDV>(dpt, sv + warp * 16 * MT * kLdV, kLdV, dot, kLdV);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int key0 = w0 + i * 16 + (lane >> 2);
#pragma unroll
      for (int n = 0; n < BM / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * (lane & 3) + (e & 1);
          const float p = m0 + c >= key0 + 8 * (e >> 1)
                              ? exp2f(pt[i][n][e] * qk_scale - lse[c])
                              : 0.f;
          pt[i][n][e] = p;
          dpt[i][n][e] = p * (dpt[i][n][e] - delta[c]);
        }
    }
    uint32_t pa[MT][BM / 16][4], dsa[MT][BM / 16][4];
    to_operand<MT, BM>(pa, pt);
    to_operand<MT, BM>(dsa, dpt);
    gemm_nn<MT, kDV, BM>(dv, pa, dot, kLdV);
    gemm_nn<MT, kD, BM>(dk, dsa, qt, kLdQ);
    __syncthreads();
  }
  float mul_k[MT][2], mul_v[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    mul_k[i][0] = mul_k[i][1] = scale, mul_v[i][0] = mul_v[i][1] = 1.f;
  const long long base = static_cast<long long>(b) * T * hkv + hk;
  store_rows<MT, kD>(DK + base * kD, static_cast<long long>(hkv) * kD, dk, w0,
                     T, mul_k);
  store_rows<MT, kDV>(DV + base * kDV, static_cast<long long>(hkv) * kDV, dv,
                      w0, T, mul_v);
}

template <int NW, int MT, int BN>
__global__ void __launch_bounds__(NW * 32)
    attention_bwd_dq(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                     const bf16* __restrict__ V, const bf16* __restrict__ DO,
                     const float* __restrict__ LSE,
                     const float* __restrict__ DELTA, bf16* __restrict__ DQ,
                     Strides st, int T, int H, int n_rep, float qk_scale,
                     float scale) {
  constexpr int BM = 16 * MT * NW, THREADS = NW * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // BM x kLdQ
  bf16* sdo = sq + BM * kLdQ;                // BM x kLdV
  bf16* sk = sdo + BM * kLdV;                // 2 x BN x kLdQ
  bf16* sv = sk + 2 * BN * kLdQ;             // 2 x BN x kLdV

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / n_rep;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const bf16* k = K + b * st.kb + hk * st.kh;
  const bf16* v = V + b * st.vb + hk * st.vh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = m0 + warp * 16 * MT;  // the warp's first row

  load_rows<BM, kD, THREADS>(sq, Q + b * st.qb + h * st.qh, st.qt, m0, T);
  load_rows<BM, kDV, THREADS>(
      sdo, DO + (static_cast<long long>(b) * T * H + h) * kDV,
      static_cast<long long>(H) * kDV, m0, T);
  load_rows<BN, kD, THREADS>(sk, k, st.kt, 0, T);
  load_rows<BN, kDV, THREADS>(sv, v, st.vt, 0, T);
  cp_commit();

  const long long base = (static_cast<long long>(b) * H + h) * T;
  float lse[MT][2], delta[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + i * 16 + (lane >> 2) + 8 * r;
      lse[i][r] = row < T ? LSE[base + row] * kLog2e : INFINITY;
      delta[i][r] = row < T ? DELTA[base + row] : 0.f;
    }

  float dq[MT][kD / 8][4];
  zero(dq);
  const int n_tiles = (min(m0 + BM, T) + BN - 1) / BN;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int st1 = (j + 1) & 1;
      load_rows<BN, kD, THREADS>(sk + st1 * BN * kLdQ, k, st.kt, (j + 1) * BN, T);
      load_rows<BN, kDV, THREADS>(sv + st1 * BN * kLdV, v, st.vt, (j + 1) * BN, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sk + (j & 1) * BN * kLdQ;
    const bf16* vt = sv + (j & 1) * BN * kLdV;

    float s[MT][BN / 8][4], dp[MT][BN / 8][4];
    zero(s);
    zero(dp);
    gemm_nt<MT, BN, kD>(s, sq + warp * 16 * MT * kLdQ, kLdQ, kt, kLdQ);
    gemm_nt<MT, BN, kDV>(dp, sdo + warp * 16 * MT * kLdV, kLdV, vt, kLdV);
    const int n0 = j * BN;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r0 = w0 + i * 16 + (lane >> 2);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int r = e >> 1;
          const float p = col <= r0 + 8 * r
                              ? exp2f(s[i][n][e] * qk_scale - lse[i][r])
                              : 0.f;
          s[i][n][e] = p * (dp[i][n][e] - delta[i][r]);
        }
    }
    uint32_t dsa[MT][BN / 16][4];
    to_operand<MT, BN>(dsa, s);
    gemm_nn<MT, kD, BN>(dq, dsa, kt, kLdQ);
    __syncthreads();
  }
  float mul[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) mul[i][0] = mul[i][1] = scale;
  store_rows<MT, kD>(DQ + (static_cast<long long>(b) * T * H + h) * kD,
                     static_cast<long long>(H) * kD, dq, w0, T, mul);
}

// ---------------------------------------------------------------------------
// float32 kernels: a thread a row, natural-log units
// ---------------------------------------------------------------------------

#if FLASH_F32

__global__ void attention_fwd_f32(const float* __restrict__ Q,
                                  const float* __restrict__ K,
                                  const float* __restrict__ V,
                                  float* __restrict__ O,
                                  float* __restrict__ LSE, Strides st, int T,
                                  int H, int n_rep, float scale) {
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / n_rep;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  const float* q = Q + b * st.qb + h * st.qh + row * st.qt;
  const float* k = K + b * st.kb + hk * st.kh;
  const float* v = V + b * st.vb + hk * st.vh;
  float acc[kDV];
  for (int e = 0; e < kDV; ++e) acc[e] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int c = 0; c <= row; ++c) {
    float s = 0.f;
    for (int e = 0; e < kD; ++e) s += q[e] * k[c * st.kt + e];
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new), p = expf(s - m_new);
    l = l * alpha + p;
    for (int e = 0; e < kDV; ++e) acc[e] = acc[e] * alpha + p * v[c * st.vt + e];
    m = m_new;
  }
  float* o = O + ((static_cast<long long>(b) * T + row) * H + h) * kDV;
  for (int e = 0; e < kDV; ++e) o[e] = acc[e] / l;
  LSE[(static_cast<long long>(b) * H + h) * T + row] = m + logf(l);
}

__global__ void attention_bwd_dkdv_f32(
    const float* __restrict__ Q, const float* __restrict__ K,
    const float* __restrict__ V, const float* __restrict__ DO,
    const float* __restrict__ LSE, const float* __restrict__ DELTA,
    float* __restrict__ DK, float* __restrict__ DV, Strides st, int T, int H,
    int n_rep, float scale) {
  const int hkv = H / n_rep;
  const int b = blockIdx.y / hkv, hk = blockIdx.y % hkv;
  const int key = blockIdx.x * blockDim.x + threadIdx.x;
  if (key >= T) return;
  const float* k = K + b * st.kb + hk * st.kh + key * st.kt;
  const float* v = V + b * st.vb + hk * st.vh + key * st.vt;
  float dk[kD], dv[kDV];
  for (int e = 0; e < kD; ++e) dk[e] = 0.f;
  for (int e = 0; e < kDV; ++e) dv[e] = 0.f;
  for (int h = hk * n_rep; h < (hk + 1) * n_rep; ++h) {
    const long long base = (static_cast<long long>(b) * H + h) * T;
    for (int r = key; r < T; ++r) {
      const float* q = Q + b * st.qb + h * st.qh + r * st.qt;
      const float* d = DO + ((static_cast<long long>(b) * T + r) * H + h) * kDV;
      float s = 0.f, dp = 0.f;
      for (int e = 0; e < kD; ++e) s += q[e] * k[e];
      for (int e = 0; e < kDV; ++e) dp += d[e] * v[e];
      const float p = expf(s * scale - LSE[base + r]);
      const float ds = p * (dp - DELTA[base + r]);
      for (int e = 0; e < kDV; ++e) dv[e] += p * d[e];
      for (int e = 0; e < kD; ++e) dk[e] += ds * q[e];
    }
  }
  const long long out = (static_cast<long long>(b) * T + key) * hkv + hk;
  for (int e = 0; e < kD; ++e) DK[out * kD + e] = dk[e] * scale;
  for (int e = 0; e < kDV; ++e) DV[out * kDV + e] = dv[e];
}

__global__ void attention_bwd_dq_f32(
    const float* __restrict__ Q, const float* __restrict__ K,
    const float* __restrict__ V, const float* __restrict__ DO,
    const float* __restrict__ LSE, const float* __restrict__ DELTA,
    float* __restrict__ DQ, Strides st, int T, int H, int n_rep,
    float scale) {
  const int b = blockIdx.y / H, h = blockIdx.y % H, hk = h / n_rep;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= T) return;
  const float* q = Q + b * st.qb + h * st.qh + row * st.qt;
  const float* d = DO + ((static_cast<long long>(b) * T + row) * H + h) * kDV;
  const float* k = K + b * st.kb + hk * st.kh;
  const float* v = V + b * st.vb + hk * st.vh;
  const long long base = (static_cast<long long>(b) * H + h) * T;
  const float lse = LSE[base + row], delta = DELTA[base + row];
  float dq[kD];
  for (int e = 0; e < kD; ++e) dq[e] = 0.f;
  for (int c = 0; c <= row; ++c) {
    float s = 0.f, dp = 0.f;
    for (int e = 0; e < kD; ++e) s += q[e] * k[c * st.kt + e];
    for (int e = 0; e < kDV; ++e) dp += d[e] * v[c * st.vt + e];
    const float ds = expf(s * scale - lse) * (dp - delta);
    for (int e = 0; e < kD; ++e) dq[e] += ds * k[c * st.kt + e];
  }
  float* out = DQ + ((static_cast<long long>(b) * T + row) * H + h) * kD;
  for (int e = 0; e < kD; ++e) out[e] = dq[e] * scale;
}

#endif  // FLASH_F32

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]};
}

template <typename Kern>
int launch_smem(Kern kern, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

constexpr int kFwdRows = 16 * kFwdMT * kFwdWarps;
constexpr int kKvKeys = 16 * kKvMT * kKvWarps;
constexpr int kDqRows = 16 * kDqMT * kDqWarps;
constexpr int kFwdSmem = 2 * (kFwdRows * kLdQ + 2 * kFwdBN * (kLdQ + kLdV));
constexpr int kKvSmem = 2 * (kKvKeys * (kLdQ + kLdV) +
                             2 * kKvBM * (kLdQ + kLdV)) +
                        4 * 4 * kKvBM;
constexpr int kDqSmem = 2 * (kDqRows * (kLdQ + kLdV) +
                             2 * kDqBN * (kLdQ + kLdV));

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the case this library was built for: {D, DV, forward rows, dK / dV
// keys, dQ rows} (a block each), then each bf16 kernel's dynamic shared
// memory in bytes (forward, dK / dV, dQ)
void flash_case(int* out) {
  out[0] = kD;
  out[1] = kDV;
  out[2] = kFwdRows;
  out[3] = kKvKeys;
  out[4] = kDqRows;
  out[5] = kFwdSmem;
  out[6] = kKvSmem;
  out[7] = kDqSmem;
}

// O and the log-sum-exp of q, k, v (strides: q, k, v's batch, time and
// head strides in elements), in this library's dtype.  One launch.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, const long long* strides, int B, int T, int H,
              int n_rep, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
#if FLASH_F32
  attention_fwd_f32<<<dim3(cdiv(T, kF32Threads), B * H), kF32Threads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), st, T, H, n_rep, scale);
#else
  auto kern = attention_fwd<kFwdWarps, kFwdMT, kFwdBN>;
  if (int err = launch_smem(kern, kFwdSmem)) return err;
  kern<<<dim3(B * H, cdiv(T, kFwdRows)), 32 * kFwdWarps, kFwdSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), st, T, H, n_rep, scale * kLog2e);
#endif
  return static_cast<int>(cudaGetLastError());
}

// delta = rowsum(do * o), then dK / dV, then dQ, from O, the
// log-sum-exp and do (o, do contiguous).  Three launches; the error of
// the first that fails.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              void* dk, void* dv, const long long* strides, int B, int T,
              int H, int n_rep, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = strides_of(strides);
  const long long rows = static_cast<long long>(B) * T * H;
  const int hkv = H / n_rep;
#if FLASH_F32
  constexpr int kLanes = kDV / 4;
  attention_bwd_pre<float, 4><<<cdiv(rows * kLanes, 256), 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), B, T, H);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  attention_bwd_dkdv_f32<<<dim3(cdiv(T, kF32Threads), B * hkv), kF32Threads,
                           0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), st, T, H, n_rep,
      scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  attention_bwd_dq_f32<<<dim3(cdiv(T, kF32Threads), B * H), kF32Threads, 0,
                         s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), st, T, H, n_rep, scale);
#else
  constexpr int kLanes = kDV / 8;
  attention_bwd_pre<bf16, 8><<<cdiv(rows * kLanes, 256), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), B, T, H);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  auto kv = attention_bwd_dkdv<kKvWarps, kKvMT, kKvBM>;
  if (int err = launch_smem(kv, kKvSmem)) return err;
  kv<<<dim3(B * hkv, cdiv(T, kKvKeys)), 32 * kKvWarps, kKvSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, T, H, n_rep,
      scale * kLog2e, scale);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  auto kq = attention_bwd_dq<kDqWarps, kDqMT, kDqBN>;
  if (int err = launch_smem(kq, kDqSmem)) return err;
  kq<<<dim3(B * H, cdiv(T, kDqRows)), 32 * kDqWarps, kDqSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), st, T, H, n_rep, scale * kLog2e, scale);
#endif
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
