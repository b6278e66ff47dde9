// flash_attention's backward, for sm_90a: dq, dk and dv of the function the
// forward kernels compute,
//   o[bh, i] = sum_j p_ij v[kv, j],  p_ij = exp(s_ij - m_i) / l_i,
//   s_ij = scale * q[bh, i] . k[kv, j],  kv = bh / q_per_kv,
// over the keys j the causal / window mask lets through (a row with no valid
// key gives 0 and takes no gradient).  With dP = dO.V^T and
// D_i = sum_j p_ij dP_ij = dO_i . o_i:
//   dS = P * (dP - D),  dq = scale dS.K,  dk = scale dS^T.Q,  dv = P^T.dO,
// dk and dv summed over the q_per_kv query heads of each KV head.
//
// What it replaces.  The Pallas TPU kernel (src/repro/kernels/flash_attention/
// kernel.py) has no backward: the reference trains through the pure-JAX
// flash_train (src/repro/models/attention.py:33), whose gradient is XLA's
// autodiff.  The port's plain version of that gradient is attention_bwd_ref
// (ref.py), which FlashAttentionFn runs on a CPU tensor; on the card it runs
// these kernels.
//
// Bound: operations.  At qwen2-0.5b's training shape (B 4, H 14, KVH 2,
// S 2,048, d 64, bf16, causal) the forward's causal products are 2 B H S^2 d
// / 2 = 30.06 GFLOP; the backward's five (S = Q.K^T again, dP, dv, dq, dk)
// are 2.5 times that, 75.2 GFLOP, 0.076 ms at the dense bf16 rate (989
// TFLOP/s), against 29 MB of q, k, v, dO, dq, dk and dv (0.009 ms at 3.35
// TB/s), and 29 MB more of the forward's float32 o and its log-sum-exp.
//
// What the forward saves (FlashAttentionFn): q, k, v, each row's log-sum-exp
// in log2 units (lse = m log2 e + log2 l, +inf for a row with no valid key)
// and the float32 output o (the bf16 route's forward writes it beside its
// bf16 output).  So P = exp2(scale log2 e S - lse) needs no sweep of its own,
// and D0 = rowsum(dO o) is a prologue of the dq kernel.  D from the bf16
// output would make a fifth to a half of the bf16 gradient's elements
// differ from the float32 gradient rounded once.  The bf16 forward's float32
// o is no exact sum either: its P.V multiplies P split in two bf16 (16
// bits), so D0 is off by about 2^-17 of |D|, which a peaked softmax turns
// into 1-2.4 % of dq and dk differing (the check allows 1 %).  So the bf16
// dq kernels correct it from their own sweep: res = sum_j dS_ij = D - D0 to
// float32 rounding (sum_j P_ij = 1), dq = dS.K - res (P.K), P.K taken from
// P_hi (its 9 bits suffice for a term that small), and D = D0 + res goes to
// the dk / dv kernel; one more product (P_hi.K) than the function's.  The
// TF32 route's o is float32-exact enough (3xTF32, fresh accumulators), and
// its D0 needs no correction (tests/test_torch_flash_bwd.py's twin holds
// each of these).
//
// Two routes, fixed by dtype as the forward's (kernel.py's route):
//   * bfloat16 on the tensor cores: wgmma fed by TMA at every d but 256
//     (flash_attention_bwd_wgmma.cuh); at d 256 through warp-level mma.sync
//     m16n8k16 below, since a warpgroup's dk and dv of 64 keys would take 256
//     registers a thread.  Q.K^T and dO.V^T are exact bf16 products.  P and
//     dS are float32 and are split, as the forward splits P for P.V
//     (flash_attention_wgmma.cuh): x_hi = bf16(x), x_lo = bf16(x - x_hi), and
//     each of P^T.dO, dS.K and dS^T.Q is two products into one accumulator.
//     Rounding P or dS to bf16 once would make a quarter of the bf16 outputs
//     differ from the float32 gradient rounded once (the forward's emulation,
//     23-24 % against the check's 1 %; tests/test_torch_flash_bwd.py emulates
//     the backward's split);
//   * float32 on the TF32 tensor cores through mma.sync m16n8k8 with every
//     operand split three ways (3xTF32, flash_attention_tf32x3.cuh's helpers),
//     so that the gradient keeps float32 accuracy (2e-5 of its largest
//     magnitude).
//
// The schedule, two kernels a call, deterministic (no atomics on dq, dk or
// dv, so a backward repeats bit for bit):
//   (a) dq: a block per (query head, query rows).  Its prologue computes D0
//       of its rows and writes their lse (float32, +inf past sq) to the
//       stats scratch for (b).  One sweep over the KV tiles the mask lets
//       through: S, dP, P = exp2(c S - lse), dS = P (dP - D0), dq += dS.K
//       (and on the bf16 route the residual above); D to the stats;
//   (b) dk, dv: a block per (query head, key tile; two heads on the wgmma
//       kernels): over the query tiles the mask lets through, S^T = K.Q^T,
//       dP^T = V.dO^T, P^T and dS^T from the stats, then dv += P^T.dO and
//       dk += dS^T.Q.  The blocks' float32 parts are summed in head order by
//       the last block of a key tile to finish (an integer ticket, so the
//       sum's bits do not depend on which block that is) and rounded once.
//
// The mma adds into its accumulator rounding toward zero, so a long sum in
// one accumulator drifts toward zero (the forward's TF32 route measured it,
// flash_attention_tf32x3.cuh).  So no product accumulates across tiles: each
// tile's dq, dk or dv goes into a fresh accumulator, 64 output columns at a
// time, and is added to the running sum by rounded float32 adds.  Here the
// running sums live in shared memory in the accumulator's own layout (a
// float4 a lane and 8-column block), which no other lane touches: at d 256 a
// warp's 16 rows of dk and dv in registers would take 256 a thread.
//
// Masks: a tile whose every (query, key) pair is valid skips the mask; a
// masked pair has P = 0 explicitly (a row with no valid key has lse = +inf,
// which makes P 0 as well, and D = 0), so such a row's dq is 0 and it adds
// nothing to dk or dv.  Rows past sq and keys past sk are zero-filled by the
// copies and masked.  Only the (query tile, KV tile) pairs with some valid
// pair are visited.
//
// Shared rows: bf16 rows of d + 8 elements (an odd number of 16-byte units,
// so ldmatrix's 8 rows fall on distinct banks at every d); float32 rows of
// d + 4.  Copies are 16-byte cp.async into a ring of 2 stages (1 where the
// tiles and the running sums fill the block's 227 KB: d 256).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "flash_attention_tf32x3.cuh"

namespace fa_bwd {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // query rows of a dq block; keys of a dk/dv block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------ copies
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in_range) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in_range ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of an (n, D) row-major matrix into shared rows of STR
// elements, 16 bytes a copy; rows at or past n are zero-filled
template <typename T, int D, int ROWS, int STR, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0, int n, int tid) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = D / kPer;
#pragma unroll
  for (int e = tid; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = (e % kChunks) * kPer;
    const bool ok = r0 + r < n;
    cp16(dst + r * STR + c, ok ? src + (long long)(r0 + r) * D + c : src, ok);
  }
}

// N float32 values from src (16-byte aligned, in range) into dst
template <int N, int THREADS>
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int tid) {
#pragma unroll
  for (int e = tid; e < N / 4; e += THREADS) cp16(dst + 4 * e, src + 4 * e, true);
}

// ------------------------------------------------------ running sums
// A warp's running sum of 16 rows x 8 N columns in shared memory, in the
// accumulator's layout: n-tile n, lane l at float4 (n * 32 + l).
template <int N>
__device__ __forceinline__ void add_sum(float* warp_sum, int c0, const float (&part)[N][4],
                                        int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float4* p = reinterpret_cast<float4*>(warp_sum) + (c0 + n) * 32 + lane;
    float4 x = *p;
    x.x += part[n][0];
    x.y += part[n][1];
    x.z += part[n][2];
    x.w += part[n][3];
    *p = x;
  }
}

template <int NO>
__device__ __forceinline__ void zero_sum(float* warp_sum, int lane) {
#pragma unroll
  for (int n = 0; n < NO; ++n)
    reinterpret_cast<float4*>(warp_sum)[n * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows row0 + g and row0 + g + 8 (below n) of a warp's running sum, times
// mul, into out (rows of D elements)
template <typename T, int D>
__device__ __forceinline__ void write_sum(T* out, const float* warp_sum, int row0, int n,
                                          float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float4 x = reinterpret_cast<const float4*>(warp_sum)[c * 32 + lane];
    if (row0 + g < n) put2(out + (long long)(row0 + g) * D + 8 * c + 2 * tq, x.x * mul, x.y * mul);
    if (row0 + g + 8 < n)
      put2(out + (long long)(row0 + g + 8) * D + 8 * c + 2 * tq, x.z * mul, x.w * mul);
  }
}

// 8 consecutive elements (16-byte aligned) as float32
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    memcpy(&h, &w[i], sizeof h);
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// The prologue of a dq kernel: for its ROWS query rows from q0 of head bh,
// D = rowsum(dO o) in float32 (0 past sq) and the forward's lse (+inf past
// sq), into row_l / row_d (shared) and into the stats the dk / dv kernel
// reads (plane 0 the lse, plane 1 D, when WRITE_D: the bf16 kernels write
// their corrected D at their end; n_bh rows of sq_pad each).  Two threads a
// row: the threads below 2 ROWS, whole warps; the others return at once.
// 16-byte loads, four chunks' issued before their products (all of them up
// to d 64).
template <typename E, int D, int ROWS, bool WRITE_D>
__device__ __forceinline__ void row_stats(const E* dout, const float* o32, const float* lse,
                                          float* stats, float* row_l, float* row_d, int bh,
                                          int q0, int sq, int n_bh, int sq_pad, int tid) {
  static_assert(D % 16 == 0, "whole 8-element chunks a half row");
  constexpr int kChunks = D / 16;                  // of 8 elements, a half row
  if (tid >= 2 * ROWS) return;
  const int r = tid >> 1, half = tid & 1, qi = q0 + r;
  float acc = 0.f;
  if (qi < sq) {
    const long long at = ((long long)bh * sq + qi) * D + half * (D / 2);
#pragma unroll 4
    for (int c = 0; c < kChunks; ++c) {
      float o[8], g[8];
      load8(o32 + at + 8 * c, o);
      load8(dout + at + 8 * c, g);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(o[e], g[e], acc);
    }
  }
  acc += __shfl_xor_sync(kFull, acc, 1);
  if (half == 0) {
    const float l = qi < sq ? lse[(long long)bh * sq + qi] : INFINITY;
    row_l[r] = l;
    row_d[r] = acc;
    const long long at = (long long)bh * sq_pad + q0 + r;
    stats[at] = l;
    if (WRITE_D) stats[(long long)n_bh * sq_pad + at] = acc;
  }
}

// A dq block's KV tile at k0 (K, then V: rows of STR) into a stage of its ring
template <typename E, int D, int BK, int STR, int THREADS>
__device__ __forceinline__ void stage_kv(E* st, const E* kb, const E* vb, int k0, int sk,
                                         int tid) {
  stage_rows<E, D, BK, STR, THREADS>(st, kb, k0, sk, tid);
  stage_rows<E, D, BK, STR, THREADS>(st + BK * STR, vb, k0, sk, tid);
}

// A dk / dv block's query step: BQ rows at qs of head bh's Q and dO (rows
// of STR), then their lse and D, into a stage of its ring
template <typename E, int D, int BQ, int STR, int THREADS>
__device__ __forceinline__ void stage_q(E* st, const E* q, const E* dout, const float* stats,
                                        int bh, int qs, int sq, int n_bh, int sq_pad, int tid) {
  stage_rows<E, D, BQ, STR, THREADS>(st, q + (long long)bh * sq * D, qs, sq, tid);
  stage_rows<E, D, BQ, STR, THREADS>(st + BQ * STR, dout + (long long)bh * sq * D, qs, sq, tid);
  float* f = reinterpret_cast<float*>(st + 2 * BQ * STR);
#pragma unroll
  for (int a = 0; a < 2; ++a)
    stage_floats<BQ, THREADS>(f + a * BQ, stats + ((long long)a * n_bh + bh) * sq_pad + qs, tid);
}

// whether query i sees key j under the mask (attention_ref's)
__device__ __forceinline__ bool valid(int i, int j, int sq, int sk, int causal, int window) {
  return i < sq && j < sk && (!causal || j <= i) && (window < 0 || j >= i - window);
}

// whether every (query, key) pair of the rows [i0, i0 + ni) and keys
// [j0, j0 + nj) is valid
__device__ __forceinline__ bool whole(int i0, int ni, int j0, int nj, int sq, int sk,
                                      int causal, int window) {
  return i0 + ni <= sq && j0 + nj <= sk && (!causal || j0 + nj - 1 <= i0) &&
         (window < 0 || j0 >= i0 + ni - 1 - window);
}

// The KV tiles of BK keys that some row of [q0, q0 + ROWS) sees: [*t0, *t1).
template <int BK, int ROWS = kRows>
__device__ __forceinline__ void kv_tiles(int q0, int sq, int sk, int causal, int window, int* t0,
                                         int* t1) {
  const int q_last = min(q0 + ROWS, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window >= 0 ? max(0, q0 - window) : 0;
  *t0 = k_begin / BK;
  *t1 = k_end > k_begin ? (k_end + BK - 1) / BK : *t0;
}

// The query tiles of BQ rows that some key of [k0, k0 + 64) is seen by.
template <int BQ>
__device__ __forceinline__ void q_tiles(int k0, int nk, int sq, int causal, int window, int* t0,
                                        int* t1) {
  const int i_begin = causal ? min(k0, sq) : 0;
  const long long last = (long long)k0 + nk - 1 + window;   // the last query a window lets see k
  const int i_end = window >= 0 ? (int)min((long long)sq, last + 1) : sq;
  *t0 = i_begin / BQ;
  *t1 = i_end > i_begin ? (i_end + BQ - 1) / BQ : *t0;
}

// A dk / dv block holds one query head's part of its keys' dk and dv (the
// running sums, N float4s).  With q_per_kv > 1 the part goes to slot gq of
// the key block's parts in device memory, and the last of the block's
// q_per_kv heads to arrive (an integer ticket) sums the slots in head order
// into its running sums and returns true; the others return false.  The sum
// is the same whichever block arrives last, so a backward repeats bit for bit.
template <int N, int THREADS>
__device__ __forceinline__ bool combine(float* sums, float* parts, int* ticket, int gq,
                                        int n_parts, int tid) {
  __shared__ int last;
  float4* s4 = reinterpret_cast<float4*>(sums);
  float4* p4 = reinterpret_cast<float4*>(parts);
  __syncthreads();                     // every warp's running sums are final
#pragma unroll 4
  for (int e = tid; e < N; e += THREADS) p4[(long long)gq * N + e] = s4[e];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == n_parts - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll 4
  for (int e = tid; e < N; e += THREADS) {
    float4 x = __ldcg(p4 + e);
    for (int h = 1; h < n_parts; ++h) {
      const float4 y = __ldcg(p4 + (long long)h * N + e);
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    s4[e] = x;
  }
  __syncthreads();
  return true;
}

// =================================================== bfloat16, mma.sync
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof u);
  return u;
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a.b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] += A . B^T over K: A the 16 rows at a (row-major, stride SA), B^T
// the 8 NT rows at b (row-major [n][k], stride SB), both in shared memory.
// A by ldmatrix (matrices: rows 0-7 / 8-15 x columns 0-7 / 8-15); B two
// n-tiles an ldmatrix (n 0-7 / 8-15 x k 0-7 / 8-15).
template <int NT, int K, int SA, int SB>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                        int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "whole ldmatrix tiles");
  const bf16* pa = a + (lane & 15) * SA + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * SB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    ldsm(af, pa + kk);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm(bf, pb + n * 8 * SB + kk);
      mma(acc[n], af, bf[0], bf[1]);
      mma(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] += (hi + lo) . B over 16 KS rows of B: hi, lo the A fragments of
// KS k-steps, B the columns [c0, c0 + 8 N) of a row-major [k][n] shared
// tile of stride SB (ldmatrix .trans: k 0-7 / 8-15 x n 0-7 / 8-15).
template <int N, int KS, int SB>
__device__ __forceinline__ void mma_split_b(float (&acc)[N][4], const uint32_t (&hi)[KS][4],
                                            const uint32_t (&lo)[KS][4], const bf16* b, int c0,
                                            int lane) {
  static_assert(N % 2 == 0, "two n-tiles an ldmatrix");
  const bf16* pb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * SB + c0 + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t bf[4];
      ldsm_t(bf, pb + ks * 16 * SB + n * 8);
      mma(acc[n], lo[ks], bf[0], bf[1]);
      mma(acc[n], hi[ks], bf[0], bf[1]);
      mma(acc[n + 1], lo[ks], bf[2], bf[3]);
      mma(acc[n + 1], hi[ks], bf[2], bf[3]);
    }
  }
}

// acc[n] += hi . B, as mma_split_b without the lo fragments
template <int N, int KS, int SB>
__device__ __forceinline__ void mma_hi_b(float (&acc)[N][4], const uint32_t (&hi)[KS][4],
                                         const bf16* b, int c0, int lane) {
  static_assert(N % 2 == 0, "two n-tiles an ldmatrix");
  const bf16* pb = b + ((lane & 7) + ((lane >> 3) & 1) * 8) * SB + c0 + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t bf[4];
      ldsm_t(bf, pb + ks * 16 * SB + n * 8);
      mma(acc[n], hi[ks], bf[0], bf[1]);
      mma(acc[n + 1], hi[ks], bf[2], bf[3]);
    }
  }
}

// x, y -> bf16 pairs hi = bf16(x, y), lo = bf16(x - hi, y - hi): the pair
// carries 16 significant bits (the difference is exact in float32)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The accumulator of 16 rows x 16 KS columns as the A fragments of KS
// k-steps (its layout is theirs: row g at columns 2t, 2t + 1 of each
// n-tile), split hi + lo.
template <int KS>
__device__ __forceinline__ void to_a(const float (&s)[2 * KS][4], uint32_t (&hi)[KS][4],
                                     uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    split2(s[2 * ks][0], s[2 * ks][1], hi[ks][0], lo[ks][0]);
    split2(s[2 * ks][2], s[2 * ks][3], hi[ks][1], lo[ks][1]);
    split2(s[2 * ks + 1][0], s[2 * ks + 1][1], hi[ks][2], lo[ks][2]);
    split2(s[2 * ks + 1][2], s[2 * ks + 1][3], hi[ks][3], lo[ks][3]);
  }
}

// output column blocks of one fresh accumulator: 8 (64 columns)
constexpr int kNC = 8;

// Each kernel's __launch_bounds__ minimum of blocks an SM: the blocks of
// `smem` bytes an SM's 228 KB hold (1 KB of it reserved a block), at most 3,
// so that ptxas budgets registers for an occupancy the shared memory allows
// (without a minimum it aimed at more blocks than fit and spilled at 72-96
// registers) and keeps 170 a thread where more would fit (6-8 blocks at d 16
// and 32 left 56-96 registers and spilled too)
constexpr int blocks_per_sm(size_t smem) {
  const int n = 233472 / (int)(smem + 1024);
  return n < 1 ? 1 : n > 3 ? 3 : n;
}

// the bf16 mma.sync kernels' tiles, at d 256 (every other d runs on
// flash_attention_bwd_wgmma.cuh).  The dq kernel's running sums of dS.K and
// P_hi.K take 128 KB, so its KV tiles of 16 keys go through one stage; the
// dk / dv kernel takes 16 query rows a step, one stage
template <int D>
struct Bf16Dq {
  static_assert(D == 256, "the bf16 mma.sync kernels serve d 256 alone");
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int BK = 16, kStages = 1;            // keys a KV tile
  static constexpr int STR = D + 8;
  static constexpr int Q_ELEMS = kRows * STR;          // Q, then dO
  static constexpr int STAGE_ELEMS = 2 * BK * STR;     // K, then V
  static constexpr size_t kSmemBytes =
      sizeof(bf16) * (2 * (size_t)Q_ELEMS + kStages * (size_t)STAGE_ELEMS) +
      sizeof(float) * 2 * (size_t)kRows * D;
};

template <int D>
struct Bf16Dkv {
  static_assert(D == 256, "the bf16 mma.sync kernels serve d 256 alone");
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int BQ = 16, kStages = 1;           // query rows a step
  static constexpr int STR = D + 8;
  static constexpr int KV_ELEMS = kRows * STR;         // K, then V
  static constexpr int STAGE_BYTES = 2 * BQ * STR * (int)sizeof(bf16) + 2 * BQ * (int)sizeof(float);
  static constexpr size_t kSmemBytes = sizeof(bf16) * 2 * (size_t)KV_ELEMS +
                                       (size_t)kStages * STAGE_BYTES +
                                       sizeof(float) * 2 * (size_t)kRows * D;
};

template <int D>
__global__ void __launch_bounds__(Bf16Dq<D>::kThreads, blocks_per_sm(Bf16Dq<D>::kSmemBytes))
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ o32, const float* __restrict__ lse,
                 bf16* __restrict__ dq, float* __restrict__ stats, int n_bh, int sq, int sk,
                 int q_per_kv, int causal, int window, float scale, int n_qt, int sq_pad) {
  using T = Bf16Dq<D>;
  constexpr int BK = T::BK, STR = T::STR, NS = BK / 8, KS = BK / 16, NO = D / 8;
  constexpr int S = T::kStages;
  extern __shared__ float4 smem4[];
  __shared__ float row_l[kRows], row_d[kRows];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + T::Q_ELEMS;
  bf16* ring = dOs + T::Q_ELEMS;
  float* sums = reinterpret_cast<float*>(ring + S * T::STAGE_ELEMS);   // dS.K, then P_hi.K

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - blockIdx.x / n_bh) * kRows;     // heaviest causal tiles first
  const int kv = bh / q_per_kv;
  const bf16* qb = q + (long long)bh * sq * D;
  const bf16* dob = dout + (long long)bh * sq * D;
  const bf16* kb = k + (long long)kv * sk * D;
  const bf16* vb = v + (long long)kv * sk * D;
  const float c = scale * kLog2e;

  int t_begin, t_end;
  kv_tiles<BK>(q0, sq, sk, causal, window, &t_begin, &t_end);
  const int nt = t_end - t_begin;

  const int row0 = q0 + warp * 16;                  // this warp's rows
  float* wsum = sums + warp * 16 * D;
  float* wb = sums + kRows * D + warp * 16 * D;
  zero_sum<NO>(wsum, lane);
  zero_sum<NO>(wb, lane);

  if (nt > 0) {
    stage_rows<bf16, D, kRows, STR, T::kThreads>(Qs, qb, q0, sq, tid);
    stage_rows<bf16, D, kRows, STR, T::kThreads>(dOs, dob, q0, sq, tid);
    if (S > 1) stage_kv<bf16, D, BK, STR, T::kThreads>(ring, kb, vb, t_begin * BK, sk, tid);
    commit();
  }
  row_stats<bf16, D, kRows, false>(dout, o32, lse, stats, row_l, row_d, bh, q0, sq, n_bh, sq_pad,
                                   tid);
  __syncthreads();
  // rows g and g + 8 of the warp: their lse and D0 = dO.o, and this lane's
  // part of their residual sum_j dS_ij (flash_attention_bwd_wgmma.cuh's dq
  // kernel explains the correction)
  const float lse_r[2] = {row_l[warp * 16 + g], row_l[warp * 16 + g + 8]};
  const float d_r[2] = {row_d[warp * 16 + g], row_d[warp * 16 + g + 8]};
  float res[2] = {0.f, 0.f};

  for (int it = 0; it < nt; ++it) {
    const int k0 = (t_begin + it) * BK;
    const bf16* Ks = ring + (it % S) * T::STAGE_ELEMS;
    const bf16* Vs = Ks + BK * STR;
    if (it + S - 1 < nt)                       // that stage's readers passed the last barrier
      stage_kv<bf16, D, BK, STR, T::kThreads>(ring + ((it + S - 1) % S) * T::STAGE_ELEMS, kb,
                                              vb, (t_begin + it + S - 1) * BK, sk, tid);
    commit();
    wait_group<S - 1>();
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<NS, D, STR, STR>(s, Qs + warp * 16 * STR, Ks, lane);
    mma_abt<NS, D, STR, STR>(dp, dOs + warp * 16 * STR, Vs, lane);

    const bool all = whole(row0, 16, k0, BK, sq, sk, causal, window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = all || valid(qi, k0 + 8 * n + 2 * tq + j, sq, sk, causal, window);
          const float p = ok ? ex2(s[n][2 * r + j] * c - lse_r[r]) : 0.f;
          s[n][2 * r + j] = p * (dp[n][2 * r + j] - d_r[r]);     // dS
          res[r] += s[n][2 * r + j];
          dp[n][2 * r + j] = p;                                  // P
        }
    }
    // dq += dS.K and the residual's direction += P_hi.K, a fresh
    // accumulator a tile and 64 columns
    uint32_t hi[KS][4], lo[KS][4];
    to_a<KS>(dp, hi, lo);
#pragma unroll
    for (int c0 = 0; c0 + kNC <= NO; c0 += kNC) {
      float part[kNC][4] = {};
      mma_hi_b<kNC, KS, STR>(part, hi, Ks, c0 * 8, lane);
      add_sum<kNC>(wb, c0, part, lane);
    }
    to_a<KS>(s, hi, lo);
#pragma unroll
    for (int c0 = 0; c0 + kNC <= NO; c0 += kNC) {
      float part[kNC][4] = {};
      mma_split_b<kNC, KS, STR>(part, hi, lo, Ks, c0 * 8, lane);
      add_sum<kNC>(wsum, c0, part, lane);
    }
    __syncthreads();                           // every warp is done with this stage
  }
  // dq = dS.K - res P.K; D = D0 + res for the dk / dv kernel
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    res[r] += __shfl_xor_sync(kFull, res[r], 1);
    res[r] += __shfl_xor_sync(kFull, res[r], 2);
    if (tq == 0)
      stats[((long long)n_bh + bh) * sq_pad + row0 + g + 8 * r] = d_r[r] + res[r];
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float4* x = reinterpret_cast<float4*>(wsum) + n * 32 + lane;
    const float4 y = reinterpret_cast<const float4*>(wb)[n * 32 + lane];
    x->x -= res[0] * y.x;
    x->y -= res[0] * y.y;
    x->z -= res[1] * y.z;
    x->w -= res[1] * y.w;
  }
  __syncwarp();
  write_sum<bf16, D>(dq + (long long)bh * sq * D, wsum, row0, sq, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(Bf16Dkv<D>::kThreads, blocks_per_sm(Bf16Dkv<D>::kSmemBytes))
fa_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                  const float* __restrict__ stats, float* __restrict__ parts,
                  int* __restrict__ tickets, int n_bh, int sq, int sk, int q_per_kv,
                  int causal, int window, float scale, int sq_pad) {
  using T = Bf16Dkv<D>;
  constexpr int BQ = T::BQ, STR = T::STR, NQ = BQ / 8, KQ = BQ / 16, NO = D / 8;
  constexpr int S = T::kStages;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + T::KV_ELEMS;
  char* ring = reinterpret_cast<char*>(Vs + T::KV_ELEMS);
  float* sums = reinterpret_cast<float*>(ring + S * T::STAGE_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // one query head a block: kt (the first keys see the most queries, so they
  // go first), kv, then the head gq of the KV head's q_per_kv
  const int n_bkh = n_bh / q_per_kv;
  const int gq = blockIdx.x % q_per_kv, kv = blockIdx.x / q_per_kv % n_bkh;
  const int kt = blockIdx.x / q_per_kv / n_bkh, k0 = kt * kRows, bh = kv * q_per_kv + gq;
  const bf16* kb = k + (long long)kv * sk * D;
  const bf16* vb = v + (long long)kv * sk * D;
  const float c = scale * kLog2e;

  int qt_begin, qt_end;
  q_tiles<BQ>(k0, kRows, sq, causal, window, &qt_begin, &qt_end);
  const int n_it = qt_end - qt_begin;

  const int key0 = k0 + warp * 16;               // this warp's keys
  float* wk = sums + warp * 16 * D;              // its dk, then its dv
  float* wv = sums + kRows * D + warp * 16 * D;
  zero_sum<NO>(wk, lane);
  zero_sum<NO>(wv, lane);

  // step it: the query tile qt_begin + it; with 2 stages step 0 goes with K
  // and V, and step it + 1 is in flight during it
  stage_rows<bf16, D, kRows, STR, T::kThreads>(Ks, kb, k0, sk, tid);
  stage_rows<bf16, D, kRows, STR, T::kThreads>(Vs, vb, k0, sk, tid);
  if (S > 1 && n_it > 0)
    stage_q<bf16, D, BQ, STR, T::kThreads>(reinterpret_cast<bf16*>(ring), q, dout, stats, bh,
                                           qt_begin * BQ, sq, n_bh, sq_pad, tid);
  commit();

  for (int it = 0; it < n_it; ++it) {
    const int qs = (qt_begin + it) * BQ, nx = it + S - 1;
    if (nx < n_it)                               // that stage's readers passed the last barrier
      stage_q<bf16, D, BQ, STR, T::kThreads>(
          reinterpret_cast<bf16*>(ring + (nx % S) * T::STAGE_BYTES), q, dout, stats, bh,
          (qt_begin + nx) * BQ, sq, n_bh, sq_pad, tid);
    commit();
    wait_group<S - 1>();
    __syncthreads();
    const char* st = ring + (it % S) * T::STAGE_BYTES;
    const bf16* Qs = reinterpret_cast<const bf16*>(st);
    const bf16* dOs = Qs + BQ * STR;
    const float* ls = reinterpret_cast<const float*>(dOs + BQ * STR);
    const float* ds = ls + BQ;

    // S^T = K.Q^T, dP^T = V.dO^T: rows the warp's 16 keys, columns BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<NQ, D, STR, STR>(s, Ks + warp * 16 * STR, Qs, lane);
    mma_abt<NQ, D, STR, STR>(dp, Vs + warp * 16 * STR, dOs, lane);

    const bool all = whole(qs, BQ, key0, 16, sq, sk, causal, window);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qs + 8 * n + 2 * tq + (e & 1), kj = key0 + g + 8 * (e >> 1);
        const bool ok = all || valid(qi, kj, sq, sk, causal, window);
        const float li = (e & 1) ? l2.y : l2.x, di = (e & 1) ? d2.y : d2.x;
        const float p = ok ? ex2(s[n][e] * c - li) : 0.f;
        s[n][e] = p;                                  // P^T
        dp[n][e] = p * (dp[n][e] - di);               // dS^T
      }
    }
    uint32_t p_hi[KQ][4], p_lo[KQ][4], s_hi[KQ][4], s_lo[KQ][4];
    to_a<KQ>(s, p_hi, p_lo);
    to_a<KQ>(dp, s_hi, s_lo);
    // dv += P^T.dO, dk += dS^T.Q: a fresh accumulator a step and 64 columns
#pragma unroll
    for (int c0 = 0; c0 + kNC <= NO; c0 += kNC) {
      float part[kNC][4] = {};
      mma_split_b<kNC, KQ, STR>(part, p_hi, p_lo, dOs, c0 * 8, lane);
      add_sum<kNC>(wv, c0, part, lane);
      float part2[kNC][4] = {};
      mma_split_b<kNC, KQ, STR>(part2, s_hi, s_lo, Qs, c0 * 8, lane);
      add_sum<kNC>(wk, c0, part2, lane);
    }
    __syncthreads();                             // every warp is done with this stage
  }
  wait_group<0>();                               // (a block that no query sees)
  if (q_per_kv > 1 && !combine<2 * kRows * D / 4, T::kThreads>(
                          sums, parts + (long long)(kt * n_bkh + kv) * q_per_kv * 2 * kRows * D,
                          tickets + kt * n_bkh + kv, gq, q_per_kv, tid))
    return;
  write_sum<bf16, D>(dk + (long long)kv * sk * D, wk, key0, sk, scale, lane);
  write_sum<bf16, D>(dv + (long long)kv * sk * D, wv, key0, sk, 1.f, lane);
}

// =================================================== float32, 3xTF32
using fa_tf32x3::mma_rows;

// acc = A . B^T over D at float32 accuracy: a at (g, t) of A's 16 rows
// (stride SA), b at (n = g, k = t) of B^T's rows (stride SB).  In one
// accumulator up to d 128 (3 d / 8 truncating adds); at d 256 64 columns of
// d at a time, each in a fresh accumulator joined by rounded adds (the
// forward's TF32 route does the same, flash_attention_tf32x3.cuh)
template <int NT, int D, int SA, int SB>
__device__ __forceinline__ void tf32_abt(float (&acc)[NT][4], const float* a, const float* b) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if constexpr (D <= 128) {
    mma_rows<NT, D, SA, 8 * SB, 1>(acc, a, b);
  } else {
    mma_rows<NT, 64, SA, 8 * SB, 1>(acc, a, b);
#pragma unroll 1
    for (int c0 = 64; c0 < D; c0 += 64) {
      float part[NT][4] = {};
      mma_rows<NT, 64, SA, 8 * SB, 1>(part, a + c0, b + c0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
  }
}

// A warp's 16 x 8 N accumulator into its shared tile (row-major, stride PS),
// where mma_rows reads it back as an A operand (row g at columns t, t + 4)
template <int N, int PS>
__device__ __forceinline__ void to_tile(float* pw, const float (&x)[N][4], int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    *reinterpret_cast<float2*>(pw + g * PS + 8 * n + 2 * tq) = make_float2(x[n][0], x[n][1]);
    *reinterpret_cast<float2*>(pw + (g + 8) * PS + 8 * n + 2 * tq) = make_float2(x[n][2], x[n][3]);
  }
}

// running sum (columns [0, D)) += A . B, A the warp's shared tile of 16 x K
// (pa at (g, t), stride PS), B the rows of a row-major [k][n] tile
// (stride SB; pb at (k = t, n = g)), 64 output columns a fresh accumulator
template <int D, int K, int PS, int SB>
__device__ __forceinline__ void tf32_ab_into(float* wsum, const float* pa, const float* pb,
                                             int lane) {
  constexpr int NO = D / 8;
#pragma unroll 1
  for (int c0 = 0; c0 + kNC <= NO; c0 += kNC) {
    float part[kNC][4] = {};
    mma_rows<kNC, K, PS, 8, SB>(part, pa, pb + c0 * 8);
    add_sum<kNC>(wsum, c0, part, lane);
  }
  if constexpr (NO % kNC != 0) {
    constexpr int R = NO % kNC;
    float part[R][4] = {};
    mma_rows<R, K, PS, 8, SB>(part, pa, pb + (NO - R) * 8);
    add_sum<R>(wsum, NO - R, part, lane);
  }
}

template <int D>
struct F32Dq {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int BK = D <= 128 ? 32 : 8;
  static constexpr int kStages = D <= 128 ? 2 : 1;
  static constexpr int QSTR = D + 4, KSTR = D + 4, PSTR = BK + 4;
  static constexpr int Q_FLOATS = kRows * QSTR;                 // Q, then dO
  static constexpr int STAGE_FLOATS = 2 * BK * KSTR;           // K, then V
  static constexpr int P_FLOATS = kWarps * 16 * PSTR;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)Q_FLOATS + kStages * (size_t)STAGE_FLOATS + P_FLOATS +
                       (size_t)kRows * D);
};

template <int D>
struct F32Dkv {
  // keys a block: 64 (4 warps), 32 at d 256, where 64 keys' K, V and running
  // sums would not fit the block's shared memory
  static constexpr int kKeys = D <= 128 ? 64 : 32;
  static constexpr int kWarps = kKeys / 16, kThreads = 32 * kWarps;
  static constexpr int BQ = D <= 64 ? 32 : D <= 128 ? 16 : 8;
  static constexpr int kStages = D <= 128 ? 2 : 1;
  static constexpr int KSTR = D + 4, QSTR = D + 4, PSTR = BQ + 4;
  static constexpr int KV_FLOATS = kKeys * KSTR;
  static constexpr int STAGE_FLOATS = 2 * BQ * QSTR + 2 * BQ;   // Q, dO, lse, D
  static constexpr int P_FLOATS = kWarps * 16 * PSTR;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)KV_FLOATS + kStages * (size_t)STAGE_FLOATS + P_FLOATS +
                       2 * (size_t)kKeys * D);
};

template <int D>
__global__ void __launch_bounds__(F32Dq<D>::kThreads, blocks_per_sm(F32Dq<D>::kSmemBytes))
fa_bwd_tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ o32, const float* __restrict__ lse,
                        float* __restrict__ dq, float* __restrict__ stats, int n_bh, int sq,
                        int sk, int q_per_kv, int causal, int window, float scale, int n_qt,
                        int sq_pad) {
  using T = F32Dq<D>;
  constexpr int BK = T::BK, NS = BK / 8, NO = D / 8, S = T::kStages;
  constexpr int QSTR = T::QSTR, KSTR = T::KSTR, PSTR = T::PSTR;
  extern __shared__ float4 smem4[];
  __shared__ float row_l[kRows], row_d[kRows];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T::Q_FLOATS;
  float* ring = dOs + T::Q_FLOATS;
  float* Ps = ring + S * T::STAGE_FLOATS;
  float* sums = Ps + T::P_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - blockIdx.x / n_bh) * kRows;
  const int kv = bh / q_per_kv;
  const float* qb = q + (long long)bh * sq * D;
  const float* dob = dout + (long long)bh * sq * D;
  const float* kb = k + (long long)kv * sk * D;
  const float* vb = v + (long long)kv * sk * D;
  const float c = scale * kLog2e;

  int t_begin, t_end;
  kv_tiles<BK>(q0, sq, sk, causal, window, &t_begin, &t_end);
  const int nt = t_end - t_begin;

  const int row0 = q0 + warp * 16;
  float* wsum = sums + warp * 16 * D;
  float* Pw = Ps + warp * 16 * PSTR;
  zero_sum<NO>(wsum, lane);

  if (nt > 0) {
    stage_rows<float, D, kRows, QSTR, T::kThreads>(Qs, qb, q0, sq, tid);
    stage_rows<float, D, kRows, QSTR, T::kThreads>(dOs, dob, q0, sq, tid);
    if (S > 1) stage_kv<float, D, BK, KSTR, T::kThreads>(ring, kb, vb, t_begin * BK, sk, tid);
    commit();
  }
  row_stats<float, D, kRows, true>(dout, o32, lse, stats, row_l, row_d, bh, q0, sq, n_bh,
                                   sq_pad, tid);
  __syncthreads();
  const float lse_r[2] = {row_l[warp * 16 + g], row_l[warp * 16 + g + 8]};
  const float d_r[2] = {row_d[warp * 16 + g], row_d[warp * 16 + g + 8]};

  for (int it = 0; it < nt; ++it) {
    const int k0 = (t_begin + it) * BK;
    const float* Ks = ring + (it % S) * T::STAGE_FLOATS;
    const float* Vs = Ks + BK * KSTR;
    if (it + S - 1 < nt)
      stage_kv<float, D, BK, KSTR, T::kThreads>(ring + ((it + S - 1) % S) * T::STAGE_FLOATS, kb,
                                                vb, (t_begin + it + S - 1) * BK, sk, tid);
    commit();
    wait_group<S - 1>();
    __syncthreads();

    float s[NS][4], dp[NS][4];
    tf32_abt<NS, D, QSTR, KSTR>(s, Qs + (warp * 16 + g) * QSTR + tq, Ks + g * KSTR + tq);
    tf32_abt<NS, D, QSTR, KSTR>(dp, dOs + (warp * 16 + g) * QSTR + tq, Vs + g * KSTR + tq);

    const bool all = whole(row0, 16, k0, BK, sq, sk, causal, window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = all || valid(qi, k0 + 8 * n + 2 * tq + j, sq, sk, causal, window);
          const float p = ok ? ex2(s[n][2 * r + j] * c - lse_r[r]) : 0.f;
          s[n][2 * r + j] = p * (dp[n][2 * r + j] - d_r[r]);
        }
    }
    // dq += dS.K through the warp's tile: B(k = key, n = column) = K[key][column]
    to_tile<NS, PSTR>(Pw, s, lane);
    __syncwarp();
    tf32_ab_into<D, BK, PSTR, KSTR>(wsum, Pw + g * PSTR + tq, Ks + tq * KSTR + g, lane);
    __syncwarp();
    __syncthreads();
  }
  __syncwarp();
  write_sum<float, D>(dq + (long long)bh * sq * D, wsum, row0, sq, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(F32Dkv<D>::kThreads, blocks_per_sm(F32Dkv<D>::kSmemBytes))
fa_bwd_tf32x3_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const float* __restrict__ stats, float* __restrict__ parts,
                         int* __restrict__ tickets, int n_bh, int sq, int sk, int q_per_kv,
                         int causal, int window, float scale, int sq_pad) {
  using T = F32Dkv<D>;
  constexpr int BQ = T::BQ, NQ = BQ / 8, NO = D / 8, S = T::kStages, KEYS = T::kKeys;
  constexpr int QSTR = T::QSTR, KSTR = T::KSTR, PSTR = T::PSTR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T::KV_FLOATS;
  float* ring = Vs + T::KV_FLOATS;
  float* Ps = ring + S * T::STAGE_FLOATS;
  float* sums = Ps + T::P_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n_bkh = n_bh / q_per_kv;
  const int gq = blockIdx.x % q_per_kv, kv = blockIdx.x / q_per_kv % n_bkh;
  const int kt = blockIdx.x / q_per_kv / n_bkh, k0 = kt * KEYS, bh = kv * q_per_kv + gq;
  const float* kb = k + (long long)kv * sk * D;
  const float* vb = v + (long long)kv * sk * D;
  const float c = scale * kLog2e;

  int qt_begin, qt_end;
  q_tiles<BQ>(k0, KEYS, sq, causal, window, &qt_begin, &qt_end);
  const int n_it = qt_end - qt_begin;

  const int key0 = k0 + warp * 16;
  float* wk = sums + warp * 16 * D;
  float* wv = sums + KEYS * D + warp * 16 * D;
  float* Pw = Ps + warp * 16 * PSTR;
  zero_sum<NO>(wk, lane);
  zero_sum<NO>(wv, lane);

  stage_rows<float, D, KEYS, KSTR, T::kThreads>(Ks, kb, k0, sk, tid);
  stage_rows<float, D, KEYS, KSTR, T::kThreads>(Vs, vb, k0, sk, tid);
  if (S > 1 && n_it > 0)
    stage_q<float, D, BQ, QSTR, T::kThreads>(ring, q, dout, stats, bh, qt_begin * BQ, sq, n_bh,
                                             sq_pad, tid);
  commit();

  for (int it = 0; it < n_it; ++it) {
    const int qs = (qt_begin + it) * BQ, nx = it + S - 1;
    if (nx < n_it)
      stage_q<float, D, BQ, QSTR, T::kThreads>(ring + (nx % S) * T::STAGE_FLOATS, q, dout, stats,
                                               bh, (qt_begin + nx) * BQ, sq, n_bh, sq_pad, tid);
    commit();
    wait_group<S - 1>();
    __syncthreads();
    const float* Qs = ring + (it % S) * T::STAGE_FLOATS;
    const float* dOs = Qs + BQ * QSTR;
    const float* ls = dOs + BQ * QSTR;
    const float* ds = ls + BQ;

    float s[NQ][4], dp[NQ][4];
    tf32_abt<NQ, D, KSTR, QSTR>(s, Ks + (warp * 16 + g) * KSTR + tq, Qs + g * QSTR + tq);
    tf32_abt<NQ, D, KSTR, QSTR>(dp, Vs + (warp * 16 + g) * KSTR + tq, dOs + g * QSTR + tq);

    const bool all = whole(qs, BQ, key0, 16, sq, sk, causal, window);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qs + 8 * n + 2 * tq + (e & 1), kj = key0 + g + 8 * (e >> 1);
        const bool ok = all || valid(qi, kj, sq, sk, causal, window);
        const float li = (e & 1) ? l2.y : l2.x, di = (e & 1) ? d2.y : d2.x;
        const float p = ok ? ex2(s[n][e] * c - li) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - di);
      }
    }
    // dv += P^T.dO, then dk += dS^T.Q, through the warp's tile:
    // B(k = query, n = column) = dO[query][column], Q[query][column]
    to_tile<NQ, PSTR>(Pw, s, lane);
    __syncwarp();
    tf32_ab_into<D, BQ, PSTR, QSTR>(wv, Pw + g * PSTR + tq, dOs + tq * QSTR + g, lane);
    __syncwarp();
    to_tile<NQ, PSTR>(Pw, dp, lane);
    __syncwarp();
    tf32_ab_into<D, BQ, PSTR, QSTR>(wk, Pw + g * PSTR + tq, Qs + tq * QSTR + g, lane);
    __syncthreads();
  }
  wait_group<0>();                               // (a block that no query sees)
  if (q_per_kv > 1 && !combine<2 * KEYS * D / 4, T::kThreads>(
                          sums, parts + (long long)(kt * n_bkh + kv) * q_per_kv * 2 * KEYS * D,
                          tickets + kt * n_bkh + kv, gq, q_per_kv, tid))
    return;
  write_sum<float, D>(dk + (long long)kv * sk * D, wk, key0, sk, scale, lane);
  write_sum<float, D>(dv + (long long)kv * sk * D, wv, key0, sk, 1.f, lane);
}

// ------------------------------------------------------------ launch
template <typename Kern>
cudaError_t opt_in(Kern kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

// The dq kernel, then the dk / dv kernel (a block a key tile and query head),
// on stream s.  o32: the forward's float32 output; lse: its log-sum-exp
// (n_bh x sq).  Scratch: stats, 2 x n_bh x sq_pad float32 (lse, D; sq_pad
// a multiple of 128 at or above sq), written by the first and read by the
// second; with q_per_kv > 1, parts (each head's dk and dv, 2 x KEYS x d
// float32 a block) and tickets, n_bh / q_per_kv x ceil(sk / 32) int32, zero.
// sq, sk >= 1.
template <typename Dq, typename Dkv, int KEYS, typename E>
int launch_pair(void (*dq_kernel)(const E*, const E*, const E*, const E*, const float*,
                                  const float*, E*, float*, int, int, int, int, int, int, float,
                                  int, int),
                void (*dkv_kernel)(const E*, const E*, const E*, const E*, E*, E*,
                                   const float*, float*, int*, int, int, int, int, int, int,
                                   float, int),
                bool& dq_done, bool& dkv_done, const void* q, const void* k, const void* v,
                const void* o32, const void* dout, const void* lse, void* dq, void* dk,
                void* dv, void* stats, void* parts, void* tickets, long long n_bh, int sq,
                int sk, int q_per_kv, int causal, int window, float scale, int sq_pad,
                cudaStream_t s) {
  cudaError_t err = opt_in(dq_kernel, Dq::kSmemBytes, dq_done);
  if (err == cudaSuccess) err = opt_in(dkv_kernel, Dkv::kSmemBytes, dkv_done);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + kRows - 1) / kRows;
  const long long grid_dq = (long long)n_qt * n_bh;
  const long long grid_dkv = (long long)((sk + KEYS - 1) / KEYS) * n_bh;
  if (n_bh > 0x7fffffffLL || grid_dq > 0x7fffffffLL || grid_dkv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* de = static_cast<const E*>(dout);
  dq_kernel<<<(unsigned)grid_dq, Dq::kThreads, Dq::kSmemBytes, s>>>(
      qe, ke, ve, de, static_cast<const float*>(o32), static_cast<const float*>(lse),
      static_cast<E*>(dq), static_cast<float*>(stats), (int)n_bh, sq, sk, q_per_kv, causal,
      window, scale, n_qt, sq_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<(unsigned)grid_dkv, Dkv::kThreads, Dkv::kSmemBytes, s>>>(
      qe, ke, ve, de, static_cast<E*>(dk), static_cast<E*>(dv),
      static_cast<const float*>(stats), static_cast<float*>(parts), static_cast<int*>(tickets),
      (int)n_bh, sq, sk, q_per_kv, causal, window, scale, sq_pad);
  return (int)cudaGetLastError();
}

// BF16: the bf16 mma.sync kernels (d 256); else the TF32 ones (3xTF32)
template <int D, bool BF16>
int launch(const void* q, const void* k, const void* v, const void* o32, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* stats, void* parts,
           void* tickets, long long n_bh, int sq, int sk, int q_per_kv, int causal, int window,
           float scale, int sq_pad, cudaStream_t s) {
  static bool dq_done = false, dkv_done = false;   // per instantiation, once per process
  if constexpr (BF16)
    return launch_pair<Bf16Dq<D>, Bf16Dkv<D>, kRows>(
        fa_bwd_dq_kernel<D>, fa_bwd_dkv_kernel<D>, dq_done, dkv_done, q, k, v, o32, dout, lse,
        dq, dk, dv, stats, parts, tickets, n_bh, sq, sk, q_per_kv, causal, window, scale,
        sq_pad, s);
  else
    return launch_pair<F32Dq<D>, F32Dkv<D>, F32Dkv<D>::kKeys>(
        fa_bwd_tf32x3_dq_kernel<D>, fa_bwd_tf32x3_dkv_kernel<D>, dq_done, dkv_done, q, k, v,
        o32, dout, lse, dq, dk, dv, stats, parts, tickets, n_bh, sq, sk, q_per_kv, causal,
        window, scale, sq_pad, s);
}

}  // namespace fa_bwd
