// flash_attention's backward, for sm_90a: dq, dk and dv of the function the
// forward kernels compute,
//   o[bh, i] = sum_j p_ij v[kv, j],  p_ij = exp(s_ij - m_i) / l_i,
//   s_ij = scale * q[bh, i] . k[kv, j],  kv = bh / q_per_kv,
// over the keys j the causal / window mask lets through (a row with no valid
// key gives 0 and takes no gradient).  With dP = dO.V^T and
// D_i = sum_j p_ij dP_ij:
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
// TB/s).
//
// Two routes, fixed by dtype as the forward's (kernel.py's bwd_route):
//   * bfloat16 on the tensor cores through warp-level mma.sync m16n8k16 with
//     float32 accumulators (wgmma and TMA are later work).  Q.K^T and dO.V^T
//     are exact bf16 products.  P and dS are float32 and are split, as the
//     forward splits P for P.V (flash_attention_wgmma.cuh): x_hi = bf16(x),
//     x_lo = bf16(x - x_hi), and each of P^T.dO, dS.K and dS^T.Q is two
//     products into one accumulator.  Rounding P or dS to bf16 once would make
//     a quarter of the bf16 outputs differ from the float32 gradient rounded
//     once (the forward's emulation, 23-24 % against the check's 1 %;
//     tests/test_torch_flash_bwd.py emulates the backward's split);
//   * float32 on the TF32 tensor cores through mma.sync m16n8k8 with every
//     operand split three ways (3xTF32, flash_attention_tf32x3.cuh's helpers),
//     so that the gradient keeps float32 accuracy (2e-5 of its largest
//     magnitude).
//
// The schedule, two kernels a route, deterministic (no atomics, so a
// backward repeats bit for bit):
//   (a) dq: one block per (query head, 64 query rows), 4 warps of 16 rows.
//       Sweep 1 over the KV tiles the mask lets through computes S and
//       dP = dO.V^T and carries the row's max m, its sum l and
//       D = sum p dP online (l and D rescaled together when m moves): D comes
//       from the float32 products of the same rows, never from the saved
//       bf16 output, which carries a rounding the reference's float32 autodiff
//       does not.  Sweep 2 over the same tiles recomputes S and dP, forms
//       P = exp(S - m) / l and dS, and accumulates dq = dS.K.  It writes m,
//       1 / l and D (float32, one row of 64 a block past sq included) for (b);
//   (b) dk, dv: one block per (KV head, 64 keys), a warp of 16 keys each
//       (32 keys and 2 warps for float32 at d 256).  It loops over the KV
//       head's q_per_kv query heads and, for each, over the query tiles the
//       mask lets through: S^T = K.Q^T, dP^T = V.dO^T, P^T and dS^T from the
//       saved m, 1 / l, D, then dv += P^T.dO and dk += dS^T.Q.  The heads are
//       summed in float32, as the reference's float32 autodiff sums them, and
//       rounded once at the end.
// Both sweeps of (a) run through one ring of KV tiles, so the second sweep's
// first tile is in flight while the first sweep's last one is multiplied.
//
// The mma adds into its accumulator rounding toward zero, so a long sum in
// one accumulator drifts toward zero (the forward's TF32 route measured it,
// flash_attention_tf32x3.cuh).  So no product accumulates across tiles: each
// tile's dq, dk or dv goes into a fresh accumulator, 64 output columns at a
// time, and is added to the running sum by rounded float32 adds.  The
// running sums live in shared memory in the accumulator's own layout (a
// float4 a lane and 8-column block), which no other lane touches: at d 256 a
// warp's 16 rows of dk and dv in registers would take 256 a thread.
//
// Masks: a tile whose every (query, key) pair is valid skips the mask; a
// masked pair has P = 0 (explicitly: a row with no valid key has m = -1e30,
// and exp(s - m) would not vanish), and such a row has 1 / l = 0 and D = 0,
// so its dq is 0 and it adds nothing to dk or dv.  Rows past sq and keys past
// sk are zero-filled by the copies and masked.  Only the (query tile, KV
// tile) pairs with some valid pair are visited.
//
// Shared rows: bf16 rows of d + 8 elements (an odd number of 16-byte units,
// so ldmatrix's 8 rows fall on distinct banks at every d); float32 rows of
// d + 4.  Copies are 16-byte cp.async into a ring of 2 stages (1 where the
// tiles and the running sums fill the block's 227 KB: d 256).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// The end of sweep 1 for rows g and g + 8 of a warp: the quad's parts of l
// and D summed, 1 / l (0 for a row with no valid key) and D = sum p dP / l,
// and the rows' m, 1 / l and D written to the stats by the lanes of t 0
// (at: row g's index in a plane of n_bh x sq_pad).
__device__ __forceinline__ void finish_stats(const float (&m)[2], float (&l)[2], float (&dd)[2],
                                             float (&inv_l)[2], float* stats, long long plane,
                                             long long at, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    dd[r] += __shfl_xor_sync(kFull, dd[r], 1);
    dd[r] += __shfl_xor_sync(kFull, dd[r], 2);
    inv_l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    dd[r] *= inv_l[r];
    if (tq == 0) {
      stats[at + 8 * r] = m[r];
      stats[plane + at + 8 * r] = inv_l[r];
      stats[2 * plane + at + 8 * r] = dd[r];
    }
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
// of STR), then their m, 1 / l and D, into a stage of its ring
template <typename E, int D, int BQ, int STR, int THREADS>
__device__ __forceinline__ void stage_q(E* st, const E* q, const E* dout, const float* stats,
                                        int bh, int qs, int sq, int n_bh, int sq_pad, int tid) {
  stage_rows<E, D, BQ, STR, THREADS>(st, q + (long long)bh * sq * D, qs, sq, tid);
  stage_rows<E, D, BQ, STR, THREADS>(st + BQ * STR, dout + (long long)bh * sq * D, qs, sq, tid);
  float* f = reinterpret_cast<float*>(st + 2 * BQ * STR);
#pragma unroll
  for (int a = 0; a < 3; ++a)
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

// The KV tiles of BK keys that some row of [q0, q0 + 64) sees: [*t0, *t1).
template <int BK>
__device__ __forceinline__ void kv_tiles(int q0, int sq, int sk, int causal, int window, int* t0,
                                         int* t1) {
  const int q_last = min(q0 + kRows, sq) - 1;
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

template <int D>
struct Bf16Dq {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int BK = D <= 64 ? 64 : 32;        // keys a KV tile
  static constexpr int STR = D + 8;
  static constexpr int Q_ELEMS = kRows * STR;          // Q, then dO
  static constexpr int STAGE_ELEMS = 2 * BK * STR;     // K, then V
  static constexpr size_t kSmemBytes =
      sizeof(bf16) * (2 * (size_t)Q_ELEMS + 2 * (size_t)STAGE_ELEMS) +
      sizeof(float) * (size_t)kRows * D;
};

template <int D>
struct Bf16Dkv {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int BQ = D <= 128 ? 64 : 16;        // query rows a step
  static constexpr int kStages = D <= 128 ? 2 : 1;
  static constexpr int STR = D + 8;
  static constexpr int KV_ELEMS = kRows * STR;         // K, then V
  static constexpr int STAGE_BYTES = 2 * BQ * STR * (int)sizeof(bf16) + 3 * BQ * (int)sizeof(float);
  static constexpr size_t kSmemBytes = sizeof(bf16) * 2 * (size_t)KV_ELEMS +
                                       (size_t)kStages * STAGE_BYTES +
                                       sizeof(float) * 2 * (size_t)kRows * D;
};

template <int D>
__global__ void __launch_bounds__(Bf16Dq<D>::kThreads, blocks_per_sm(Bf16Dq<D>::kSmemBytes))
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 bf16* __restrict__ dq, float* __restrict__ stats, int n_bh, int sq, int sk,
                 int q_per_kv, int causal, int window, float scale, int n_qt) {
  using T = Bf16Dq<D>;
  constexpr int BK = T::BK, STR = T::STR, NS = BK / 8, KS = BK / 16, NO = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + T::Q_ELEMS;
  bf16* ring = dOs + T::Q_ELEMS;
  float* sums = reinterpret_cast<float*>(ring + 2 * T::STAGE_ELEMS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - blockIdx.x / n_bh) * kRows;     // heaviest causal tiles first
  const int kv = bh / q_per_kv;
  const bf16* qb = q + (long long)bh * sq * D;
  const bf16* dob = dout + (long long)bh * sq * D;
  const bf16* kb = k + (long long)kv * sk * D;
  const bf16* vb = v + (long long)kv * sk * D;
  const int sq_pad = n_qt * kRows;
  const float c = scale * kLog2e;

  int t_begin, t_end;
  kv_tiles<BK>(q0, sq, sk, causal, window, &t_begin, &t_end);
  const int nt = t_end - t_begin;

  const int row0 = q0 + warp * 16;                  // this warp's rows
  float* wsum = sums + warp * 16 * D;
  zero_sum<NO>(wsum, lane);

  if (nt > 0) {
    stage_rows<bf16, D, kRows, STR, T::kThreads>(Qs, qb, q0, sq, tid);
    stage_rows<bf16, D, kRows, STR, T::kThreads>(dOs, dob, q0, sq, tid);
    stage_kv<bf16, D, BK, STR, T::kThreads>(ring, kb, vb, t_begin * BK, sk, tid);
    commit();
  }

  // rows g and g + 8 of the warp: the running max (log2 units), this lane's
  // part of the sum l and of D = sum p dP; then 1 / l and D
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f}, inv_l[2];
  const long long plane = (long long)n_bh * sq_pad, at = (long long)bh * sq_pad + row0 + g;
  if (nt == 0) finish_stats(m, l, dd, inv_l, stats, plane, at, tq);

  for (int it = 0; it < 2 * nt; ++it) {
    const int k0 = (t_begin + it % nt) * BK;
    const bool second = it >= nt;
    const bf16* Ks = ring + (it & 1) * T::STAGE_ELEMS;
    const bf16* Vs = Ks + BK * STR;
    if (it + 1 < 2 * nt)                       // that stage's readers passed the last barrier
      stage_kv<bf16, D, BK, STR, T::kThreads>(ring + ((it + 1) & 1) * T::STAGE_ELEMS, kb, vb,
                                              (t_begin + (it + 1) % nt) * BK, sk, tid);
    commit();                                  // (an empty group on the last tile)
    wait_group<1>();
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
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[n][2 * r + j];
          const bool ok = all || valid(qi, k0 + 8 * n + 2 * tq + j, sq, sk, causal, window);
          x = ok ? x * c : kNegInf;
          mx = fmaxf(mx, x);
        }
      if (!second) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = ex2(m[r] - m_new);
        m[r] = m_new;
        float ls = 0.f, ds = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = s[n][2 * r + j];
            const float p = x > kNegInf ? ex2(x - m_new) : 0.f;
            ls += p;
            ds += p * dp[n][2 * r + j];
          }
        l[r] = l[r] * alpha + ls;
        dd[r] = dd[r] * alpha + ds;
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = s[n][2 * r + j];
            const float p = x > kNegInf ? ex2(x - m[r]) * inv_l[r] : 0.f;
            s[n][2 * r + j] = p * (dp[n][2 * r + j] - dd[r]);     // dS
          }
      }
    }
    if (second) {
      // dq += dS.K, a fresh accumulator a tile and 64 columns
      uint32_t hi[KS][4], lo[KS][4];
      to_a<KS>(s, hi, lo);
#pragma unroll
      for (int c0 = 0; c0 + kNC <= NO; c0 += kNC) {
        float part[kNC][4] = {};
        mma_split_b<kNC, KS, STR>(part, hi, lo, Ks, c0 * 8, lane);
        add_sum<kNC>(wsum, c0, part, lane);
      }
      if constexpr (NO % kNC != 0) {
        constexpr int R = NO % kNC;
        float part[R][4] = {};
        mma_split_b<R, KS, STR>(part, hi, lo, Ks, (NO - R) * 8, lane);
        add_sum<R>(wsum, NO - R, part, lane);
      }
    } else if (it == nt - 1) {
      finish_stats(m, l, dd, inv_l, stats, plane, at, tq);
    }
    __syncthreads();                           // every warp is done with this stage
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
                  int causal, int window, float scale, int n_qt) {
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
  const int sq_pad = n_qt * kRows;
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
    const float* ms = reinterpret_cast<const float*>(dOs + BQ * STR);
    const float* ils = ms + BQ;
    const float* ds = ils + BQ;

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
      const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * n + 2 * tq);
      const float2 il2 = *reinterpret_cast<const float2*>(ils + 8 * n + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qs + 8 * n + 2 * tq + (e & 1), kj = key0 + g + 8 * (e >> 1);
        const bool ok = all || valid(qi, kj, sq, sk, causal, window);
        const float mi = (e & 1) ? m2.y : m2.x, il = (e & 1) ? il2.y : il2.x;
        const float di = (e & 1) ? d2.y : d2.x;
        const float p = ok ? ex2(s[n][e] * c - mi) * il : 0.f;
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
    if constexpr (NO % kNC != 0) {
      constexpr int R = NO % kNC;
      float part[R][4] = {};
      mma_split_b<R, KQ, STR>(part, p_hi, p_lo, dOs, (NO - R) * 8, lane);
      add_sum<R>(wv, NO - R, part, lane);
      float part2[R][4] = {};
      mma_split_b<R, KQ, STR>(part2, s_hi, s_lo, Qs, (NO - R) * 8, lane);
      add_sum<R>(wk, NO - R, part2, lane);
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
  static constexpr int STAGE_FLOATS = 2 * BQ * QSTR + 3 * BQ;   // Q, dO, m, 1 / l, D
  static constexpr int P_FLOATS = kWarps * 16 * PSTR;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)KV_FLOATS + kStages * (size_t)STAGE_FLOATS + P_FLOATS +
                       2 * (size_t)kKeys * D);
};

template <int D>
__global__ void __launch_bounds__(F32Dq<D>::kThreads, blocks_per_sm(F32Dq<D>::kSmemBytes))
fa_bwd_tf32x3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ stats, int n_bh, int sq,
                        int sk, int q_per_kv, int causal, int window, float scale, int n_qt) {
  using T = F32Dq<D>;
  constexpr int BK = T::BK, NS = BK / 8, NO = D / 8, S = T::kStages;
  constexpr int QSTR = T::QSTR, KSTR = T::KSTR, PSTR = T::PSTR;
  extern __shared__ float4 smem4[];
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
  const int sq_pad = n_qt * kRows;
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

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f}, inv_l[2];
  const long long plane = (long long)n_bh * sq_pad, at = (long long)bh * sq_pad + row0 + g;
  if (nt == 0) finish_stats(m, l, dd, inv_l, stats, plane, at, tq);

  for (int it = 0; it < 2 * nt; ++it) {
    const int k0 = (t_begin + it % nt) * BK;
    const bool second = it >= nt;
    const float* Ks = ring + (it % S) * T::STAGE_FLOATS;
    const float* Vs = Ks + BK * KSTR;
    if (it + S - 1 < 2 * nt)
      stage_kv<float, D, BK, KSTR, T::kThreads>(ring + ((it + S - 1) % S) * T::STAGE_FLOATS, kb,
                                                vb, (t_begin + (it + S - 1) % nt) * BK, sk, tid);
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
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[n][2 * r + j];
          const bool ok = all || valid(qi, k0 + 8 * n + 2 * tq + j, sq, sk, causal, window);
          x = ok ? x * c : kNegInf;
          mx = fmaxf(mx, x);
        }
      if (!second) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = ex2(m[r] - m_new);
        m[r] = m_new;
        float ls = 0.f, ds = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = s[n][2 * r + j];
            const float p = x > kNegInf ? ex2(x - m_new) : 0.f;
            ls += p;
            ds += p * dp[n][2 * r + j];
          }
        l[r] = l[r] * alpha + ls;
        dd[r] = dd[r] * alpha + ds;
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = s[n][2 * r + j];
            const float p = x > kNegInf ? ex2(x - m[r]) * inv_l[r] : 0.f;
            s[n][2 * r + j] = p * (dp[n][2 * r + j] - dd[r]);
          }
      }
    }
    if (second) {
      // dq += dS.K through the warp's tile: B(k = key, n = column) = K[key][column]
      to_tile<NS, PSTR>(Pw, s, lane);
      __syncwarp();
      tf32_ab_into<D, BK, PSTR, KSTR>(wsum, Pw + g * PSTR + tq, Ks + tq * KSTR + g, lane);
      __syncwarp();
    } else if (it == nt - 1) {
      finish_stats(m, l, dd, inv_l, stats, plane, at, tq);
    }
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
                         int causal, int window, float scale, int n_qt) {
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
  const int sq_pad = n_qt * kRows;
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
    const float* ms = dOs + BQ * QSTR;
    const float* ils = ms + BQ;
    const float* ds = ils + BQ;

    float s[NQ][4], dp[NQ][4];
    tf32_abt<NQ, D, KSTR, QSTR>(s, Ks + (warp * 16 + g) * KSTR + tq, Qs + g * QSTR + tq);
    tf32_abt<NQ, D, KSTR, QSTR>(dp, Vs + (warp * 16 + g) * KSTR + tq, dOs + g * QSTR + tq);

    const bool all = whole(qs, BQ, key0, 16, sq, sk, causal, window);
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 m2 = *reinterpret_cast<const float2*>(ms + 8 * n + 2 * tq);
      const float2 il2 = *reinterpret_cast<const float2*>(ils + 8 * n + 2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qs + 8 * n + 2 * tq + (e & 1), kj = key0 + g + 8 * (e >> 1);
        const bool ok = all || valid(qi, kj, sq, sk, causal, window);
        const float mi = (e & 1) ? m2.y : m2.x, il = (e & 1) ? il2.y : il2.x;
        const float di = (e & 1) ? d2.y : d2.x;
        const float p = ok ? ex2(s[n][e] * c - mi) * il : 0.f;
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
// on stream s.  Scratch: stats, 3 x n_bh x ceil(sq / 64) * 64 float32 (m,
// 1 / l, D), written by the first and read by the second; with q_per_kv > 1,
// parts, n_bh x 2 x ceil(sk / 64) * 64 x d float32 (each head's dk and dv),
// and tickets, n_bh / q_per_kv x ceil(sk / 32) int32, zero.  sq, sk >= 1.
template <typename Dq, typename Dkv, int KEYS, typename E>
int launch_pair(void (*dq_kernel)(const E*, const E*, const E*, const E*, E*, float*, int, int,
                                  int, int, int, int, float, int),
                void (*dkv_kernel)(const E*, const E*, const E*, const E*, E*, E*,
                                   const float*, float*, int*, int, int, int, int, int, int,
                                   float, int),
                bool& dq_done, bool& dkv_done, const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv, void* stats, void* parts,
                void* tickets, long long n_bh, int sq, int sk, int q_per_kv, int causal,
                int window, float scale, cudaStream_t s) {
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
      qe, ke, ve, de, static_cast<E*>(dq), static_cast<float*>(stats), (int)n_bh, sq, sk,
      q_per_kv, causal, window, scale, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<(unsigned)grid_dkv, Dkv::kThreads, Dkv::kSmemBytes, s>>>(
      qe, ke, ve, de, static_cast<E*>(dk), static_cast<E*>(dv),
      static_cast<const float*>(stats), static_cast<float*>(parts), static_cast<int*>(tickets),
      (int)n_bh, sq, sk, q_per_kv, causal, window, scale, n_qt);
  return (int)cudaGetLastError();
}

// BF16: the tensor-core route (bf16 mma.sync); else the TF32 one (3xTF32)
template <int D, bool BF16>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, void* stats, void* parts, void* tickets, long long n_bh, int sq, int sk,
           int q_per_kv, int causal, int window, float scale, cudaStream_t s) {
  static bool dq_done = false, dkv_done = false;   // per instantiation, once per process
  if constexpr (BF16)
    return launch_pair<Bf16Dq<D>, Bf16Dkv<D>, kRows>(
        fa_bwd_dq_kernel<D>, fa_bwd_dkv_kernel<D>, dq_done, dkv_done, q, k, v, dout, dq, dk,
        dv, stats, parts, tickets, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
  else
    return launch_pair<F32Dq<D>, F32Dkv<D>, F32Dkv<D>::kKeys>(
        fa_bwd_tf32x3_dq_kernel<D>, fa_bwd_tf32x3_dkv_kernel<D>, dq_done, dkv_done, q, k, v,
        dout, dq, dk, dv, stats, parts, tickets, n_bh, sq, sk, q_per_kv, causal, window, scale,
        s);
}

}  // namespace fa_bwd
