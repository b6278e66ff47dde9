// flash_attention's float32 route, at every head dim (16, 32, 64, 80, 112,
// 128, 256): the TF32 tensor cores through warp-level mma.sync (m16n8k8),
// each product split three ways (3xTF32) so that the result keeps float32
// accuracy, for sm_90a.
//
// The same function as the CUDA-core kernel in flash_attention.cu (which
// replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py,
// _kernel / flash_attention_pallas):
//   o[bh, i] = sum_j p_ij v[bh / q_per_kv, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = scale * q[bh, i] . k[bh / q_per_kv, j]
// over the keys j the causal / window mask lets through, running max, sum and
// accumulator in float32, float32 in and out, a row with no valid key 0.
//
// Bound: operations.  At the qwen2-0.5b prefill (B=4, H=14, KVH=2, S=4096,
// d=64, causal) the function's products are 2*B*H*S^2*d = 120.3 GFLOP; q, k,
// v and the output are 134 MB (0.040 ms at 3.35 TB/s).  On the CUDA cores
// (67 TFLOP/s) that work takes at least 1.795 ms.  The TF32 tensor cores
// (495 TFLOP/s dense) are 7x faster, but a TF32 operand keeps 10 mantissa
// bits, and the route is held to the plain version at 2e-5: one TF32 product
// misses that by far (tests/test_torch_flash_tf32x3.py emulates both).  So
// every operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (the difference is exact in float32), and each product is
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in one float32 accumulator; only a_lo.b_lo
// is dropped, about 2^-22 of the product.  Three products bound the route at
// 3 x 120.3 GFLOP / 495 TFLOP/s = 0.729 ms.  Rounding is to nearest
// (cvt.rna): the mma itself truncates the 13 low bits, which would bias every
// product the same way.
//
// Shape of the kernel (FlashAttention-2's, on Ampere-style warp mma):
//   * one block of 4 warps per (bh, 64-query tile), heaviest causal tiles
//     first; each warp owns 16 query rows, the m16 of the mma;
//   * Q is staged once in shared memory; K and V tiles (64 keys at d <= 64,
//     32 at d = 80, 112 and 128, 8 at d = 256, where Q alone takes 66,560
//     bytes: 32-key tiles left one block of 4 warps an SM, 6.38 ms against
//     4.67 at 8 keys and two blocks, PERF.md) go through a ring of 2 stages
//     filled by 16-byte cp.async
//     (tile t+1 is in flight while tile t is multiplied).  Rows past sq or sk
//     are zero-filled by the copy; KV tiles that the causal mask or the
//     window hides from every row of the query tile are never loaded;
//   * rows are padded against bank conflicts: Q and K rows hold d + 4 floats,
//     so the A fragment (row g, column t) and K's B fragment (key g, column t)
//     fall on 32 banks; V rows hold d + 8, for its B fragment (key t, column
//     g).  At every d here (d + 4) mod 32 is 4 or 20 and (d + 8) mod 32 is 8
//     or 24, so both layouts hold;
//   * each value is split into hi and lo as it is loaded into a fragment, not
//     when it is staged, which would double the ring; the raw values of the
//     next k step are loaded while the current one is split and multiplied;
//   * S = Q.K^T: d/8 x BK/8 x 3 mma a warp; scale and mask on the accumulator;
//   * online softmax on the accumulator fragment: a row lives in the 4 threads
//     of a quad, its max and sum go across them by xor shuffles (every lane
//     gets the same bits), expf, the accumulator rescaled when the max moves;
//     only tiles that cross the diagonal, the window edge, sq or sk for some
//     row of the warp are masked;
//   * P.V: the accumulator holds row g at columns 2t, 2t+1, the A fragment
//     wants row g at columns t, t+4; so P goes through a per-warp 16 x (BK+4)
//     shared tile (written from the accumulator, __syncwarp, read as A);
//   * the mma adds into its accumulator rounding toward zero, so a long sum
//     in one accumulator drifts toward zero.  S sums only d products, but
//     O would take 3 x S/8 truncating adds a row; so each KV tile's P.V
//     goes into a fresh accumulator, 64 output columns (8 column blocks) at a
//     time and the d mod 64 left in one last pass (d 80: 8 + 2 blocks, 112:
//     8 + 6, 16: 2, 32: 4; d 256 in 8 passes of 4 blocks, to keep it in
//     registers), and is added to O by one rounded fma (O = alpha
//     O + P.V), which also does the online softmax's rescaling.  S takes
//     3 x d/8 truncating adds in one accumulator up to d = 128 (48 adds);
//     at d = 256 (96) it is summed 64 columns of d at a time in fresh
//     accumulators joined by rounded adds: in the truncating emulation of
//     tests/test_torch_flash_tf32x3.py one accumulator came to 0.83 of the
//     float32 check there, the 64-column ones to 0.27;
//   * element offsets are 64-bit.
//
// Shared memory (Tile<D>::kSmemBytes): d = 16, 45,056 bytes; 32, 65,536; 64,
// 106,496 (Q 17,408, the ring 71,680, P 17,408); 80, 74,752; 112, 99,328;
// 128, 111,616 (Q 33,792, the ring 68,608, P 9,216); 256, 103,168 (Q 66,560,
// the ring 33,536, P 3,072).  Two blocks fit an SM's 228 KB at every d (three
// at 16 and 32).  Registers: the O accumulator is d/2 floats a thread (128
// at d = 256), a tile's P.V 32 (16 at d = 256), S BK/2.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace fa_tf32x3 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 a warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Tile {
  // keys per KV tile: at d = 256, 8, so that two blocks fit an SM (Q alone
  // takes 66,560 bytes; with 32-key tiles one block of 4 warps held an SM)
  static constexpr int BK = D <= 64 ? 64 : D <= 128 ? 32 : 8;
  static constexpr int QSTR = D + 4, KSTR = D + 4, VSTR = D + 8, PSTR = BK + 4;
  static constexpr int Q_FLOATS = kBQ * QSTR;
  static constexpr int K_FLOATS = BK * KSTR;
  static constexpr int STAGE_FLOATS = K_FLOATS + BK * VSTR;
  static constexpr int P_FLOATS = kWarps * 16 * PSTR;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)Q_FLOATS + 2 * (size_t)STAGE_FLOATS + P_FLOATS);
};

// x rounded to TF32, to nearest with ties away from zero, as a .b32 operand;
// the 13 low bits are cleared, so the value is the one the mma multiplies
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo + O(2^-22 x).  lo is rounded by the same rule in one integer
// add (the mma ignores the 13 low bits): x - hi is finite wherever x is, and
// where x is not, hi carries the infinity or NaN into the product.  cvt.rna
// itself is three instructions (add, a compare with infinity, a select).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) + 0x1000u;
}

// c += a.b, a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b at float32 accuracy: the two small products first, then the big one
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(c, a_lo, b_hi);
  mma(c, a_hi, b_lo);
  mma(c, a_hi, b_hi);
}

// The raw values of one k step's fragments.  A: a0 (row g, col t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of a row-major shared tile of
// stride ASTR, `a` pointing at (g, t).  B (k x n, "col"): b0 (k = t, n = g),
// b1 (t + 4, g) of the N column blocks, `b` pointing at that element of
// block 0, column blocks SN floats apart and k steps SK floats apart.
template <int N, int ASTR, int SN, int SK>
__device__ __forceinline__ void load_step(const float* a, const float* b, int kk,
                                          float (&ar)[4], float (&br)[N][2]) {
  ar[0] = a[kk];
  ar[1] = a[8 * ASTR + kk];
  ar[2] = a[kk + 4];
  ar[3] = a[8 * ASTR + kk + 4];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    br[n][0] = b[n * SN + kk * SK];
    br[n][1] = b[n * SN + (kk + 4) * SK];
  }
}

// acc[n] += A (16 x K) . B (K x 8, column block n), n < N, at float32
// accuracy.  The raw values of step kk + 8 are loaded while step kk is split
// and multiplied; the loop is not unrolled, so that ptxas does not hoist a
// whole tile's fragments (fully unrolled, both head dims hit 255 registers
// and spilled).
template <int N, int K, int ASTR, int SN, int SK>
__device__ __forceinline__ void mma_rows(float (&acc)[N][4], const float* a, const float* b) {
  float ar[4], br[N][2];
  load_step<N, ASTR, SN, SK>(a, b, 0, ar, br);
#pragma unroll 1
  for (int kk = 0; kk < K; kk += 8) {
    uint32_t a_hi[4], a_lo[4], b_hi[N][2], b_lo[N][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(ar[e], a_hi[e], a_lo[e]);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      split(br[n][0], b_hi[n][0], b_lo[n][0]);
      split(br[n][1], b_hi[n][1], b_lo[n][1]);
    }
    load_step<N, ASTR, SN, SK>(a, b, min(kk + 8, K - 8), ar, br);
#pragma unroll
    for (int n = 0; n < N; ++n) mma3(acc[n], a_hi, a_lo, b_hi[n], b_lo[n]);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in_range) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in_range ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [r0, r0 + ROWS) of an (n, D) row-major float32 matrix into shared rows
// of STR floats, 16 bytes a copy; rows at or past n are zero-filled
template <int D, int ROWS, int STR>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n,
                                           int tid) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % kThreads == 0, "a whole number of copies a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int e = tid + i * kThreads, r = e / kChunks, c = (e % kChunks) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * STR + c, ok ? src + (long long)(r0 + r) * D + c : src, ok);
  }
}

// The online softmax on a warp's S fragment, s[n][2r + j] being row
// row0 + 8r, key k0 + 8n + 2t + j: scale and (MASK) mask it, turn it into P
// in place, move each row's max m and sum l, and give the factor alpha by
// which the row's O is rescaled.  A row's max and sum go across the 4
// threads of its quad by xor shuffles, so every lane gets the same bits.
template <int NS, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int row0, int k0, int tq,
                                             int sq, int sk, int causal, int window,
                                             float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row0 + 8 * r;
    bool ok[NS][2];
    float rmax = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + n * 8 + 2 * tq + j;
        ok[n][j] = !MASK || (kp < sk && qr < sq && (!causal || kp <= qr) &&
                             (window < 0 || kp >= qr - window));
        float& x = s[n][2 * r + j];
        x = ok[n][j] ? x * scale : kNegInf;
        rmax = fmaxf(rmax, x);
      }
    rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, 1));
    rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, 2));
    const float m_new = fmaxf(m[r], rmax);
    alpha[r] = expf(m[r] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& x = s[n][2 * r + j];
        x = ok[n][j] ? expf(x - m_new) : 0.f;
        rsum += x;
      }
    rsum += __shfl_xor_sync(kFull, rsum, 1);
    rsum += __shfl_xor_sync(kFull, rsum, 2);
    l[r] = l[r] * alpha[r] + rsum;
    m[r] = m_new;
  }
}

// O = alpha O + P.V on the N column blocks c0, c0 + 1, ..: the tile's
// products go into a fresh accumulator, added to O by one rounded fma.  B
// fragment b0 (k = t, n = g) is V[key t][col 8n + g], b1 key t + 4.
template <int N, int BK, int PSTR, int VSTR, int NO>
__device__ __forceinline__ void pv_pass(float (&o)[NO][4], int c0, const float (&alpha)[2],
                                        const float* p, const float* v) {
  float acc[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  mma_rows<N, BK, PSTR, 8, VSTR>(acc, p, v + c0 * 8);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c0 + n][e] = fmaf(o[c0 + n][e], alpha[e >> 1], acc[n][e]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out,
                              float* __restrict__ lse, long long n_bh, int sq, int sk,
                              int q_per_kv, int causal,
                              int window, float scale, int n_qt) {
  using T = Tile<D>;
  constexpr int BK = T::BK, NS = BK / 8, NO = D / 8;
  // output column blocks of one P.V pass: 8 (64 columns); 4 at d = 256,
  // where the O accumulator takes 128 registers a thread (passes of 8
  // spilled 400 bytes in a build with 32-key tiles)
  constexpr int NC = D <= 128 ? 8 : 4;
  static_assert(D % 16 == 0, "d a multiple of 16");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][QSTR]
  float* ring = Qs + T::Q_FLOATS;                // 2 x ([BK][KSTR] K, [BK][VSTR] V)
  float* Ps = ring + 2 * T::STAGE_FLOATS;        // kWarps x [16][PSTR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;        // the fragments' row group and column
  // the head: 64-bit up to d = 128; an int at d = 256 (the grid holds
  // under 2^31 blocks), where a 64-bit one kept bh * sq live across the
  // loop and ptxas spilled it (as an int at d = 64 the kernel ran 2.5 %
  // slower, PERF.md)
  using Head = std::conditional_t<(D <= 128), long long, int>;
  const Head bh = (Head)((long long)blockIdx.x % n_bh);
  const int q0 = (n_qt - 1 - (int)((long long)blockIdx.x / n_bh)) * kBQ;
  const Head kv = bh / q_per_kv;
  const float* qb = q + (long long)bh * sq * D;
  const float* kb = k + (long long)kv * sk * D;
  const float* vb = v + (long long)kv * sk * D;

  // the KV tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window >= 0 ? max(0, q0 - window) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  const int row0 = q0 + warp * 16 + g;           // this thread's rows: row0, row0 + 8
  const float* Qw = Qs + warp * 16 * T::QSTR;
  float* Pw = Ps + warp * 16 * T::PSTR;

  float o[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (t_begin < t_end) {
    stage_rows<D, kBQ, T::QSTR>(Qs, qb, q0, sq, tid);
    stage_rows<D, BK, T::KSTR>(ring, kb, t_begin * BK, sk, tid);
    stage_rows<D, BK, T::VSTR>(ring + T::K_FLOATS, vb, t_begin * BK, sk, tid);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const float* Ks = ring + ((t - t_begin) & 1) * T::STAGE_FLOATS;
    const float* Vs = Ks + T::K_FLOATS;
    if (t + 1 < t_end) {               // that stage's readers passed the last barrier
      float* next = ring + ((t + 1 - t_begin) & 1) * T::STAGE_FLOATS;
      stage_rows<D, BK, T::KSTR>(next, kb, k0 + BK, sk, tid);
      stage_rows<D, BK, T::VSTR>(next + T::K_FLOATS, vb, k0 + BK, sk, tid);
    }
    cp_async_commit();                 // (an empty group on the last tile)
    cp_async_wait_1();                 // this thread's copies of tile t landed
    __syncthreads();                   // and everyone's

    // S = Q.K^T: B fragment b0 (k = t, n = g) is K[key 8n + g][col t], b1 col t + 4
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (D <= 128) {
      mma_rows<NS, D, T::QSTR, 8 * T::KSTR, 1>(s, Qw + g * T::QSTR + tq,
                                                Ks + g * T::KSTR + tq);
    } else {
      // 64 columns of d at a time, each in a fresh accumulator added to S
      // by rounded adds, so that no accumulator takes more than 24
      // truncating adds
      mma_rows<NS, 64, T::QSTR, 8 * T::KSTR, 1>(s, Qw + g * T::QSTR + tq,
                                                 Ks + g * T::KSTR + tq);
#pragma unroll 1
      for (int c0 = 64; c0 < D; c0 += 64) {
        float part[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
        mma_rows<NS, 64, T::QSTR, 8 * T::KSTR, 1>(part, Qw + g * T::QSTR + tq + c0,
                                                   Ks + g * T::KSTR + tq + c0);
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
      }
    }

    // only tiles that cross the diagonal, the window edge, sq or sk for some
    // row of this warp are masked
    const int r_last = q0 + warp * 16 + 15;
    const bool whole = k0 + BK <= sk && r_last < sq &&
                       (!causal || k0 + BK - 1 <= r_last - 15) &&
                       (window < 0 || k0 >= r_last - window);
    float alpha[2];
    if (whole)
      softmax_tile<NS, false>(s, m, l, alpha, row0, k0, tq, sq, sk, causal, window, scale);
    else
      softmax_tile<NS, true>(s, m, l, alpha, row0, k0, tq, sq, sk, causal, window, scale);

    // P from the accumulator layout (row g, columns 2t, 2t+1) to the A layout
    // (row g, columns t, t+4), through the warp's own shared tile
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      *reinterpret_cast<float2*>(&Pw[g * T::PSTR + n * 8 + 2 * tq]) =
          make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(&Pw[(g + 8) * T::PSTR + n * 8 + 2 * tq]) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncwarp();

    // O = alpha O + P.V, NC column blocks at a time, then the rest.  The
    // tile's P.V goes into a fresh accumulator, added to O by one rounded
    // fma: the mma truncates its sum toward zero, and 3 x 512 truncating
    // adds into O itself over a 4,096-key row biased the output by more
    // than the tolerance (PERF.md).
    const float* pa = Pw + g * T::PSTR + tq;
    const float* vb0 = Vs + tq * T::VSTR + g;
#pragma unroll
    for (int c0 = 0; c0 + NC <= NO; c0 += NC)
      pv_pass<NC, BK, T::PSTR, T::VSTR>(o, c0, alpha, pa, vb0);
    if constexpr (NO % NC != 0)
      pv_pass<NO % NC, BK, T::PSTR, T::VSTR>(o, NO - NO % NC, alpha, pa, vb0);
    __syncthreads();                   // every warp is done with this stage and its P
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row0 + 8 * r;
    if (qr >= sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    // for the backward (FlashAttentionFn), when given: the row's log-sum-exp
    // in log2 units, m log2 e + log2 l (+inf for a row with no valid key)
    if (lse != nullptr && tq == 0)
      lse[(long long)bh * sq + qr] = l[r] > 0.f ? m[r] * 1.4426950408889634f + log2f(l[r]) : INFINITY;
    float* orow = out + ((long long)bh * sq + qr) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * tq) =
          make_float2(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <int D>
cudaError_t opt_in() {
  static bool done = false;            // per instantiation, once per process
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile<D>::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_tf32x3_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, long long n_bh,
           int sq, int sk, int q_per_kv, int causal, int window, float scale, cudaStream_t s) {
  const cudaError_t err = opt_in<D>();
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long grid = (long long)n_qt * n_bh;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_tf32x3_kernel<D><<<(unsigned)grid, kThreads, Tile<D>::kSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), n_bh,
      sq, sk, q_per_kv, causal, window, scale, n_qt);
  return (int)cudaGetLastError();
}

// resident blocks an SM (the occupancy the shared memory and registers allow)
template <int D>
int blocks_per_sm() {
  cudaError_t err = opt_in<D>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_attention_tf32x3_kernel<D>, kThreads, Tile<D>::kSmemBytes);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace fa_tf32x3
