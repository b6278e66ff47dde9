// flash_attention's float32 route, at every head dim (16, 32, 64, 80, 112,
// 128, 256): the TF32 tensor cores, each product split three ways (3xTF32)
// so that the result keeps float32 accuracy, for sm_90a.  At d 16 to 128 on
// Hopper's wgmma fed by TMA (the wgmma body); at d 256 on warp-level
// mma.sync (m16n8k8) fed by cp.async (the mma.sync body: there Q's hi and lo
// planes alone would take 128 KB at 64 rows, and its O and P.V accumulators
// 128 registers each a thread).
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
// 3 x 120.3 GFLOP / 495 TFLOP/s = 0.729 ms.  Rounding is to nearest, ties
// away (cvt.rna's rule): the tensor core reads an operand's top 19 bits, and
// truncating every operand would bias every product the same way.
//
// The wgmma body replaces a FlashAttention-2-shaped mma.sync kernel (the
// d-256 body's shape) in which each of 4 warps split the whole K and V tile
// again as it loaded its fragments, and every warp its Q fragments again at
// every KV tile: issue-bound, 2.899 ms at the qwen2-0.5b shape, 25 % of the
// bound (PERF.md row 5c).  Its shape:
//   * a block per (bh, 128 query rows), heaviest causal tiles first: a
//     producer warpgroup and two consumer warpgroups of 64 rows each;
//     setmaxnreg gives a consumer thread 216 registers and a producer thread
//     72 (168 each at launch);
//   * the producer's first thread issues TMA loads of raw float32 tiles
//     through 3-D maps (rows, s, d) in panels of 32 floats (128 bytes,
//     128-byte swizzled): a box past s is zero-filled and never reads the
//     next head, and at d 16, 80 and 112 the last panel's columns past d are
//     zeros that no product reads.  Q once a block; K and V tiles of BK keys
//     (128 at d 16, 64 at 32 and 64, 32 above) through 2 raw stages (1 above
//     d 80); KV tiles that the causal mask or the window hides from every row
//     of the block are never loaded;
//   * split once, into shared planes, by all 128 producer threads: each raw
//     K and V tile is read once and written as hi and lo planes laid out for
//     wgmma's descriptors, into one of two plane sets, so that tile t + 1 is
//     split while tile t is multiplied.  A TF32 wgmma takes its shared
//     operands K-major only (no transpose for 32-bit types): K keeps its
//     rows, and V is written transposed, d rows of BK keys (V^T hi and lo),
//     the pass that reads V doing the transpose.  Each plane set has a
//     ready and a done mbarrier for K and for V^T: K of tile t + 2 is split
//     once both warpgroups' S products of tile t are done, V^T once their
//     P.V products are.  Q is split once a block by the consumer threads,
//     each into the registers of its own A fragments (Q_lo above d 80 into
//     a shared plane in place of the raw tile);
//   * S = Q.K^T: for each k step of 8, three wgmma m64nBKk8 (lo.hi, hi.lo,
//     hi.hi), Q from registers (Q_lo from its plane above d 80), K's hi and
//     lo planes as B, into one float32 accumulator.  Mask (only tiles that
//     cross the diagonal, the window edge or sk) and the online softmax act
//     on the fragment in log2 units, the scale folded into the exponent's
//     fma (ex2.approx);
//   * P.V with P in registers: the accumulator holds row g at keys 2t and
//     2t + 1 of each 8-key group, the .tf32 A fragment of m64nNk8 wants row g
//     at k t and t + 4; the split writes V^T with the keys permuted inside
//     each group of 8 (key 2t to slot t, key 2t + 1 to slot t + 4), so the
//     accumulator is P's A fragment as it stands.  p is split into P_hi (in
//     place) and P_lo in registers, and three wgmma m64nNk8 a group of 8
//     keys go into a fresh accumulator for the tile (scale-d 0 on its first
//     product; above d 80 in two halves of d / 2 columns, for registers),
//     added to O by one rounded fma (O = alpha O + P.V): the tensor core adds
//     into its accumulator rounding toward zero, and 3 x S/8 truncating adds
//     into O itself over a 4,096-key row biased the output by more than the
//     tolerance;
//   * nothing between a wgmma's issue and its wait branches or waits on a
//     barrier: where something did, ptxas serialized every wgmma (its C7518
//     report).  A tile that the mask hides from all of one warpgroup's rows
//     is computed all the same (its p is 0).
// Shared memory (Hop<D>::kAlloc: raw Q, the raw stages, two plane sets, 1 KB
// of alignment): d 16, 181,336 bytes; 32, 115,800; 64, 230,488; 80,
// 189,528; 112, 222,288; 128, 230,480: one block an SM.  Registers a
// consumer thread: O D/2, the tile's P.V D/2 (D/4 above d 80), S (P_hi in
// place) and P_lo BK/2 each, Q's fragments D/4 (D/8 above d 80).
//
// The mma.sync body (d 256): FlashAttention-2's shape on Ampere-style warp
// mma, 4 warps of 16 query rows, K / V tiles of 8 keys through a 2-stage
// cp.async ring, each value split as it is loaded into a fragment, P through
// a per-warp shared tile, each KV tile's P.V in a fresh accumulator (8
// passes of 4 column blocks), S summed 64 columns of d at a time in fresh
// accumulators joined by rounded adds (in the truncating emulation of
// tests/test_torch_flash_tf32x3.py one accumulator came to 0.83 of the
// float32 check at d 256, the 64-column ones to 0.27); Q and K rows padded
// to d + 4 floats, V's to d + 8, against bank conflicts; 103,168 bytes of
// shared memory, two blocks an SM.  Its helpers are also the float32
// backward's products (flash_attention_bwd.cuh).
//
// Measured (chip_smoke.flash_parent_in_turns, this build in turns with the
// mma.sync kernel it replaced, causal S 4,096, no lse; NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md rows 5b and 5c): qwen2-0.5b's shape (d 64) 1.016
// ms against 2.889-2.901 (0.35x; 72 % of the 0.729 ms bound);
// internlm2-1.8b's (B 2, H 16, KVH 8, d 128) 1.250-1.256 against
// 3.442-3.456 (66 % of 0.833); zamba2-2.7b's (B 4, H 32, d 80) 3.288-3.293
// against 9.586-9.619 (63 % of 2.082); kimi-k2's (B 2, H 64, KVH 8, d 112)
// 4.444-4.452 against 12.19-12.21 (65 % of 2.915); qwen2-0.5b's heads at d
// 32 0.682-0.683 against 1.643-1.646 (53 % of 0.364), at d 16 0.533 against
// 1.126 (34 % of 0.182: its softmax and splits, not its products, take the
// time).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_wgmma.cuh"

namespace fa_tf32x3 {

namespace fw = fa_wgmma;

// ------------------------------------------------- the mma.sync body (d 256)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block, 16 a warp
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Tile {
  static_assert(D == 256, "the mma.sync body runs at d 256");
  // keys per KV tile: 8, so that two blocks fit an SM (Q alone takes 66,560
  // bytes; with 32-key tiles one block of 4 warps held an SM)
  static constexpr int BK = 8;
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

// The d-256 body: one block of 4 warps per (bh, 64-query tile).
template <int D>
__device__ __forceinline__ void mma_body(float* Qs, const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v, float* __restrict__ out,
                                         float* __restrict__ lse, long long n_bh, int sq,
                                         int sk, int q_per_kv, int causal, int window,
                                         float scale, int n_qt) {
  using T = Tile<D>;
  constexpr int BK = T::BK, NS = BK / 8, NO = D / 8;
  // output column blocks of one P.V pass: 4, where the O accumulator takes
  // 128 registers a thread (passes of 8 spilled 400 bytes in a build with
  // 32-key tiles)
  constexpr int NC = 4;
  float* ring = Qs + T::Q_FLOATS;                // 2 x ([BK][KSTR] K, [BK][VSTR] V)
  float* Ps = ring + 2 * T::STAGE_FLOATS;        // kWarps x [16][PSTR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;        // the fragments' row group and column
  // the head as an int (the grid holds under 2^31 blocks): a 64-bit one
  // kept bh * sq live across the loop and ptxas spilled it
  const int bh = (int)((long long)blockIdx.x % n_bh);
  const int q0 = (n_qt - 1 - (int)((long long)blockIdx.x / n_bh)) * kBQ;
  const int kv = bh / q_per_kv;
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
    // 64 columns of d at a time, each in a fresh accumulator added to S by
    // rounded adds, so that no accumulator takes more than 24 truncating adds
    mma_rows<NS, 64, T::QSTR, 8 * T::KSTR, 1>(s, Qw + g * T::QSTR + tq, Ks + g * T::KSTR + tq);
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

// ------------------------------------------------- the wgmma body (d <= 128)
template <int D>
struct Hop {                       // byte offsets from a 1024-aligned base
  static_assert(D % 16 == 0 && D <= 128, "the wgmma body: d a multiple of 16, at most 128");
  static constexpr int kConsumers = 256;              // two warpgroups of 64 query rows
  static constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
  static constexpr int kBQ = 128;                     // query rows a block
  static constexpr int kBK = D <= 16 ? 128 : D <= 64 ? 64 : 32;   // keys a KV tile
  // Q's split A fragments live in registers, Q_lo's up to d 80 only: above,
  // where O takes 56 or 64 registers, Q_lo is a shared plane in place of the
  // raw tile, and each tile's P.V goes into its fresh accumulator in two
  // column halves
  static constexpr bool kQLoRegs = D <= 80;
  static constexpr int kPVParts = D <= 80 ? 1 : 2;
  static constexpr int kStages = D <= 80 ? 2 : 1;     // raw K / V stages
  static constexpr int kPanels = (D + 31) / 32;       // 32-float (128-byte) panels a row
  static constexpr int kQPlane = kBQ * kPanels * 128;  // raw Q (above d 80 then Q lo)
  static constexpr int kKPlane = kBK * kPanels * 128;  // a raw K or V tile, K hi or K lo
  static constexpr int kVPlane = D * kBK * 4;          // V^T hi or lo: D rows of kBK keys
  static constexpr int kSet = 2 * kKPlane + 2 * kVPlane;   // K hi, K lo, V^T hi, V^T lo
  static constexpr int kQ = 0;
  static constexpr int kRaw = kQPlane;                // stage s: K at + 2 s kKPlane, V after
  static constexpr int kSets = kRaw + 2 * kStages * kKPlane;   // two plane sets
  // mbarriers: raw[kStages] (TMA bytes), q (TMA bytes), then for each plane
  // set k_ready, v_ready (its K / V^T planes written) and k_done, v_done
  // (their products finished)
  static constexpr int kBar = kSets + 2 * kSet;
  static constexpr int kAlloc = kBar + 8 * (kStages + 9) + 1024;
  static_assert(kAlloc <= 232448, "a block's shared memory");
};

// x = hi + lo + O(2^-22 x) as above, both parts TF32 values (13 low bits
// clear: a wgmma operand is read as the TF32 value it holds), each rounded
// to nearest with ties away from zero (cvt.rna.tf32.f32's rule, wherever x
// is finite) by an integer add on its bits: two instructions where cvt.rna
// and the clearing took four
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__fsub_rn(x, __uint_as_float(hi))) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// the byte offset of row r, floats 4 c4 .. 4 c4 + 3 in a plane of `rows` rows
// of 128-byte-swizzled 32-float panels (the layout TMA's 128-byte swizzle
// writes and the wgmma descriptors read: the 16-byte chunk c of row r at
// chunk c ^ (r mod 8))
__device__ __forceinline__ int swz(int rows, int r, int c4) {
  return (c4 / 8) * rows * 128 + r * 128 + (((c4 % 8) ^ (r % 8)) * 16);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` over n threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// 16 bytes of shared memory at a 32-bit shared address
__device__ __forceinline__ float4 lds128(uint32_t at) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w) : "r"(at));
  return x;
}

__device__ __forceinline__ void sts128(uint32_t at, const uint4& x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
               ::"r"(at), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w) : "memory");
}

// Raw K tile `it` (raw stage it mod kStages) split into plane set it
// mod 2 by the producer warpgroup's 128 threads (pt its thread), at
// 32-bit shared addresses from base.  Each thread issues a batch's loads
// before any of its stores (in a loop of load, split, store each load
// waited for the stores before it: K's split took 1.7 times as long).  K
// keeps its layout (hi and lo at the raw value's offset), 4 16-byte chunks
// a batch; a thread past the last chunk repeats it, storing the same values.
template <int D>
__device__ __forceinline__ void split_k(uint32_t base, int it, int pt) {
  using H = Hop<D>;
  constexpr int BK = H::kBK, C4 = D / 4, NK = BK * C4, NB = 4;
  const uint32_t rk = base + H::kRaw + (it % H::kStages) * 2 * H::kKPlane;
  const uint32_t kh = base + H::kSets + (it % 2) * H::kSet, kl = kh + H::kKPlane;
#pragma unroll
  for (int i0 = 0; i0 < (NK + 127) / 128; i0 += NB) {
    int off[NB];
    float4 x[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int u = min(pt + (i0 + i) * 128, NK - 1);
      off[i] = swz(BK, u / C4, u % C4);
      if (i0 + i < (NK + 127) / 128) x[i] = lds128(rk + off[i]);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i0 + i >= (NK + 127) / 128) continue;
      uint4 hi, lo;
      split4(x[i], hi, lo);
      sts128(kh + off[i], hi);
      sts128(kl + off[i], lo);
    }
  }
}

// V is written transposed, V^T[c][slot], the keys of each group of 8
// permuted (key 2t at slot t, key 2t + 1 at slot t + 4) so that P's
// accumulator is its A fragment.  A thread's unit is the 4 keys of one
// parity in a group of 8 (they land in 4 neighbouring slots: 16-byte chunk
// g4 of a V^T row) by the 4 columns of chunk c4: 4 16-byte loads, 8 16-byte
// stores; a thread takes 1 or 2 units, all its loads first.
// The 8 threads of a 16-byte access phase take units whose loads and stores
// each fall on 8 distinct 16-byte bank groups of the swizzled rows: with t
// the thread's place in its 8 and s the phase in its warp, g4 = (t0 ^ s0) +
// 2 (t1 ^ s1) + 4 .. and c4 = t2 + 2 t1 + 4 t0 + 8 .. (a load's group is c4
// ^ (key mod 8), a store's g4 ^ (column mod 8)).  A unit past the last one
// repeats it (and columns past d the last column chunk), storing the same
// values.
template <int D>
__device__ __forceinline__ void split_v(uint32_t base, int it, int pt) {
  using H = Hop<D>;
  constexpr int BK = H::kBK, C4 = D / 4, C4P = H::kPanels * 8, NV = BK / 4 * C4P;
  constexpr int NU = (NV + 127) / 128;            // units a thread: 1 or 2
  static_assert(NU <= 2, "at most two V units a producer thread");
  const uint32_t rv = base + H::kRaw + (it % H::kStages) * 2 * H::kKPlane + H::kKPlane;
  const uint32_t vh = base + H::kSets + (it % 2) * H::kSet + 2 * H::kKPlane;
  const uint32_t vl = vh + H::kVPlane;
  int g4[NU], c4[NU];
  float4 x[NU][4];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int u = min(pt + i * 128, NV - 1);
    const int t = u % 8, s = (u / 8) % 4, h = u / 32;
    g4[i] = ((t ^ s) & 1) + 2 * (((t >> 1) ^ (s >> 1)) & 1) + 4 * (h % (BK / 16));
    c4[i] = min(((t >> 2) & 1) + 2 * ((t >> 1) & 1) + 4 * (t & 1) + 8 * (h / (BK / 16)), C4 - 1);
    const int j0 = 8 * (g4[i] / 2) + g4[i] % 2;   // keys j0, j0 + 2, j0 + 4, j0 + 6
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = lds128(rv + swz(BK, j0 + 2 * e, c4[i]));
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    // their slots: 4 g4 .. 4 g4 + 3, the 16-byte chunk g4 of rows 4 c4 ..
    const float4 cols[4] = {make_float4(x[i][0].x, x[i][1].x, x[i][2].x, x[i][3].x),
                            make_float4(x[i][0].y, x[i][1].y, x[i][2].y, x[i][3].y),
                            make_float4(x[i][0].z, x[i][1].z, x[i][2].z, x[i][3].z),
                            make_float4(x[i][0].w, x[i][1].w, x[i][2].w, x[i][3].w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = swz(D, 4 * c4[i] + e, g4[i]);
      uint4 hi, lo;
      split4(cols[e], hi, lo);
      sts128(vh + off, hi);
      sts128(vl + off, lo);
    }
  }
}

// d (64 x N, float32) (+)= A (64 x 8, K-major, shared) . B (N x 8, K-major,
// shared)^T, TF32 operands; acc = 0 ignores d (scale-d), N = 32
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int acc) {
  static_assert(N == 32, "wgmma_ss: N = 32");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8)
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

// d (64 x N, float32) (+)= A (64 x 8, TF32 in registers: row g at k t
// and t + 4, rows g and g + 8 of the warp's 16) . B (N x 8, K-major,
// shared)^T; acc = 0 ignores d, N = 16, 32, 56, 64, 80 or 128
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b, int acc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  } else if constexpr (N == 56) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
        "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8), FA_R8(FA_ACC, 16), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8), FA_R8(FA_ACC, 16), FA_R8(FA_ACC, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8), FA_R8(FA_ACC, 16), FA_R8(FA_ACC, 24), FA_R8(FA_ACC, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8), FA_R8(FA_ACC, 16), FA_R8(FA_ACC, 24), FA_R8(FA_ACC, 32), FA_R8(FA_ACC, 40), FA_R8(FA_ACC, 48), FA_R8(FA_ACC, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
  } else {
    static_assert(N == 16, "wgmma_rs: N in 16, 32, 56, 64, 80, 128");
  }
}

// The d <= 128 body (the notes at the top).
template <int D>
__device__ __forceinline__ void wgmma_body(uint8_t* smem_raw, const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           float* __restrict__ out, float* __restrict__ lse,
                                           int n_bh, int sq, int sk, int q_per_kv, int causal,
                                           int window, float scale, int n_qt) {
  using H = Hop<D>;
  constexpr int BK = H::kBK, R = H::kStages, PS = 2, SN = BK / 2, ON = D / 2;
  constexpr int PN = D / H::kPVParts;            // the columns of a P.V part
  constexpr float kInf = INFINITY;
  const uint32_t raw32 = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base32 = (raw32 + 1023u) & ~1023u;
  uint8_t* base = smem_raw + (base32 - raw32);
  const uint32_t bar_raw = base32 + H::kBar, bar_q = bar_raw + 8 * R;
  const uint32_t k_ready = bar_q + 8, v_ready = k_ready + 8 * PS;
  const uint32_t k_done = v_ready + 8 * PS, v_done = k_done + 8 * PS;

  const int blk = (int)blockIdx.x;
  const int bh = blk % n_bh;
  const int q0 = (n_qt - 1 - blk / n_bh) * H::kBQ;
  // the KV tiles some row of this query tile can see
  const int q_last = min(q0 + H::kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window >= 0 ? max(0, q0 - window) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) fw::mbar_init(bar_raw + 8 * s, 1);
    fw::mbar_init(bar_q, 1);
    for (int b = 0; b < PS; ++b) {
      fw::mbar_init(k_ready + 8 * b, 128);
      fw::mbar_init(v_ready + 8 * b, 128);
      fw::mbar_init(k_done + 8 * b, H::kConsumers);
      fw::mbar_init(v_done + 8 * b, H::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= H::kConsumers) {
    // ------------------------------------------------------- producer
    // One thread issues the TMA loads; all 128 split each raw tile into
    // plane set t mod 2: K once the consumers' S products of tile t - 2
    // are done, V^T once their P.V products are.  Registers: 216 a consumer
    // thread and 72 here, (216 - 168) x 256 = (168 - 72) x 128, 168 a thread
    // at launch.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;");
    const int pt = threadIdx.x - H::kConsumers;
    const int kv = bh / q_per_kv;
    const auto load_raw = [&](int it) {               // tile it into raw stage it mod R
      const uint32_t full = bar_raw + 8 * (it % R);
      fw::mbar_expect_tx(full, 2 * H::kKPlane);
      const int k0 = (t_begin + it) * BK;
      const uint32_t rk = base32 + H::kRaw + (it % R) * 2 * H::kKPlane;
      for (int p = 0; p < H::kPanels; ++p) {
        fw::tma_load_3d(rk + p * BK * 128, tm_k, full, p * 32, k0, kv);
        fw::tma_load_3d(rk + H::kKPlane + p * BK * 128, tm_v, full, p * 32, k0, kv);
      }
    };
    if (n_tiles > 0) {
      if (pt == 0) {
        fw::mbar_expect_tx(bar_q, H::kQPlane);
        for (int p = 0; p < H::kPanels; ++p)
          fw::tma_load_3d(base32 + H::kQ + p * H::kBQ * 128, tm_q, bar_q, p * 32, q0, bh);
        for (int it = 0; it < min(R, n_tiles); ++it) load_raw(it);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int b = it % PS, before = (it / PS - 1) & 1;
        fw::mbar_wait(bar_raw + 8 * (it % R), (it / R) & 1);
        if (it >= PS) fw::mbar_wait(k_done + 8 * b, before);
        split_k<D>(base32, it, pt);
        fence_proxy_async();
        fw::mbar_arrive(k_ready + 8 * b);
        if (it >= PS) fw::mbar_wait(v_done + 8 * b, before);
        split_v<D>(base32, it, pt);
        fence_proxy_async();
        fw::mbar_arrive(v_ready + 8 * b);
        bar_sync(1, 128);                                // every thread read raw stage it mod R
        if (pt == 0 && it + R < n_tiles) load_raw(it + R);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;");
    const int ct = threadIdx.x, wg = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32, t4 = lane % 4;
    const int r_first = q0 + wg * 64;                  // this warpgroup's rows
    const int row = r_first + warp * 16 + lane / 4;    // this thread's: row, row + 8
    const float scale_log2 = scale * 1.4426950408889634f;
    // accumulator fragment of an m64nN tile: element 4j + 2r + c is row
    // (row + 8r), column 8j + 2 t4 + c
    float o[ON], pv[PN / 2], s[SN];
    uint32_t p_lo[SN];
#pragma unroll
    for (int i = 0; i < ON; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < PN / 2; ++i) pv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < SN; ++i) s[i] = 0.f;
    // the running max (log2 units), this thread's part of the sum
    float m[2] = {-kInf, -kInf}, l[2] = {0.f, 0.f}, alpha[2];
    // Q's A fragments, split: k step ks holds (row g, k t), (g + 8, t), (g,
    // t + 4), (g + 8, t + 4) of the warp's 16 rows; Q_lo's above d 80 in
    // place of the raw values
    uint32_t q_hi[D / 8][4], q_lo[H::kQLoRegs ? D / 8 : 1][4];

    if (n_tiles > 0) {
      fw::mbar_wait(bar_q, 0);
      const int rq = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * ks + t4 + 4 * (e / 2);
          float* at = reinterpret_cast<float*>(base + H::kQ +
                                               swz(H::kBQ, rq + 8 * (e % 2), c / 4)) + c % 4;
          uint32_t lo;
          split_tf32(*at, q_hi[ks][e], lo);
          if constexpr (H::kQLoRegs)
            q_lo[ks][e] = lo;
          else
            *reinterpret_cast<uint32_t*>(at) = lo;
        }
      if constexpr (!H::kQLoRegs) {
        fence_proxy_async();
        bar_sync(2 + wg, 128);
      }
    }

    // Nothing between a product's issue and its wait branches or waits on a
    // barrier (a tile the mask hides from all of a warpgroup's rows is
    // computed all the same, its p 0): where something did, ptxas
    // serialized every wgmma (its C7518 report).
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = (t_begin + it) * BK, b = it % PS, phase = (it / PS) & 1;
      const uint32_t kh = base32 + H::kSets + b * H::kSet, kl = kh + H::kKPlane;
      const uint32_t vh = kl + H::kKPlane, vl = vh + H::kVPlane;
      // S = Q K^T: each k step of 8 as lo.hi, hi.lo, hi.hi (Q_lo from shared
      // memory above d 80)
      fw::mbar_wait(k_ready + 8 * b, phase);
      fw::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const int ko = (ks / 4) * BK * 128 + (ks % 4) * 32;
        if constexpr (H::kQLoRegs) {
          wgmma_rs<BK>(s, q_lo[ks], fw::sw128_desc(kh + ko), ks > 0);
        } else {
          const int qo = (ks / 4) * H::kBQ * 128 + wg * 64 * 128 + (ks % 4) * 32;
          wgmma_ss<BK>(s, fw::sw128_desc(base32 + H::kQ + qo), fw::sw128_desc(kh + ko), ks > 0);
        }
        wgmma_rs<BK>(s, q_hi[ks], fw::sw128_desc(kl + ko), 1);
        wgmma_rs<BK>(s, q_hi[ks], fw::sw128_desc(kh + ko), 1);
      }
      fw::wgmma_commit();
      fw::wgmma_wait<0>();
      fw::fence_regs(s);
      fw::mbar_arrive(k_done + 8 * b);               // this tile's K planes are free
      // mask (only tiles that cross the diagonal, the window edge or sk) and
      // the online softmax in log2 units, the scale in the exponent's fma; s
      // becomes p
      const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > r_first) ||
                          (window >= 0 && k0 < r_first + 63 - window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < SN; ++i) {
          const int kp = k0 + 8 * (i / 4) + 2 * t4 + (i % 2), qp = row + 8 * ((i / 2) % 2);
          const bool ok = kp < sk && (!causal || kp <= qp) && (window < 0 || kp >= qp - window);
          s[i] = ok ? s[i] : -kInf;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -kInf;
#pragma unroll
        for (int j = 0; j < SN / 4; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        const float sub = m_new == -kInf ? 0.f : m_new;   // a row with nothing valid yet
        alpha[r] = fw::ex2(m[r] - sub);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SN / 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = fw::ex2(fmaf(s[4 * j + 2 * r + c], scale_log2, -sub));
            s[4 * j + 2 * r + c] = p;
            sum += p;
          }
        l[r] = l[r] * alpha[r] + sum;
      }
      // p = P_hi (in place) + P_lo
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        uint32_t hi;
        split_tf32(s[i], hi, p_lo[i]);
        s[i] = __uint_as_float(hi);
      }
      // P.V into a fresh accumulator, PN columns at a time: A fragment {(g,
      // t), (g + 8, t), (g, t + 4), (g + 8, t + 4)} of key group j is
      // accumulator elements 4j, 4j + 2, 4j + 1, 4j + 3 (slots t, t + 4: keys
      // 2t, 2t + 1); O = alpha O + P.V by one rounded fma
      fw::mbar_wait(v_ready + 8 * b, phase);
#pragma unroll
      for (int part = 0; part < H::kPVParts; ++part) {
        fw::wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const uint32_t a_hi[4] = {__float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
                                    __float_as_uint(s[4 * j + 1]), __float_as_uint(s[4 * j + 3])};
          const uint32_t a_lo[4] = {p_lo[4 * j], p_lo[4 * j + 2], p_lo[4 * j + 1],
                                    p_lo[4 * j + 3]};
          const int vo = (j / 4) * D * 128 + part * PN * 128 + (j % 4) * 32;
          wgmma_rs<PN>(pv, a_lo, fw::sw128_desc(vh + vo), j > 0);
          wgmma_rs<PN>(pv, a_hi, fw::sw128_desc(vl + vo), 1);
          wgmma_rs<PN>(pv, a_hi, fw::sw128_desc(vh + vo), 1);
        }
        fw::wgmma_commit();
        fw::wgmma_wait<0>();
        fw::fence_regs(pv);
        if (part + 1 == H::kPVParts) fw::mbar_arrive(v_done + 8 * b);   // its V^T planes free
#pragma unroll
        for (int i = 0; i < PN / 2; ++i)
          o[part * PN / 2 + i] = fmaf(o[part * PN / 2 + i], alpha[(i / 2) % 2], pv[i]);
      }
    }

    // o / l; rows past sq are not stored.  For the backward
    // (FlashAttentionFn), when given: each row's log-sum-exp in log2 units,
    // m + log2 l (+inf for a row with no valid key)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(kFull, lr, 1);
      lr += __shfl_xor_sync(kFull, lr, 2);
      const int qp = row + 8 * r;
      if (qp >= sq) continue;
      const long long at = (long long)bh * sq + qp;
      if (lse != nullptr && t4 == 0) lse[at] = lr > 0.f ? m[r] + log2f(lr) : kInf;
      const float denom = lr == 0.f ? 1.f : lr;
      float* orow = out + at * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) =
            make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------- kernel
template <int D>
struct Launch {                    // the block and shared memory of head dim D's body
  static constexpr bool kWgmma = true;
  static constexpr int kThreads = Hop<D>::kThreads, kMinBlocks = 1, kBQ = Hop<D>::kBQ;
  static constexpr size_t kSmem = Hop<D>::kAlloc;
};
template <>
struct Launch<256> {
  static constexpr bool kWgmma = false;
  static constexpr int kThreads = fa_tf32x3::kThreads, kMinBlocks = 2, kBQ = fa_tf32x3::kBQ;
  static constexpr size_t kSmem = Tile<256>::kSmemBytes;
};

// the maps are those of the wgmma body (unused at d 256), q, k and v those
// of the mma.sync body (unused below)
template <int D>
__global__ void __launch_bounds__(Launch<D>::kThreads, Launch<D>::kMinBlocks)
flash_attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out,
                              float* __restrict__ lse, long long n_bh, int sq, int sk,
                              int q_per_kv, int causal, int window, float scale, int n_qt) {
  extern __shared__ float4 smem4[];
  if constexpr (Launch<D>::kWgmma)
    wgmma_body<D>(reinterpret_cast<uint8_t*>(smem4), &tm_q, &tm_k, &tm_v, out, lse, (int)n_bh,
                  sq, sk, q_per_kv, causal, window, scale, n_qt);
  else
    mma_body<D>(reinterpret_cast<float*>(smem4), q, k, v, out, lse, n_bh, sq, sk, q_per_kv,
                causal, window, scale, n_qt);
}

// ------------------------------------------------------------------ host
// a (rows, s, d) float32 tensor in boxes of 32 columns x box_rows rows x 1,
// 128-byte swizzle, zero fill past its edges (the last box of a row past d at
// d 16, 80 and 112; its row stride, 4d bytes, a multiple of 16, as TMA needs)
inline int make_map(CUtensorMap* map, const void* ptr, long long rows, int s, int d,
                    int box_rows) {
  const fw::EncodeTiled fn = fw::encode_tiled();
  if (!fn) return fw::kNoDriverEntry;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)s * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : fw::kEncodeFailed - (int)r;
}

template <int D>
cudaError_t opt_in() {
  static bool done = false;            // per instantiation, once per process
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tf32x3_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Launch<D>::kSmem);
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
  using L = Launch<D>;
  const cudaError_t err = opt_in<D>();
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (sq + L::kBQ - 1) / L::kBQ;
  const long long grid = (long long)n_qt * n_bh;
  if (sk < 1 || n_bh > 0x7fffffffLL || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q{}, tm_k{}, tm_v{};
  if constexpr (L::kWgmma) {
    int rc = make_map(&tm_q, q, n_bh, sq, D, L::kBQ);
    if (rc == 0) rc = make_map(&tm_k, k, n_bh / q_per_kv, sk, D, Hop<D>::kBK);
    if (rc == 0) rc = make_map(&tm_v, v, n_bh / q_per_kv, sk, D, Hop<D>::kBK);
    if (rc != 0) return rc;
  }
  flash_attention_tf32x3_kernel<D><<<(unsigned)grid, L::kThreads, L::kSmem, s>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(q), static_cast<const float*>(k),
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
        &n, flash_attention_tf32x3_kernel<D>, Launch<D>::kThreads, Launch<D>::kSmem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace fa_tf32x3
