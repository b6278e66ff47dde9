// flash_attention's backward, bfloat16 route, at every head dim but 256 (16,
// 32, 64, 80, 112, 128): Hopper's tensor cores (wgmma) fed by TMA, for
// sm_90a.  The function, what it replaces, its bound, what the forward saves
// for it (lse, the float32 output) and the hi / lo split of P and dS are
// flash_attention_bwd.cuh's notes; d 256 runs on that file's mma.sync
// kernels, since a warpgroup's dk and dv of 64 keys at d 256 would take 256
// registers a thread.
//
// Two kernels a call, each a block of three warpgroups: two consumers of 64
// rows each and a producer whose one thread issues the TMA loads into a ring
// of stages in shared memory, each stage with a "full" mbarrier (the bytes
// arrived) and an "empty" one (all 256 consumer threads done with it), the
// forward's shape (flash_attention_wgmma.cuh: its 128-byte-swizzled panels of
// 64 columns, its 3-D tensor maps, its zero-filled last panel at d 16, 32, 80
// and 112, its descriptors and wgmma wrappers).
//   (a) dq: items of (query head, 128 query rows), heaviest causal ones
//       first, on a persistent grid of one block an SM (the items dealt in
//       snake order); Q and dO of an item in one of two buffers, so the next
//       item's load overlaps this one's end; K and V tiles of BK keys (128
//       at d <= 64, 32 above) through a ring of 3 stages that runs on across
//       items.  Each consumer thread computes D0 = rowsum(dO o) of its two
//       rows with its quad and copies their lse to the stats that (b)
//       reads.  A tile:
//         S = Q.K^T and dP = dO.V^T, SS-wgmma m64nBKk16 (both operands in
//         shared memory, exact bf16 products in float32);
//         P = exp2(c S - lse) (0 where masked), dS = P (dP - D0), split
//         hi / lo and packed as A fragments in place (the accumulator layout
//         of an m64nN tile is the A layout of the next wgmma);
//         P_hi.K, RS-wgmma into its own running sum, and the rows' sum of
//         dS, for D's residual (flash_attention_bwd.cuh's notes);
//         dq's part = dS_lo.K + dS_hi.K, RS-wgmma with K the MN-major B
//         operand, into a fresh accumulator (one wait for both products at
//         d <= 64; a 64-column panel at a time above), added to the
//         running sum (registers) by rounded float32 adds.
//       At the end dq = dS.K - res (P_hi.K) and D = D0 + res to the stats.
//   (b) dk, dv: a block per (group of kGroup = 2 query heads of a KV head,
//       128 keys), the first keys (seen by the most queries) first.  K and V
//       of the block are loaded once; Q and dO tiles of BQ rows (64 at
//       d <= 64, 32 above, where 64 would take the registers the running
//       sums need) with the rows' lse and D (1-D bulk copies from the
//       stats) through a ring of 4 stages, the group's heads one after the
//       other.  A tile:
//         S^T = K.Q^T and dP^T = V.dO^T, SS-wgmma m64nBQk16 (the warpgroup's
//         64 keys as M);
//         P^T and dS^T (each row's lse and D read as float2 pairs), each
//         split hi / lo and packed as A fragments;
//         dv += P^T.dO, then dk += dS^T.Q, RS-wgmma with dO and Q the
//         MN-major B operands, into fresh accumulators, added to the running
//         sums by rounded float32 adds: in registers, but dk's in shared
//         memory above one panel, where it spilled beside dv's.
//       With more than one group a KV head, each block writes its group's
//       float32 dk and dv (in the accumulator's layout, a thread's float4s
//       strided by the 256 threads) to its slot of parts, and the last of
//       the key tile's groups to arrive (an integer ticket) sums the slots
//       in group order, so the bits do not depend on which block that is.
//       Rounded once to bf16.
// What moved their time at qwen2-0.5b's training shape, largest first
// (PERF.md row 5bw): the rows' lse and D read as float2 pairs in (b) in
// place of a load an element; the D0 loads of (a) issued by the threads
// that use them, in place of a prologue through shared memory; two heads a
// block in (b); (a)'s persistent grid (a persistent (b) ran slower and
// spilled, so it stays a block an item).
// No wgmma accumulates across tiles (flash_attention_bwd.cuh: the tensor
// cores' adds truncate), and no atomics touch dq, dk or dv: a backward
// repeats bit for bit.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_attention_bwd.cuh"
#include "flash_attention_wgmma.cuh"

namespace fa_bwd_wgmma {

namespace fw = fa_wgmma;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = 384;      // and one producer warpgroup
// setmaxnreg moves registers from the producer (40) to the consumers (232),
// the forward's split: the consumers' increase waits until the producer's
// decrease has freed as many as it takes from the 168 a thread of the launch
// ((232 - 168) x 256 = (168 - 40) x 128), so the two must match
constexpr int kPanel = 64;         // bf16 columns per 128-byte swizzled row
constexpr int kRows = 128;         // query rows of a dq block; keys of a dk / dv block
constexpr int kGroup = 2;          // query heads a dk / dv block (a group of the KV head's)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dims {
  static_assert(D % 16 == 0 && D <= 2 * kPanel, "d: a multiple of 16, at most 128");
  static constexpr int kPanels = (D + kPanel - 1) / kPanel;
  static constexpr int kDP = kPanels * kPanel;             // the compute width
  static constexpr int kSteps = D / 16;                    // k-steps of a product over d
  static constexpr int kTailN = D - (kPanels - 1) * kPanel;  // the last panel's columns
};

template <int D>
struct DqSmem {                    // byte offsets from a 1024-aligned base
  // keys a KV tile: 32 above one panel, where 64 keys' S and dP beside the
  // running sums of dS.K and P_hi.K spilled at d 128
  static constexpr int kBK = D <= kPanel ? 128 : 32;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kRows * Dims<D>::kDP * 2;       // Q or dO
  static constexpr int kTileBytes = kBK * Dims<D>::kDP * 2;      // a K or V tile
  static constexpr int kQ = 0;                                   // 2 buffers: Q, then dO
  static constexpr int kK = kQ + 4 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // full[], empty[], q_full[2], q_empty[2]
  static constexpr int kAlloc = kBar + 8 * (2 * kStages + 4) + 1024;
};

template <int D>
struct DkvSmem {                   // byte offsets from a 1024-aligned base
  static constexpr int kBQ = D <= kPanel ? 64 : 32;      // query rows a step
  static constexpr int kStages = 4;
  // above one panel dk's running sum lives in shared memory (a thread's
  // floats 256 apart): in registers beside dv's it spilled at d 112 and 128
  static constexpr bool kDkShared = Dims<D>::kPanels > 1;
  static constexpr int kKBytes = kRows * Dims<D>::kDP * 2;       // K or V of the block
  static constexpr int kTileBytes = kBQ * Dims<D>::kDP * 2;      // a Q or dO tile
  static constexpr int kRowBytes = 2 * kBQ * 4;                  // the tile's lse, then D
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kRowF = kDO + kStages * kTileBytes;
  static constexpr int kDk = kRowF + kStages * kRowBytes;         // dk's sum, if shared
  static constexpr int kBar = kDk + (kDkShared ? Dims<D>::kPanels * 32 * kConsumers * 4 : 0);
  static constexpr int kAlloc = kBar + 8 * (2 * kStages + 1) + 1024;   // full[], empty[], kv
};

// a 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// x, opaque to the compiler: a value derived at the kernel's start and used
// only after the consumers' loop is derived anew from fresh(its inputs), not
// kept across the loop, where it spilled
__device__ __forceinline__ int fresh(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// The dq kernel's prologue for this thread's rows row and row + 8 (those of
// its accumulator fragment, which the 4 threads of its quad share): D0 =
// dO . o in float32, a quarter of d a thread summed over the quad by xor
// shuffles, and the forward's lse; 0 and +inf past sq.  The loads are
// issued before the first tile's products and waited for only by its P (a
// prologue through shared memory and a barrier held every consumer up).
template <int D>
__device__ __forceinline__ void quad_rows(const bf16* dout, const float* o32, const float* lse,
                                          int bh, int row, int sq, int t4, float (&d0)[2],
                                          float (&l)[2]) {
  constexpr int Q = D / 4;                        // elements a thread, a multiple of 4
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row + 8 * r;
    float acc = 0.f;
    l[r] = INFINITY;
    if (qi < sq) {
      const long long at = ((long long)bh * sq + qi) * D + t4 * Q;
#pragma unroll
      for (int c = 0; c < Q; c += 4) {
        const float4 o = *reinterpret_cast<const float4*>(o32 + at + c);
        const uint2 u = *reinterpret_cast<const uint2*>(dout + at + c);
        __nv_bfloat162 g0, g1;
        memcpy(&g0, &u.x, sizeof g0);
        memcpy(&g1, &u.y, sizeof g1);
        const float2 a = __bfloat1622float2(g0), b = __bfloat1622float2(g1);
        acc = fmaf(o.w, b.y, fmaf(o.z, b.x, fmaf(o.y, a.y, fmaf(o.x, a.x, acc))));
      }
      l[r] = lse[(long long)bh * sq + qi];
    }
    acc += __shfl_xor_sync(fw::kFull, acc, 1);
    d0[r] = acc + __shfl_xor_sync(fw::kFull, acc, 2);
  }
}

// named barrier 1 over the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

#define FB_SS_N32                                                                       \
  "{\n.reg .pred p;\n"                                                                  \
  "setp.ne.b32 p, %18, 0;\n"                                                            \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                \
  "}, %16, %17, p, 1, 1, 0, 0;\n}\n"

// d (64 x N float32, N = 2 M) = A . B^T (plus d when ACC), both K-major in
// shared memory: N 32 here, 64 and 128 the forward's
template <bool ACC, int M>
__device__ __forceinline__ void ss(float (&d)[M], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (M == 16) {
    if constexpr (ACC)
      asm volatile(FB_SS_N32 : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8)
                   : "l"(desc_a), "l"(desc_b), "r"(1));
    else
      asm volatile(FB_SS_N32 : FA_R8(FA_SET, 0), FA_R8(FA_SET, 8)
                   : "l"(desc_a), "l"(desc_b), "r"(0));
  } else {
    fw::wgmma_ss<ACC>(d, desc_a, desc_b);
  }
}

// d = A . B^T over the first D columns: A the warpgroup's 64 rows at a (rows
// of one panel RA rows tall), B the tile at b (panels RB rows tall), issued
// (not committed)
template <int D, int RA, int RB, int M>
__device__ __forceinline__ void product_abt(float (&d)[M], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < Dims<D>::kSteps; ++ks) {
    // panel ks / 4, 16 columns (32 bytes) a step
    const uint32_t ao = (ks / 4) * RA * 128 + (ks % 4) * 32, bo = (ks / 4) * RB * 128 + (ks % 4) * 32;
    if (ks == 0)
      ss<false>(d, fw::sw128_desc(a + ao), fw::sw128_desc(b + bo));
    else
      ss<true>(d, fw::sw128_desc(a + ao), fw::sw128_desc(b + bo));
  }
}

// The accumulator of an m64nN tile (N = 4 X), split hi / lo and packed as the
// A fragments of the N / 16 k-steps of the next product
template <int X>
__device__ __forceinline__ void pack(const float (&s)[2 * X], uint32_t (&hi)[X],
                                     uint32_t (&lo)[X]) {
#pragma unroll
  for (int i = 0; i < X; ++i) fa_bwd::split2(s[2 * i], s[2 * i + 1], hi[i], lo[i]);
}

// part = lo . B + hi . B, a fresh accumulator, issued (not committed): A the
// packed fragments of KS k-steps, B N columns (one panel) of an MN-major
// tile whose rows start at `panel` (16 rows, 2,048 bytes, a k-step)
template <int N, int KS>
__device__ __forceinline__ void issue_split(float (&part)[32], const uint32_t (&hi)[4 * KS],
                                            const uint32_t (&lo)[4 * KS], uint32_t panel) {
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
  fw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3]};
    fw::wgmma_rs<N>(part, a, fw::sw128_desc(panel + kk * 2048));
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3]};
    fw::wgmma_rs<N>(part, a, fw::sw128_desc(panel + kk * 2048));
  }
}

// issue_split, committed and waited for
template <int N, int KS>
__device__ __forceinline__ void split_product(float (&part)[32], const uint32_t (&hi)[4 * KS],
                                              const uint32_t (&lo)[4 * KS], uint32_t panel) {
  issue_split<N, KS>(part, hi, lo, panel);
  fw::wgmma_commit();
  fw::wgmma_wait<0>();
  fw::fence_regs<N / 2>(part);
}

// sum += lo . B + hi . B through a fresh accumulator (split_product)
template <int N, int KS>
__device__ __forceinline__ void split_product_into(float (&sum)[32], const uint32_t (&hi)[4 * KS],
                                                   const uint32_t (&lo)[4 * KS], uint32_t panel) {
  float part[32];
  split_product<N, KS>(part, hi, lo, panel);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] += part[i];
}

// as split_product_into, the running sum in shared memory: this thread's
// element i at sum[256 i]
template <int N, int KS>
__device__ __forceinline__ void split_product_into_shared(float* sum, const uint32_t (&hi)[4 * KS],
                                                          const uint32_t (&lo)[4 * KS],
                                                          uint32_t panel) {
  float part[32];
  split_product<N, KS>(part, hi, lo, panel);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i * kConsumers] += part[i];
}

// every panel of an MN-major tile (panels R rows tall) into the running sums
template <int D, int R, int KS>
__device__ __forceinline__ void split_product_panels(float (&sum)[Dims<D>::kPanels][32],
                                                     const uint32_t (&hi)[4 * KS],
                                                     const uint32_t (&lo)[4 * KS], uint32_t tile) {
  constexpr int NP = Dims<D>::kPanels;
#pragma unroll
  for (int p = 0; p + 1 < NP; ++p)
    split_product_into<kPanel, KS>(sum[p], hi, lo, tile + p * R * 128);
  split_product_into<Dims<D>::kTailN, KS>(sum[NP - 1], hi, lo, tile + (NP - 1) * R * 128);
}

// rows row, row + 8 of a warpgroup's running sums (64 x d, the accumulator
// layout: element 4j + 2r + c of panel p is row + 8r, column 64p + 8j + 2 t4
// + c), times mul, rounded once to bf16, rows at or past n not stored
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&sum)[Dims<D>::kPanels][32],
                                           int row, int n, int t4, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n) continue;
    bf16* orow = out + (long long)(row + 8 * r) * D;
#pragma unroll
    for (int p = 0; p < Dims<D>::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (p * kPanel + 8 * j >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(orow + p * kPanel + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(sum[p][4 * j + 2 * r] * mul, sum[p][4 * j + 2 * r + 1] * mul);
      }
  }
}

// ------------------------------------------------------------- (a) dq
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_wg_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    const bf16* __restrict__ dout, const float* __restrict__ o32,
                    const float* __restrict__ lse, bf16* __restrict__ dq,
                    float* __restrict__ stats, int n_bh, int sq, int sk, int q_per_kv,
                    int causal, int window, float scale, int n_qt, int sq_pad) {
  using L = DqSmem<D>;
  constexpr int NP = Dims<D>::kPanels, kBK = L::kBK, kStages = L::kStages;
  constexpr int SN = kBK / 2;        // S accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t bar_full = base + L::kBar, bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_qfull = bar_empty + 8 * kStages, bar_qempty = bar_qfull + 16;

  // A persistent block: items (bh, 128 query rows), heaviest causal tiles
  // first, dealt to the G blocks in snake order (round k gives block b item
  // k G + b, or (k + 1) G - 1 - b when k is odd, which evens the causal
  // items' work out far better than round robin); the K / V ring runs on
  // across them, and Q and dO go to two buffers, so the next item loads
  // while this one ends (a block an item paid its start and end alone).
  const auto item = [&](int i, int& bh, int& q0, int& t_begin, int& n_tiles) {
    bh = i % n_bh;
    q0 = (n_qt - 1 - i / n_bh) * kRows;
    int t_end;
    fa_bwd::kv_tiles<kBK, kRows>(q0, sq, sk, causal, window, &t_begin, &t_end);
    n_tiles = t_end - t_begin;
  };
  const int n_items = n_qt * n_bh, G = gridDim.x, b = blockIdx.x;
  const auto snake = [&](int k) { return k % 2 == 0 ? k * G + b : (k + 1) * G - 1 - b; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      fw::mbar_init(bar_full + 8 * s, 1);
      fw::mbar_init(bar_empty + 8 * s, kConsumers);
    }
    for (int qb = 0; qb < 2; ++qb) {
      fw::mbar_init(bar_qfull + 8 * qb, 1);
      fw::mbar_init(bar_qempty + 8 * qb, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers) {
      int g = 0;                                     // KV tiles so far, all items
      for (int k = 0, n = 0; k * G < n_items; ++k) {
        const int w = snake(k);
        if (w >= n_items) continue;
        int bh, q0, t_begin, n_tiles;
        item(w, bh, q0, t_begin, n_tiles);
        const int kv = bh / q_per_kv, qb = n & 1;
        const uint32_t qfull = bar_qfull + 8 * qb, s_q = base + L::kQ + qb * 2 * L::kQBytes;
        if (n >= 2) fw::mbar_wait(bar_qempty + 8 * qb, (n / 2 - 1) & 1);
        if (n_tiles > 0) {
          fw::mbar_expect_tx(qfull, 2 * L::kQBytes);
          for (int p = 0; p < NP; ++p) {
            fw::tma_load_3d(s_q + p * kRows * 128, &tm_q, qfull, p * kPanel, q0, bh);
            fw::tma_load_3d(s_q + L::kQBytes + p * kRows * 128, &tm_do, qfull, p * kPanel, q0, bh);
          }
        } else {
          fw::mbar_arrive(qfull);
        }
        for (int it = 0; it < n_tiles; ++it, ++g) {
          const int st = g % kStages;
          if (g >= kStages) fw::mbar_wait(bar_empty + 8 * st, (g / kStages - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          fw::mbar_expect_tx(full, 2 * L::kTileBytes);
          const int k0 = (t_begin + it) * kBK;
          for (int p = 0; p < NP; ++p) {
            fw::tma_load_3d(s_k + st * L::kTileBytes + p * kBK * 128, &tm_k, full, p * kPanel, k0, kv);
            fw::tma_load_3d(s_v + st * L::kTileBytes + p * kBK * 128, &tm_v, full, p * kPanel, k0, kv);
          }
        }
        ++n;
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const float c = scale * kLog2e;
    int g = 0;
    for (int k = 0, n = 0; k * G < n_items; ++k) {
      const int w = snake(k);
      if (w >= n_items) continue;
      int bh, q0, t_begin, n_tiles;
      item(w, bh, q0, t_begin, n_tiles);
      const int qb = n & 1;
      const uint32_t s_q = base + L::kQ + qb * 2 * L::kQBytes, s_do = s_q + L::kQBytes;
      const int r_first = q0 + wg * 64;                  // this warpgroup's rows
      const int row = r_first + warp * 16 + lane / 4;    // this thread's: row, row + 8
      // their lse and D0 (loaded while the first tiles load), the lse copied
      // to the stats for the dk / dv kernel
      float lse_r[2], d_r[2];
      quad_rows<D>(dout, o32, lse, bh, row, sq, t4, d_r, lse_r);
      if (t4 == 0) {
        stats[(long long)bh * sq_pad + row] = lse_r[0];
        stats[(long long)bh * sq_pad + row + 8] = lse_r[1];
      }
      // the running sums of dS.K and of P_hi.K (the residual's direction), and
      // this thread's part of each row's residual sum_j dS_ij
      float sum[NP][32], bsum[NP][32], res[2] = {0.f, 0.f};
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[p][i] = bsum[p][i] = 0.f;

      fw::mbar_wait(bar_qfull + 8 * qb, (n / 2) & 1);
      for (int it = 0; it < n_tiles; ++it, ++g) {
        const int st = g % kStages;
        fw::mbar_wait(bar_full + 8 * st, (g / kStages) & 1);
        const uint32_t k_tile = s_k + st * L::kTileBytes, v_tile = s_v + st * L::kTileBytes;
        float s[SN], dp[SN];
        fw::wgmma_fence();
        product_abt<D, kRows, kBK>(s, s_q + wg * 64 * 128, k_tile);
        product_abt<D, kRows, kBK>(dp, s_do + wg * 64 * 128, v_tile);
        fw::wgmma_commit();
        fw::wgmma_wait<0>();
        fw::fence_regs(s);
        fw::fence_regs(dp);

        // dS = P (dP - D) in s, P = exp2(c S - lse), 0 where masked; P_hi
        // packed as the A fragments of P_hi.K
        const int k0 = (t_begin + it) * kBK;
        const bool all = fa_bwd::whole(r_first, 64, k0, kBK, sq, sk, causal, window);
        uint32_t p_hi[SN / 2];
#pragma unroll
        for (int i = 0; i < SN; i += 2) {
          const int r = (i / 2) % 2, kp = k0 + 8 * (i / 4) + 2 * t4;
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = all || fa_bwd::valid(row + 8 * r, kp + e, sq, sk, causal, window);
            p[e] = ok ? fw::ex2(s[i + e] * c - lse_r[r]) : 0.f;
            s[i + e] = p[e] * (dp[i + e] - d_r[r]);
            res[r] += s[i + e];
          }
          p_hi[i / 2] = fw::bf16x2_bits(__floats2bfloat162_rn(p[0], p[1]));
        }
        uint32_t hi[SN / 2], lo[SN / 2];
        pack<SN / 2>(s, hi, lo);
        // P_hi.K into its running sum (no fresh accumulator: it needs 9 bits),
        // then dq += dS.K, K the MN-major B operand (keys the k of the
        // product); dq's wait retires P_hi.K too
        fw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
#pragma unroll
          for (int p = 0; p + 1 < NP; ++p)
            fw::wgmma_rs<kPanel>(bsum[p], a, fw::sw128_desc(k_tile + p * kBK * 128 + kk * 2048));
          fw::wgmma_rs<Dims<D>::kTailN>(bsum[NP - 1], a,
                                        fw::sw128_desc(k_tile + (NP - 1) * kBK * 128 + kk * 2048));
        }
        if constexpr (NP == 1) {                       // one wait for both
          float part[32];
          issue_split<Dims<D>::kTailN, kBK / 16>(part, hi, lo, k_tile);
          fw::wgmma_commit();
          fw::wgmma_wait<0>();
          fw::fence_regs<Dims<D>::kTailN / 2>(part);
#pragma unroll
          for (int i = 0; i < Dims<D>::kTailN / 2; ++i) sum[0][i] += part[i];
        } else {                                       // a panel at a time
          fw::wgmma_commit();
          split_product_panels<D, kBK, kBK / 16>(sum, hi, lo, k_tile);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) fw::fence_regs(bsum[p]);
        fw::mbar_arrive(bar_empty + 8 * st);
      }
      // D's residual: D0 = dO.o from the forward's float32 o, whose P was split
      // in two bf16 (16 bits), is off by about 2^-17 of |D|, which cancels
      // badly in dS where the softmax is peaked; the sweep's own sum_j dS_ij
      // is D - D0 exactly to float32 rounding (sum_j P_ij = 1), so
      //   dq = sum_j P_ij (dP_ij - D) K_j = (dS.K)_i - res_i (P.K)_i,
      // and P.K from P_hi (9 bits) suffices for a term that small.  D = D0 +
      // res goes to the stats for the dk / dv kernel.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        res[r] += __shfl_xor_sync(fw::kFull, res[r], 1);
        res[r] += __shfl_xor_sync(fw::kFull, res[r], 2);
        if (t4 == 0)
          stats[((long long)n_bh + bh) * sq_pad + row + 8 * r] = d_r[r] + res[r];
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[p][i] -= res[(i / 2) % 2] * bsum[p][i];
      fw::mbar_arrive(bar_qempty + 8 * qb);            // Q and dO read (the last wait)
      store_rows<D>(dq + (long long)bh * sq * D, sum, row, sq, t4, scale);
      ++n;
    }
  }
}

// ---------------------------------------------------------- (b) dk, dv
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_wg_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ stats,
                     float* __restrict__ parts, int* __restrict__ tickets, int n_bh, int sq,
                     int sk, int q_per_kv, int causal, int window, float scale, int sq_pad) {
  using L = DkvSmem<D>;
  constexpr int NP = Dims<D>::kPanels, kBQ = L::kBQ, kStages = L::kStages;
  constexpr int SN = kBQ / 2;        // S^T accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = base + L::kK, s_v = base + L::kV, s_q = base + L::kQ, s_do = base + L::kDO;
  const uint32_t s_rows = base + L::kRowF;
  const uint32_t bar_full = base + L::kBar, bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;
  // the generic address of the row floats (lse, D) of the stages
  const float* rows_f =
      reinterpret_cast<const float*>(smem_raw + (s_rows - (uint32_t)__cvta_generic_to_shared(smem_raw)));

  // a group of kGroup query heads a block (the last group of the KV head's
  // q_per_kv may hold fewer): the group gq, kv, then the key tile kt (the
  // first keys see the most queries, so they go first).  The block's steps
  // are its heads' query tiles, head after head.
  const int n_bkh = n_bh / q_per_kv, n_groups = (q_per_kv + kGroup - 1) / kGroup;
  const int blk = (int)blockIdx.x;
  int gq = blk % n_groups, kv = blk / n_groups % n_bkh, kt = blk / n_groups / n_bkh;
  const int k0 = kt * kRows, bh0 = kv * q_per_kv + gq * kGroup;
  const int n_heads = min(kGroup, q_per_kv - gq * kGroup);
  int qt_begin, qt_end;
  fa_bwd::q_tiles<kBQ>(k0, kRows, sq, causal, window, &qt_begin, &qt_end);
  const int n_qt = qt_end - qt_begin, n_it = n_heads * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      fw::mbar_init(bar_full + 8 * s, 1);
      fw::mbar_init(bar_empty + 8 * s, kConsumers);
    }
    fw::mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers && n_it > 0) {
      fw::mbar_expect_tx(bar_kv, 2 * L::kKBytes);
      for (int p = 0; p < NP; ++p) {
        fw::tma_load_3d(s_k + p * kRows * 128, &tm_k, bar_kv, p * kPanel, k0, kv);
        fw::tma_load_3d(s_v + p * kRows * 128, &tm_v, bar_kv, p * kPanel, k0, kv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        if (it >= kStages) fw::mbar_wait(bar_empty + 8 * st, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        fw::mbar_expect_tx(full, 2 * L::kTileBytes + L::kRowBytes);
        const int bh = bh0 + it / n_qt, qs = (qt_begin + it % n_qt) * kBQ;
        const float* l_src = stats + (long long)bh * sq_pad;
        const float* d_src = stats + ((long long)n_bh + bh) * sq_pad;
        for (int p = 0; p < NP; ++p) {
          fw::tma_load_3d(s_q + st * L::kTileBytes + p * kBQ * 128, &tm_q, full, p * kPanel, qs, bh);
          fw::tma_load_3d(s_do + st * L::kTileBytes + p * kBQ * 128, &tm_do, full, p * kPanel, qs,
                          bh);
        }
        bulk_load(s_rows + st * L::kRowBytes, l_src + qs, kBQ * 4, full);
        bulk_load(s_rows + st * L::kRowBytes + kBQ * 4, d_src + qs, kBQ * 4, full);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int key_first = k0 + wg * 64;                 // this warpgroup's keys
    const int key = key_first + warp * 16 + lane / 4;   // this thread's: key, key + 8
    const float c = scale * kLog2e;
    float dk_sum[NP][32], dv_sum[NP][32];
    // dk's running sum in shared memory (L::kDkShared): element i of panel p
    // at dk_sm[(32 p + i) 256]
    float* dk_sm = reinterpret_cast<float*>(
        smem_raw + (base + L::kDk - (uint32_t)__cvta_generic_to_shared(smem_raw))) + threadIdx.x;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dk_sum[p][i] = dv_sum[p][i] = 0.f;
        if constexpr (L::kDkShared) dk_sm[(32 * p + i) * kConsumers] = 0.f;
      }

    if (n_it > 0) fw::mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      fw::mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
      const uint32_t q_tile = s_q + st * L::kTileBytes, do_tile = s_do + st * L::kTileBytes;
      const float* l_rows = rows_f + st * (L::kRowBytes / 4);
      const float* d_rows = l_rows + kBQ;
      // S^T = K.Q^T and dP^T = V.dO^T: rows this warpgroup's 64 keys, columns
      // the tile's kBQ queries
      float s[SN], dp[SN];
      fw::wgmma_fence();
      product_abt<D, kRows, kBQ>(s, s_k + wg * 64 * 128, q_tile);
      product_abt<D, kRows, kBQ>(dp, s_v + wg * 64 * 128, do_tile);
      fw::wgmma_commit();
      fw::wgmma_wait<0>();
      fw::fence_regs(s);
      fw::fence_regs(dp);

      const int qs = (qt_begin + it % n_qt) * kBQ;
      const bool all = fa_bwd::whole(qs, kBQ, key_first, 64, sq, sk, causal, window);
      // element 4j + e: key + 8 (e / 2), query ql = 8j + 2 t4 + e % 2, whose
      // lse and D two float2 loads give (a load an element was the kernel's
      // largest cost)
#pragma unroll
      for (int j = 0; j < SN / 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(l_rows + 8 * j + 2 * t4);
        const float2 d2 = *reinterpret_cast<const float2*>(d_rows + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, ql = 8 * j + 2 * t4 + e % 2;
          const bool ok = all || fa_bwd::valid(qs + ql, key + 8 * (e / 2), sq, sk, causal, window);
          const float p = ok ? fw::ex2(s[i] * c - (e % 2 ? l2.y : l2.x)) : 0.f;
          dp[i] = p * (dp[i] - (e % 2 ? d2.y : d2.x));     // dS^T
          s[i] = p;                                        // P^T
        }
      }
      // dv += P^T.dO, then dk += dS^T.Q (dO and Q the MN-major B operands),
      // each operand packed just before its product
      {
        uint32_t hi[SN / 2], lo[SN / 2];
        pack<SN / 2>(s, hi, lo);
        split_product_panels<D, kBQ, kBQ / 16>(dv_sum, hi, lo, do_tile);
      }
      uint32_t hi[SN / 2], lo[SN / 2];
      pack<SN / 2>(dp, hi, lo);
      if constexpr (L::kDkShared) {
#pragma unroll
        for (int p = 0; p + 1 < NP; ++p)
          split_product_into_shared<kPanel, kBQ / 16>(dk_sm + 32 * p * kConsumers, hi, lo,
                                                      q_tile + p * kBQ * 128);
        split_product_into_shared<Dims<D>::kTailN, kBQ / 16>(
            dk_sm + 32 * (NP - 1) * kConsumers, hi, lo, q_tile + (NP - 1) * kBQ * 128);
      } else {
        split_product_panels<D, kBQ, kBQ / 16>(dk_sum, hi, lo, q_tile);
      }
      fw::mbar_arrive(bar_empty + 8 * st);
    }

    if constexpr (L::kDkShared) {
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) dk_sum[p][i] = dk_sm[(32 * p + i) * kConsumers];
    }
    // the block's group, KV head and key tile, for the epilogue
    const int b = fresh(blockIdx.x), qpk = fresh(q_per_kv);
    const int n_groups_e = (qpk + kGroup - 1) / kGroup, n_bkh_e = n_bh / qpk;
    gq = b % n_groups_e;
    kv = b / n_groups_e % n_bkh_e;
    kt = b / n_groups_e / n_bkh_e;
    if (n_groups_e > 1) {
      // this group's part into its slot (a thread's float4s 256 apart:
      // dk's panels, then dv's), then the last group of the key tile to
      // arrive sums the slots in group order
      constexpr int F4 = NP * 8;                      // float4s a thread, each of dk and dv
      constexpr long long kSlot = 2LL * F4 * 4 * kConsumers;
      const int ct = threadIdx.x;
      float* slots = parts + (long long)(kt * n_bkh_e + kv) * n_groups_e * kSlot;
      float4* mine = reinterpret_cast<float4*>(slots + gq * kSlot);
#pragma unroll
      for (int j = 0; j < F4; ++j) {
        const int p = j / 8, e = 4 * (j % 8);
        mine[j * kConsumers + ct] = make_float4(dk_sum[p][e], dk_sum[p][e + 1], dk_sum[p][e + 2],
                                                dk_sum[p][e + 3]);
        mine[(F4 + j) * kConsumers + ct] = make_float4(dv_sum[p][e], dv_sum[p][e + 1],
                                                       dv_sum[p][e + 2], dv_sum[p][e + 3]);
      }
      __threadfence();
      consumers_sync();
      if (ct == 0) last = atomicAdd(tickets + kt * n_bkh_e + kv, 1) == n_groups_e - 1;
      consumers_sync();
      if (!last) return;
      __threadfence();
      const float4* all4 = reinterpret_cast<const float4*>(slots);
      // float4 j of every slot, summed in group order
      const auto gather = [&](int j) {
        float4 x = __ldcg(all4 + j * kConsumers + ct);
        for (int h = 1; h < n_groups_e; ++h) {
          const float4 y = __ldcg(all4 + h * (kSlot / 4) + j * kConsumers + ct);
          x.x += y.x;
          x.y += y.y;
          x.z += y.z;
          x.w += y.w;
        }
        return x;
      };
#pragma unroll
      for (int j = 0; j < F4; ++j) {
        const int p = j / 8, e = 4 * (j % 8);
        const float4 x = gather(j), y = gather(F4 + j);
        dk_sum[p][e] = x.x;
        dk_sum[p][e + 1] = x.y;
        dk_sum[p][e + 2] = x.z;
        dk_sum[p][e + 3] = x.w;
        dv_sum[p][e] = y.x;
        dv_sum[p][e + 1] = y.y;
        dv_sum[p][e + 2] = y.z;
        dv_sum[p][e + 3] = y.w;
      }
    }
    store_rows<D>(dk + (long long)kv * sk * D, dk_sum, key, sk, t4, scale);
    store_rows<D>(dv + (long long)kv * sk * D, dv_sum, key, sk, t4, 1.f);
  }
}

// ------------------------------------------------------------------ host
// The dq kernel, then the dk / dv kernel, on stream s: the pointers and
// scratch of fa_bwd::launch_pair (parts: n_bh x 2 x ceil(sk / 128) * 128 x
// d rounded up to whole 64-column panels, float32).  Returns a cudaError_t,
// or a negative code for a refused tensor map (fa_wgmma's).
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o32, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* stats, void* parts,
           void* tickets, long long n_bh, int sq, int sk, int q_per_kv, int causal, int window,
           float scale, int sq_pad, cudaStream_t s) {
  static bool opted_in = false;      // per instantiation, once per process
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(fa_bwd_wg_dq_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           DqSmem<D>::kAlloc);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fa_bwd_wg_dkv_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, DkvSmem<D>::kAlloc);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int n_qt = (sq + kRows - 1) / kRows;
  const long long n_bkh = n_bh / q_per_kv;
  static int n_sm = 0;               // the device's SMs, once per process
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // the dq kernel's persistent blocks: one an SM, or one an item
  const long long grid_dq = std::min<long long>((long long)n_qt * n_bh, n_sm);
  const long long grid_dkv =
      (long long)((sk + kRows - 1) / kRows) * n_bkh * ((q_per_kv + kGroup - 1) / kGroup);
  if (n_bh > 0x7fffffffLL || (long long)n_qt * n_bh > 0x7fffffffLL || grid_dkv > 0x7fffffffLL ||
      sq_pad < n_qt * kRows)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[8];
  int rc = fw::make_map(&tm[0], q, n_bh, sq, D, kRows);
  if (rc == 0) rc = fw::make_map(&tm[1], dout, n_bh, sq, D, kRows);
  if (rc == 0) rc = fw::make_map(&tm[2], k, n_bkh, sk, D, DqSmem<D>::kBK);
  if (rc == 0) rc = fw::make_map(&tm[3], v, n_bkh, sk, D, DqSmem<D>::kBK);
  if (rc == 0) rc = fw::make_map(&tm[4], q, n_bh, sq, D, DkvSmem<D>::kBQ);
  if (rc == 0) rc = fw::make_map(&tm[5], dout, n_bh, sq, D, DkvSmem<D>::kBQ);
  if (rc == 0) rc = fw::make_map(&tm[6], k, n_bkh, sk, D, kRows);
  if (rc == 0) rc = fw::make_map(&tm[7], v, n_bkh, sk, D, kRows);
  if (rc != 0) return rc;
  fa_bwd_wg_dq_kernel<D><<<(unsigned)grid_dq, kThreads, DqSmem<D>::kAlloc, s>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const bf16*>(dout), static_cast<const float*>(o32),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(stats),
      (int)n_bh, sq, sk, q_per_kv, causal, window, scale, n_qt, sq_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_wg_dkv_kernel<D><<<(unsigned)grid_dkv, kThreads, DkvSmem<D>::kAlloc, s>>>(
      tm[4], tm[5], tm[6], tm[7], static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const float*>(stats), static_cast<float*>(parts), static_cast<int*>(tickets),
      (int)n_bh, sq, sk, q_per_kv, causal, window, scale, sq_pad);
  return (int)cudaGetLastError();
}

}  // namespace fa_bwd_wgmma
