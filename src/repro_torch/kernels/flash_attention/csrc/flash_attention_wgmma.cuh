// flash_attention's bfloat16 route, at every head dim (16, 32, 64, 80, 112,
// 128, 256): Hopper's tensor cores (wgmma) fed by TMA, for sm_90a.
//
// The same function as the CUDA-core kernel in flash_attention.cu (which
// replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py,
// _kernel / flash_attention_pallas):
//   o[bh, i] = sum_j p_ij v[bh / q_per_kv, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = scale * q[bh, i] . k[bh / q_per_kv, j]
// over the keys j the causal / window mask lets through, running max, sum and
// accumulator in float32, output rounded once to bfloat16, a row with no valid
// key 0.
//
// Bound: operations.  At the qwen2-0.5b prefill (B=4, H=14, KVH=2, S=4096,
// d=64, causal) the function's products are 2*B*H*S^2*d = 120 GFLOP, 0.12 ms
// at the dense bf16 tensor-core rate (989 TFLOP/s), against 67 MB of q, k, v
// and output (0.02 ms at 3.35 TB/s).  This kernel does 1.5x those products
// (the P.V split below), so it cannot come closer than 0.18 ms.  At
// zamba2-2.7b's prefill (B=4, H=KVH=32, S=4096, d=80) the function is 343.6
// GFLOP, 0.347 ms, and the kernel's own floor 0.521 ms; computed at a padded
// 128 columns it would be 0.834 ms.
//
// Shape of the kernel (FA3's):
//   * one block per (bh, 128-query tile), heaviest causal tiles first; three
//     warpgroups: two consumers of 64 query rows each, and a producer whose
//     one thread issues the TMA loads.  setmaxnreg moves registers from the
//     producer (40) to the consumers (232);
//   * Q is loaded once by TMA; K and V tiles of 128 keys go through a ring of
//     3 stages in shared memory (224 KB at DP = 128; at d = 256, tiles of 64
//     keys in 2 stages, 192 KB), each stage with a "full"
//     mbarrier (TMA bytes arrived) and an "empty" one (all 256 consumer
//     threads done with it); KV tiles that the causal mask or the window hides
//     from every row of the query tile are never loaded;
//   * the TMA maps are 3-D (rows, s, d): a box that runs past s is zero-filled
//     and never reads the next head's rows.  Rows are 128-byte-swizzled panels
//     of 64 columns, the layout the wgmma descriptors below describe; a tile
//     takes DP / 64 panels, DP being d rounded up to whole panels (64 at d =
//     16, 32 and 64, 128 at d = 80, 112 and 128, 256 at d = 256);
//   * d that is not whole panels (16, 32: one panel of 16 or 32 columns; 80:
//     64 + 16; 112: 64 + 48): the map has the tensor's real row (32, 64, 160
//     or 224 bytes), and the last panel's box runs past d, where TMA fills
//     zeros (the mbarrier still counts the whole box's bytes).  No product
//     reads those columns: S takes d/16 k-steps, and the last panel's P.V is
//     an m64nNk16 with N = d - 64 (P - 1) (16, 32 or 48), read from the first
//     N columns of the same 128-byte-swizzled panel; the store writes the
//     first d columns of each row.  Shared memory, the ring and the registers
//     are DP's (at d = 16, three quarters of each panel hold zeros);
//   * S = Q.K^T: d/16 wgmma m64nBKk16 (BK the keys of a tile, 128 or 64),
//     both operands in shared memory, float32
//     accumulator (products of bf16 inputs are exact in float32, as in the
//     plain version).  The scale (times log2 e) and the mask act on the
//     accumulator fragment; only tiles that cross the diagonal, the window edge
//     or sk are masked;
//   * online softmax on the fragment in float32: a row lives in the 4 threads
//     of a quad, its max across them by xor shuffles 1 and 2; l sums the
//     float32 p per thread and the quad's partial sums are added at the end;
//   * P.V from registers: the m64nNk16 accumulator layout of S is the A-operand
//     fragment layout of the next wgmma, so p is packed in place; V is the
//     MN-major B operand (transpose bit set), one m64n64k16 per whole
//     64-column panel and one m64nNk16 for a last panel of N < 64 columns;
//   * overlap (FA3's): a consumer issues the next tile's S and this tile's P.V
//     back to back, waits for S alone (wait_group 1) and runs the next softmax
//     while P.V runs; the two consumers take turns at issuing (named barriers
//     1 and 2), so one's softmax also runs under the other's products.  The
//     last tile is peeled off the loop: with a uniform loop body ptxas sees
//     which group wait_group 1 retires, where a conditional S product made it
//     serialize every wgmma (its C7514 report).  On the card this took the
//     qwen2-0.5b shape from 0.45 to 0.40 ms (PERF.md; NVIDIA H100 80GB HBM3,
//     700 W).
//
// Why P.V is two products.  The plain version and the JAX kernel compute P.V
// in float32 (kernel.py:85-87: p float32, v cast to float32), and
// chip_smoke.py's bf16 check holds the kernel to that: every output within one
// bf16 step plus 1e-3 of the largest output, and at most 1 % of the outputs
// differing at all.  Rounding p to bf16 before the product (FA2 / FA3) fails
// that check by far: in a float32 emulation on the CPU at the check's inputs
// (q scaled by 3, k and v by 1, causal; 14 over 2 heads, S=1024, d=64; 16 over
// 8, S=512, d=128; 32 over 32, S=512, d=80; 64 over 8, S=512, d=112) 23-24 % of
// the outputs differ, against 0.04-0.05 % with p in float32.  So p is split,
// P_hi = bf16(p), P_lo = bf16(p - P_hi) (the difference is exact in float32),
// and O += P_hi.V + P_lo.V in one float32 accumulator: p then carries 16
// significant bits, and 0.11-0.12 % of the outputs differ
// (tests/test_torch_flash_numerics.py runs that emulation).  The cost is a
// third product per tile, 1.5x the tensor-core work of a bf16 P.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace fa_wgmma {

constexpr int kBQ = 128;           // query rows per block
constexpr int kConsumers = 256;    // two consumer warpgroups
constexpr int kThreads = 384;      // and one producer warpgroup
constexpr int kPanel = 64;         // bf16 columns per 128-byte swizzled row
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Smem {                      // byte offsets from a 1024-aligned base
  static_assert(D % 16 == 0 && D <= 4 * kPanel, "d: a multiple of 16, at most 256");
  // keys per KV tile and the K/V ring's depth: at d = 256, Q (64 KB) and 3
  // stages of 128-key tiles (384 KB) would not fit a block's 227 KB
  static constexpr int kBK = D <= 2 * kPanel ? 128 : 64;
  static constexpr int kStages = D <= 2 * kPanel ? 3 : 2;
  static constexpr int kPanels = (D + kPanel - 1) / kPanel;
  static constexpr int kDP = kPanels * kPanel;            // the compute width
  static constexpr int kSteps = D / 16;                   // k-steps of S = Q.K^T
  static constexpr int kTailN = D - (kPanels - 1) * kPanel;   // the last panel's columns
  static constexpr int kQBytes = kBQ * kDP * 2;
  static constexpr int kTileBytes = kBK * kDP * 2;        // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;  // full[], empty[], q
  static constexpr int kAlloc = kBar + 8 * (2 * kStages + 1) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof u);
  return u;
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled operand tile: 128-byte rows, 8-row groups
// 1024 bytes apart.  That stride is the stride byte offset of every operand
// here (the next 8 rows of Q or K, the next 8 keys of the MN-major V).  The
// leading byte offset would step to the next 64 columns, which no product
// crosses (each reads within one 64-column panel); it is set to the same
// 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  constexpr uint64_t k1024 = 1024 >> 4;
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | (k1024 << 16) | (k1024 << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// named barriers 1 and 2 over the two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// ties the first N (by default all) accumulator registers to this point, so
// that no read of them is moved above the wait for the asynchronous product
// that writes them
template <int N = -1, int M>
__device__ __forceinline__ void fence_regs(float (&r)[M]) {
  constexpr int n = N < 0 ? M : N;
  static_assert(n <= M, "fence_regs: N > M");
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// operand lists of the wgmma accumulators: FA_R64(FA_ACC) reads and writes
// d[0..63], FA_R64(FA_SET) only writes them
#define FA_ACC(x) "+f"(x)
#define FA_SET(x) "=f"(x)
#define FA_R8(M, i) \
  M(d[i]), M(d[i + 1]), M(d[i + 2]), M(d[i + 3]), M(d[i + 4]), M(d[i + 5]), M(d[i + 6]), M(d[i + 7])
#define FA_R32(M) FA_R8(M, 0), FA_R8(M, 8), FA_R8(M, 16), FA_R8(M, 24)
#define FA_R64(M) FA_R32(M), FA_R8(M, 32), FA_R8(M, 40), FA_R8(M, 48), FA_R8(M, 56)

// d (64 x N, float32) = A (64 x 16, K-major, shared) . B (N x 16, K-major,
// shared)^T, plus d when ACC; N = 128 or 64
#define FA_SS_N128                                                                      \
  "{\n.reg .pred p;\n"                                                                  \
  "setp.ne.b32 p, %66, 0;\n"                                                            \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"      \
  "}, %64, %65, p, 1, 1, 0, 0;\n}\n"

#define FA_SS_N64                                                                       \
  "{\n.reg .pred p;\n"                                                                  \
  "setp.ne.b32 p, %34, 0;\n"                                                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"      \
  "}, %32, %33, p, 1, 1, 0, 0;\n}\n"

template <bool ACC, int M>
__device__ __forceinline__ void wgmma_ss(float (&d)[M], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (M == 64) {
    if constexpr (ACC)
      asm volatile(FA_SS_N128 : FA_R64(FA_ACC) : "l"(desc_a), "l"(desc_b), "r"(1));
    else
      asm volatile(FA_SS_N128 : FA_R64(FA_SET) : "l"(desc_a), "l"(desc_b), "r"(0));
  } else {
    static_assert(M == 32, "wgmma_ss: N in 128, 64");
    if constexpr (ACC)
      asm volatile(FA_SS_N64 : FA_R32(FA_ACC) : "l"(desc_a), "l"(desc_b), "r"(1));
    else
      asm volatile(FA_SS_N64 : FA_R32(FA_SET) : "l"(desc_a), "l"(desc_b), "r"(0));
  }
}

// d (64 x N, float32: the first N / 2 registers of an m64n64 fragment) += A
// (64 x 16 bf16, registers) . B (16 x N, MN-major, shared), N = 16, 32, 48 or
// 64
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_R32(FA_ACC)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8), FA_R8(FA_ACC, 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0), FA_R8(FA_ACC, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    static_assert(N == 16, "wgmma_rs: N in 16, 32, 48, 64");
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : FA_R8(FA_ACC, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

// ---------------------------------------------------------------- kernel
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, float* __restrict__ out32, int n_bh, int sq, int sk,
                int q_per_kv, int causal, int window, float scale_log2, int n_qt) {
  using L = Smem<D>;
  constexpr int NP = L::kPanels;
  constexpr int NT = L::kTailN;      // columns of the last panel that hold d
  constexpr int kBK = L::kBK, kStages = L::kStages;
  constexpr int SN = kBK / 2;        // S accumulator registers a thread
  constexpr float kNegInf = -INFINITY;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base + L::kQ, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t bar_full = base + L::kBar, bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int blk = (int)blockIdx.x;
  const int bh = blk % n_bh;
  const int q0 = (n_qt - 1 - blk / n_bh) * kBQ;
  // the KV tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window >= 0 ? max(0, q0 - window) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end + kBK - 1) / kBK - t_begin : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      const int kv = bh / q_per_kv;
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int p = 0; p < NP; ++p)
        tma_load_3d(s_q + p * kBQ * 128, &tm_q, bar_q, p * kPanel, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty + 8 * st, (it / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * L::kTileBytes);
        const int k0 = (t_begin + it) * kBK;
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(s_k + st * L::kTileBytes + p * kBK * 128, &tm_k, full, p * kPanel, k0, kv);
          tma_load_3d(s_v + st * L::kTileBytes + p * kBK * 128, &tm_v, full, p * kPanel, k0, kv);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int t4 = lane % 4;
    const int r_first = q0 + wg * 64;                  // this warpgroup's rows
    const int row = r_first + warp * 16 + lane / 4;    // this thread's: row, row + 8
    // accumulator fragment of an m64nN tile: element 4j + 2r + c is row
    // (row + 8r), column 8j + 2*t4 + c
    float o[NP][32], s[SN];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
    uint32_t p_hi[SN / 2], p_lo[SN / 2];
    const uint32_t q_wg = s_q + wg * 64 * 128;

    // S = Q K^T for tile it, issued and committed (not waited for)
    const auto s_product = [&](int it) {
      const uint32_t k_tile = s_k + (it % kStages) * L::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < L::kSteps; ++ks) {
        // panel ks / 4 (kBQ rows of Q, kBK of K), 16 columns (32 bytes) a step
        const int q_off = (ks / 4) * kBQ * 128 + (ks % 4) * 32;
        const int k_off = (ks / 4) * kBK * 128 + (ks % 4) * 32;
        if (ks == 0)
          wgmma_ss<false>(s, sw128_desc(q_wg + q_off), sw128_desc(k_tile + k_off));
        else
          wgmma_ss<true>(s, sw128_desc(q_wg + q_off), sw128_desc(k_tile + k_off));
      }
      wgmma_commit();
    };
    // the accumulator registers that hold columns below d: the whole panels'
    // 32 and the last panel's NT / 2
    const auto fence_o = [&]() {
#pragma unroll
      for (int p = 0; p + 1 < NP; ++p) fence_regs(o[p]);
      fence_regs<NT / 2>(o[NP - 1]);
    };
    // O *= alpha, before the P.V that adds the next tile
    const auto rescale_o = [&]() {
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (p + 1 < NP || i < NT / 2) o[p][i] *= alpha[(i / 2) % 2];
      fence_o();
    };
    // O += P_hi V + P_lo V for tile it, issued and committed
    const auto pv_product = [&](int it) {
      const uint32_t v_tile = s_v + (it % kStages) * L::kTileBytes;
      wgmma_fence();
      const auto pv = [&](const uint32_t (&pk)[SN / 2]) {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
#pragma unroll
          for (int p = 0; p + 1 < NP; ++p)
            wgmma_rs<kPanel>(o[p], a, sw128_desc(v_tile + p * kBK * 128 + kk * 2048));
          wgmma_rs<NT>(o[NP - 1], a,
                       sw128_desc(v_tile + (NP - 1) * kBK * 128 + kk * 2048));
        }
      };
      pv(p_hi);
      pv(p_lo);
      wgmma_commit();
    };
    // the online softmax of tile it's scores, in place: s becomes p; alpha
    // the factor the accumulator takes before this tile's P.V
    const auto softmax = [&](int it) {
      const int k0 = (t_begin + it) * kBK;
      const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > r_first) ||
                          (window >= 0 && k0 < r_first + 63 - window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < SN; ++i) {
          const int kp = k0 + 8 * (i / 4) + 2 * t4 + (i % 2), qp = row + 8 * ((i / 2) % 2);
          const bool ok = kp < sk && (!causal || kp <= qp) && (window < 0 || kp >= qp - window);
          s[i] = ok ? s[i] * scale_log2 : kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < SN; ++i) s[i] *= scale_log2;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < SN / 4; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float sub = m_new == kNegInf ? 0.f : m_new;   // a row with nothing valid yet
        alpha[r] = ex2(m[r] - sub);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < SN / 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(s[4 * j + 2 * r + c] - sub);
            s[4 * j + 2 * r + c] = p;
            sum += p;
          }
        l[r] = l[r] * alpha[r] + sum;
      }
    };
    // p = P_hi + P_lo, each packed as the A fragments of the P.V products
    const auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < SN / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
        const float2 hf = __bfloat1622float2(h);
        p_hi[i] = bf16x2_bits(h);
        p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(s[2 * i] - hf.x, s[2 * i + 1] - hf.y));
      }
    };

    // The two warpgroups take turns at the tensor cores (named barriers 1
    // and 2): each issues its next S and its current P.V back to back and
    // then hands over, so one's softmax runs while the other's products do.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (n_tiles > 0) {
      mbar_wait(bar_q, 0);
      if (wg == 1) named_arrive(1);                    // warpgroup 0 goes first
      mbar_wait(bar_full, 0);
      named_sync(my_turn);
      s_product(0);
      named_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0);
      pack_p();
    }
    // every tile but the last: S of the next tile and P.V of this one in
    // one turn, the next softmax while this P.V runs
    for (int it = 0; it + 1 < n_tiles; ++it) {
      mbar_wait(bar_full + 8 * ((it + 1) % kStages), ((it + 1) / kStages) & 1);
      rescale_o();
      named_sync(my_turn);
      s_product(it + 1);
      pv_product(it);
      named_arrive(their_turn);
      wgmma_wait<1>();                                 // S of tile it + 1
      fence_regs(s);
      softmax(it + 1);
      wgmma_wait<0>();                                 // P.V of tile it
      fence_o();
      mbar_arrive(bar_empty + 8 * (it % kStages));
      pack_p();
    }
    if (n_tiles > 0) {                                 // the last tile's P.V
      rescale_o();
      named_sync(my_turn);
      pv_product(n_tiles - 1);
      if (wg == 0) named_arrive(their_turn);           // warpgroup 1 hands over to no one
      wgmma_wait<0>();
      fence_o();
    }

    // o / l, rounded once to bf16, the first d columns of a row; rows past sq
    // are not stored.  For the backward (FlashAttentionFn), when the pointers
    // are given: each row's log-sum-exp in log2 units, m + log2 l (+inf for a
    // row with no valid key, so that the backward's exp2(s - lse) is 0), and
    // o / l in float32 before the rounding (the backward's D = rowsum(dO o)
    // needs it: from the bf16 output a third or more of the gradient's bf16
    // elements would differ, tests/test_torch_flash_bwd.py)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(kFull, lr, 1);
      lr += __shfl_xor_sync(kFull, lr, 2);
      const int qp = row + 8 * r;
      if (qp < sq) {
        const long long at = (long long)bh * sq + qp;
        if (lse != nullptr && t4 == 0) lse[at] = lr > 0.f ? m[r] + log2f(lr) : INFINITY;
        __nv_bfloat16* orow = out + at * D;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (p * kPanel + 8 * j >= D) continue;
            const float a = lr > 0.f ? o[p][4 * j + 2 * r] / lr : 0.f;
            const float b = lr > 0.f ? o[p][4 * j + 2 * r + 1] / lr : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(orow + p * kPanel + 8 * j + 2 * t4) =
                __floats2bfloat162_rn(a, b);
            if (out32 != nullptr)
              *reinterpret_cast<float2*>(out32 + at * D + p * kPanel + 8 * j + 2 * t4) =
                  make_float2(a, b);
          }
      }
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; the library links nothing, so
// it is looked up in the driver that the CUDA runtime has already loaded
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// host-side refusals, below every cudaError_t
constexpr int kNoDriverEntry = -1;
constexpr int kEncodeFailed = -1000;   // minus the CUresult

// a (rows, s, d) bf16 tensor in boxes of 64 columns x box_rows rows x 1,
// 128-byte swizzle, zero fill past its edges (the last box of a row past d,
// when d is not a multiple of 64, and at d = 16 or 32 the only box, wider
// than the row: its row stride, 2d bytes, is a multiple of 16 for d a
// multiple of 8, as TMA needs)
inline int make_map(CUtensorMap* map, const void* ptr, long long rows, int s, int d,
                    int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kNoDriverEntry;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, void* out32,
           long long n_bh, int sq, int sk, int q_per_kv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  static bool opted_in = false;      // per instantiation, once per process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long grid = (long long)n_qt * n_bh;
  if (sk < 1 || n_bh > 0x7fffffffLL || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = make_map(&tm_q, q, n_bh, sq, D, kBQ);
  if (rc == 0) rc = make_map(&tm_k, k, n_bh / q_per_kv, sk, D, Smem<D>::kBK);
  if (rc == 0) rc = make_map(&tm_v, v, n_bh / q_per_kv, sk, D, Smem<D>::kBK);
  if (rc != 0) return rc;
  fa_wgmma_kernel<D><<<(unsigned)grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      static_cast<float*>(out32), (int)n_bh, sq, sk, q_per_kv, causal, window,
      scale * 1.4426950408889634f, n_qt);
  return (int)cudaGetLastError();
}

}  // namespace fa_wgmma
