// embedding_bag for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (_kernel, embedding_bag_pallas): the DLRM batched embedding bag with the
// HMU's block counters bumped in the same pass,
//   out[b]  = (T) sum_{l < L} w[b, l] * storage[idx[b, l]]   (f32 accumulate)
//   counts[idx[b, l] / block_rows] += 1                       for every (b, l)
// for 0 <= idx < N (the TPU kernel's DMA domain; not checked here, since a
// check would need a host sync).  T is float32 or bfloat16; the sum is
// rounded to T once, at the end (__float2bfloat16_rn for bf16).
//
// The TPU kernel takes one bag per sequential grid step, fetches its L rows
// with L async copies and pools them as a (1, L) x (L, D) product on the
// matrix unit.  A bag is a weighted sum of L rows: far too little work per
// byte for the tensor cores, so here:
// Two routes compute it (the wrapper's kernel.route picks one from the dtype,
// D, L and alignment): the tiled route (embedding_bag_tiled.cuh), which
// serves a tile's repeated rows from shared memory, and this per-bag kernel
// for the shapes the tiled route does not take:
//   * one warp per bag (grid-stride over bags); the warp loads up to 32 of
//     the bag's ids and weights at once (lane l holds entry l) and
//     broadcasts each with __shfl_sync;
//   * each lane owns VEC consecutive columns (16-byte loads: 4 f32 or 8
//     bf16 when the row allows, else 1) and walks the columns in chunks of
//     32 * VEC, accumulating l = 0 .. L-1 in order in f32 registers (one
//     fused multiply-add each, as the tiled route), so the registers a lane
//     needs do not grow with D;
//   * the counters take warp-aggregated int32 atomics (lanes holding the
//     same block add once, __match_any_sync): exact in any order;
//   * element offsets are 64-bit (row * D overflows int32 at the paper's
//     21.8 M x 256 storage).
//
// Bound: bytes.  Per paper-scale batch (B = 150,000 bags of L = 16, 1 KiB
// f32 rows) it reads 2.46 GB of rows and 19.2 MB of ids and weights and
// writes 154 MB of pooled rows.
//
// The C entry point launches on the caller's stream, allocates nothing (the
// wrapper passes the output and the counts to add into) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// VEC consecutive elements of T <-> floats
template <typename T, int VEC> struct Vec;

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* x) { x[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float* x) { p[0] = x[0]; }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    x[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
    p[0] = __float2bfloat16_rn(x[0]);
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x; x[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* x) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = __halves2bfloat162(__float2bfloat16_rn(x[2 * j]),
                                __float2bfloat16_rn(x[2 * j + 1]));
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

}  // namespace

#include "embedding_bag_tiled.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ storage, const int* __restrict__ idx,
                     const float* __restrict__ w, long long n_bags, int bag_len,
                     int dim, int block_rows, int* __restrict__ counts,
                     T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // every loop bound below is warp-uniform, so the full-mask shuffles and
  // __match_any_sync are well defined
  for (long long b = warp; b < n_bags; b += n_warps) {
    const int* ib = idx + b * bag_len;
    const float* wb = w + b * bag_len;
    for (int l0 = 0; l0 < bag_len; l0 += 32) {
      const bool in = l0 + lane < bag_len;
      const int blk = in ? ib[l0 + lane] / block_rows : -1;
      const unsigned peers = __match_any_sync(kFull, blk);
      if (in && lane == __ffs(peers) - 1) atomicAdd(counts + blk, __popc(peers));
    }
    for (int c_base = 0; c_base < dim; c_base += 32 * VEC) {
      const int c = c_base + lane * VEC;
      const bool active = c < dim;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
      for (int l0 = 0; l0 < bag_len; l0 += 32) {
        const bool in = l0 + lane < bag_len;
        const int my_row = in ? ib[l0 + lane] : 0;
        const float my_w = in ? wb[l0 + lane] : 0.f;
        const int n_here = bag_len - l0 < 32 ? bag_len - l0 : 32;
#pragma unroll 4
        for (int j = 0; j < n_here; ++j) {
          const long long row = __shfl_sync(kFull, my_row, j);
          const float wj = __shfl_sync(kFull, my_w, j);
          if (active) {
            float x[VEC];
            Vec<T, VEC>::load(storage + row * dim + c, x);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = __fmaf_rn(wj, x[v], acc[v]);
          }
        }
      }
      if (active) Vec<T, VEC>::store(out + b * dim + c, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const void* storage, const int* idx, const float* w, long long n_bags,
           int bag_len, int dim, int block_rows, int* counts, void* out,
           cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long warps_per_block = kThreads / 32;
  long long grid = (n_bags + warps_per_block - 1) / warps_per_block;
  const long long cap = 16LL * sms;
  grid = grid < 1 ? 1 : (grid > cap ? cap : grid);
  embedding_bag_kernel<T, VEC><<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const T*>(storage), idx, w, n_bags, bag_len, dim, block_rows,
      counts, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per load (f32: 4 or 1,
// bf16: 8 or 1), chosen by the wrapper so that a 16-byte load never
// straddles a row end or a misaligned address.
int embedding_bag_launch(const void* storage, const int* idx, const float* w,
                         long long n_bags, int bag_len, int dim, int dtype,
                         int vec, int block_rows, int* counts, void* out,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(storage, idx, w, n_bags, bag_len, dim, block_rows, counts, out, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(storage, idx, w, n_bags, bag_len, dim, block_rows, counts, out, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(storage, idx, w, n_bags, bag_len, dim, block_rows, counts, out, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(storage, idx, w, n_bags, bag_len, dim, block_rows, counts, out, s);
  return (int)cudaErrorInvalidValue;
}

// The tiled route: 16-byte aligned storage and out, D * sizeof(T) a multiple
// of 128 bytes, 1 <= L <= 1,024 (else cudaErrorInvalidValue).
int embedding_bag_tiled_launch(const void* storage, const int* idx,
                               const float* w, long long n_bags, int bag_len,
                               int dim, int dtype, int block_rows, int* counts,
                               void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tiled<float>(storage, idx, w, n_bags, bag_len, dim, block_rows, counts, out, s);
  if (dtype == 1)
    return launch_tiled<__nv_bfloat16>(storage, idx, w, n_bags, bag_len, dim, block_rows, counts, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
