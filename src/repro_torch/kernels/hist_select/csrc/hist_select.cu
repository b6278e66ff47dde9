// hist_select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hist_select/kernel.py
// (_kernel, kth_key_u_pallas): for each (row b, segment s), the k-th
// largest uint32 key -- the largest t with count(u >= t) >= ks[s] among the
// segment's elements -- found in 4 byte-level radix passes.  ks[s] == 0
// gives 0xFFFFFFFF; segment id -1 (or any id outside [0, S)) is padding.
//
// Keys arrive as the int32 selection keys; u = bits(key) ^ 0x80000000 is the
// order-preserving uint32 image (selectk._to_u), formed in registers.
//
// The TPU kernel carries an (S, 256) f32 histogram across a sequential grid
// and fills it with a one-hot matmul; the f32 type and its 2**23 element
// bound are artefacts of the matrix unit.  Here the counts are int32, and
// per byte level two kernels run back to back on the stream, with no host
// round trip between levels:
//   * hs_hist: each block builds (S, 256) int32 bins in shared memory over
//     its chunk of one row, counting only keys that match the (row,
//     segment)'s resolved prefix (lanes with the same bin add once, via
//     __match_any_sync: most keys of a sparse epoch delta are 0), then adds
//     them atomically into the global (B, S, 256) buffer;
//   * hs_resolve: one thread per (row, segment) cumulates from bin 255 down,
//     takes the largest j with count(byte >= j) >= k_rem, ORs j into the
//     prefix, subtracts the count above j from k_rem, and re-zeroes its
//     bins for the next level.
// After level 3 the prefix is the threshold.
//
// Bound: bytes.  The work needs the B x n keys read once (4 passes read
// them 4 times: the 105 MB of a paper-scale call does not fit an H100's
// 50 MB L2).
//
// The C entry point launches on the caller's stream, allocates nothing (the
// wrapper passes the (B, S) int64 output, (B, S) int32 k_rem and (B, S, 256)
// int32 bins) and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kResolveThreads = 128;

__device__ __forceinline__ void warp_add(int* bins, int bin, bool valid) {
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? bin : -1);
  if (valid && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(bins + bin, __popc(peers));
  }
}

__global__ void hs_init(const int* __restrict__ ks, int rows, int segs,
                        long long* __restrict__ prefix, int* __restrict__ krem,
                        int* __restrict__ bins) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cells = (long long)rows * segs;
  for (long long i = t0; i < cells * 256; i += stride) bins[i] = 0;
  for (long long i = t0; i < cells; i += stride) {
    prefix[i] = 0;
    krem[i] = ks[i % segs];
  }
}

__global__ void __launch_bounds__(kThreads)
hs_hist(const int* __restrict__ keys, const int* __restrict__ seg, long long n,
        int segs, int level, const long long* __restrict__ prefix,
        int* __restrict__ bins) {
  extern __shared__ int sh[];  // segs * 256 bins, then segs prefixes
  unsigned* pre = reinterpret_cast<unsigned*>(sh + segs * 256);
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < segs * 256; i += blockDim.x) sh[i] = 0;
  for (int i = threadIdx.x; i < segs; i += blockDim.x) {
    pre[i] = (unsigned)prefix[(long long)b * segs + i];
  }
  __syncthreads();
  const unsigned shift = 8u * (3 - level);
  const unsigned hi_mask = level == 0 ? 0u : (0xFFFFFFFFu << (32 - 8 * level));
  const int* row = keys + (long long)b * n;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    const bool in = i < n;
    const int s = in ? (seg != nullptr ? seg[i] : 0) : -1;
    const unsigned u = in ? ((unsigned)row[i] ^ 0x80000000u) : 0u;
    const bool valid = s >= 0 && s < segs && (u & hi_mask) == pre[s];
    warp_add(sh, valid ? s * 256 + (int)((u >> shift) & 0xFFu) : 0, valid);
  }
  __syncthreads();
  int* out = bins + (long long)b * segs * 256;
  for (int i = threadIdx.x; i < segs * 256; i += blockDim.x) {
    if (sh[i]) atomicAdd(out + i, sh[i]);
  }
}

__global__ void hs_resolve(int cells, int level, long long* __restrict__ prefix,
                           int* __restrict__ krem, int* __restrict__ bins) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cells) return;
  int* h = bins + (long long)t * 256;
  const int k = krem[t];
  long long cum = 0, above = 0;
  int j = 255;
  for (; j >= 0; --j) {
    if (cum + h[j] >= k) {
      above = cum;
      break;
    }
    cum += h[j];
  }
  if (j < 0) {  // k exceeds the segment: the reference degenerates to bin 0
    j = 0;
    above = cum - h[0];
  }
  krem[t] = k - (int)above;
  prefix[t] |= (long long)j << (8 * (3 - level));
  for (int i = 0; i < 256; ++i) h[i] = 0;
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

}  // namespace

extern "C" {

// Most segments one call takes: (S, 256) bins plus S prefixes in shared memory.
int hist_select_max_segments() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) /
         (257 * (int)sizeof(int));
}

int hist_select_launch(const int* keys, const int* seg, const int* ks, int rows,
                       long long n, int segs, long long* out, int* krem,
                       int* bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long cells = (long long)rows * segs;
  long long init_grid = (cells * 256 + kThreads - 1) / kThreads;
  init_grid = init_grid > 4 * sms ? 4 * sms : init_grid;
  hs_init<<<(unsigned)init_grid, kThreads, 0, s>>>(ks, rows, segs, out, krem,
                                                   bins);
  const size_t smem = (size_t)segs * 257 * sizeof(int);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(hs_hist, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  // about four blocks per SM over all rows, never more than the row needs
  long long gx = (4 * sms + rows - 1) / rows;
  const long long need = (n + kThreads - 1) / kThreads;
  gx = gx > need ? need : gx;
  gx = gx < 1 ? 1 : gx;
  const dim3 grid((unsigned)gx, (unsigned)rows);
  const unsigned rgrid = (unsigned)((cells + kResolveThreads - 1) / kResolveThreads);
  for (int level = 0; level < 4; ++level) {
    hs_hist<<<grid, kThreads, smem, s>>>(keys, seg, n, segs, level, out, bins);
    hs_resolve<<<rgrid, kResolveThreads, 0, s>>>((int)cells, level, out, krem,
                                                 bins);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
