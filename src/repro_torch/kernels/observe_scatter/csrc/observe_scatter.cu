// observe_scatter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/observe_scatter/kernel.py
// (_kernel, observe_scatter_pallas): one pass over a batch's block-id stream
// yields the access histogram and the PEBS-sampled histogram that every
// collector update of the epoch observe path is an affine function of.
//
// Per id (exactly the reference's `.at[ids].add(..., mode="drop")`):
//   * a negative id wraps once (id + n_blocks); anything still outside
//     [0, n_blocks) is skipped -- so n_blocks works as a padding id;
//   * hist[id] += 1;
//   * pebs[id] += 1 iff (cursor + pos) % period == 0 in int32 and, when a
//     keep mask is given, keep[pos] != 0.
//
// The TPU kernel walks a sequential grid with both histograms resident in
// VMEM.  On the card the blocks run in parallel, in no order, so:
//   * every block walks the id stream with a warp-uniform grid-stride loop
//     and bumps counts with int32 atomics, which give the same exact counts
//     in any order;
//   * lanes of a warp that hold the same id add their count once
//     (__match_any_sync), which is what keeps a Zipf-hot page -- a quarter
//     of a DLRM batch lands on the hottest one -- from serialising the warp;
//   * where 2 * n_blocks * 4 B fits a block's shared memory (227 KB on an
//     H100: about 29 K blocks), each block privatises both histograms there
//     and adds them to device memory at the end; above that the atomics go
//     straight into the zeroed outputs (the paper-scale path).
//
// Bound: bytes.  Per paper-scale batch (2.4 M ids, 5,242,880 blocks) it
// reads 9.6 MB of ids and writes 2 x 21 MB of histograms.
//
// The C entry point launches on the caller's stream, allocates nothing (the
// wrapper passes zeroed outputs) and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void warp_add(int* hist, int bin, bool valid) {
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? bin : -1);
  if (valid && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(hist + bin, __popc(peers));
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
observe_scatter_kernel(const int* __restrict__ ids,
                       const unsigned char* __restrict__ keep,
                       const int* __restrict__ cursor_ptr, long long m,
                       int n_blocks, int period, int* __restrict__ hist,
                       int* __restrict__ pebs) {
  extern __shared__ int smem[];
  int* h = kShared ? smem : hist;
  int* p = kShared ? smem + n_blocks : pebs;
  if (kShared) {
    for (int i = threadIdx.x; i < 2 * n_blocks; i += blockDim.x) smem[i] = 0;
    __syncthreads();
  }
  const int cursor = *cursor_ptr;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // warp-uniform trip count: every lane of a warp runs every iteration, so
  // the full-mask __match_any_sync above is well defined
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < m; base += stride) {
    const long long i = base + lane;
    const bool in = i < m;
    int blk = in ? ids[i] : -1;
    if (blk < 0) blk += n_blocks;
    const bool valid = in && blk >= 0 && blk < n_blocks;
    warp_add(h, blk, valid);
    if (valid) {
      // int32 stream position, wrapping like the reference's int32 add
      const int pos = (int)((unsigned)cursor + (unsigned)i);
      bool hit = pos % period == 0;  // zero remainder: same for C and floor mod
      if (keep != nullptr) hit = hit && keep[i] != 0;
      if (hit) atomicAdd(p + blk, 1);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_blocks; i += blockDim.x) {
      if (smem[i]) atomicAdd(hist + i, smem[i]);
      if (smem[n_blocks + i]) atomicAdd(pebs + i, smem[n_blocks + i]);
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

}  // namespace

extern "C" {

// Largest n_blocks whose two histograms fit one block's shared memory.
int observe_scatter_shared_limit() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) /
         (2 * (int)sizeof(int));
}

int observe_scatter_launch(const int* ids, const unsigned char* keep,
                           const int* cursor, long long m, int n_blocks,
                           int period, int* hist, int* pebs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  if (n_blocks <= observe_scatter_shared_limit()) {
    const size_t smem = 2 * (size_t)n_blocks * sizeof(int);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(observe_scatter_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    // few blocks: each one zeroes and flushes a whole private histogram
    long long grid = (m + kThreads * 16 - 1) / (kThreads * 16);
    grid = grid < 1 ? 1 : (grid > 2 * sms ? 2 * sms : grid);
    observe_scatter_kernel<true><<<(unsigned)grid, kThreads, smem, s>>>(
        ids, keep, cursor, m, n_blocks, period, hist, pebs);
  } else {
    long long grid = (m + kThreads - 1) / kThreads;
    grid = grid < 1 ? 1 : (grid > 8 * sms ? 8 * sms : grid);
    observe_scatter_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(
        ids, keep, cursor, m, n_blocks, period, hist, pebs);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
