// gather_count for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gather_count/kernel.py
// (_kernel, gather_count_pallas): the tier-aware row gather with the HMU's
// memory-side block counters bumped in the same pass,
//   out[i]                      = storage[idx[i]]      (a plain row copy)
//   counts[idx[i] / block_rows] += 1
// for 0 <= idx[i] < N (the TPU kernel's DMA domain; not checked here, since
// a check would need a host sync).
//
// The TPU kernel walks tiles of 128 ids on a sequential grid with the
// counters in VMEM, so its wrapper pads M to the tile and subtracts the
// phantom counts.  Here:
//   * a warp takes 32 ids at a time with one coalesced load, bumps their
//     counters with warp-aggregated int32 atomics (lanes holding the same
//     block add once, __match_any_sync: Zipf heads repeat), then copies the
//     32 rows one after another, the whole warp on each row;
//   * a row copy is dtype-blind: it moves bytes in the widest unit V (16, 4
//     or 2 bytes) that divides the row and both base addresses, which the
//     host picks -- 16-byte vector copies for every D whose row is a
//     multiple of 16 bytes (D = 256: 1 KiB f32 / 512 B bf16 rows);
//   * there is no tile, so no padding and no fix-up: any M, 0 and 1
//     included.  int32 atomics give the same counts in any order and the
//     rows are copies, so both outputs are exact.
//   * element and byte offsets are 64-bit: at the paper's width storage has
//     21.8 M rows x 256, and row * D overflows int32.
//
// Bound: bytes.  Per paper-scale batch (2.4 M ids, 1 KiB rows) it reads
// 2.46 GB of rows and 9.6 MB of ids and writes 2.46 GB of rows.
//
// The C entry point launches on the caller's stream, allocates nothing (the
// wrapper passes the output and the counts to add into) and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_count_kernel(const V* __restrict__ storage, const int* __restrict__ idx,
                    long long m, long long row_units, int block_rows,
                    int* __restrict__ counts, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // warp-uniform trip counts: every lane runs every iteration, so the
  // full-mask __match_any_sync / __shfl_sync below are well defined
  for (long long base = warp * 32; base < m; base += n_warps * 32) {
    const long long i = base + lane;
    const bool in = i < m;
    const int row = in ? idx[i] : 0;
    const int blk = row / block_rows;
    const unsigned peers = __match_any_sync(kFull, in ? blk : -1);
    if (in && lane == __ffs(peers) - 1) atomicAdd(counts + blk, __popc(peers));
    const int n_here = (int)(m - base < 32 ? m - base : 32);
#pragma unroll 4
    for (int r = 0; r < n_here; ++r) {
      const long long src_row = __shfl_sync(kFull, row, r);
      const V* src = storage + src_row * row_units;
      V* dst = out + (base + r) * row_units;
      for (long long u = lane; u < row_units; u += 32) dst[u] = src[u];
    }
  }
}

template <typename V>
int launch(const void* storage, const int* idx, long long m, long long row_bytes,
           int block_rows, int* counts, void* out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long warps_per_block = kThreads / 32;
  long long grid = (m + 32 * warps_per_block - 1) / (32 * warps_per_block);
  const long long cap = 16LL * sms;
  grid = grid < 1 ? 1 : (grid > cap ? cap : grid);
  gather_count_kernel<V><<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const V*>(storage), idx, m, row_bytes / (long long)sizeof(V),
      block_rows, counts, static_cast<V*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// unit: the copy width in bytes (16, 4 or 2), chosen by the wrapper so that
// it divides row_bytes and both base addresses.
int gather_count_launch(const void* storage, const int* idx, long long m,
                        long long row_bytes, int unit, int block_rows,
                        int* counts, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch<int4>(storage, idx, m, row_bytes, block_rows, counts, out, s);
    case 4: return launch<int>(storage, idx, m, row_bytes, block_rows, counts, out, s);
    case 2: return launch<short>(storage, idx, m, row_bytes, block_rows, counts, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
