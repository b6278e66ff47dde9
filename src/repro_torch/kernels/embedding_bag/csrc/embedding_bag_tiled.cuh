// embedding_bag's tiled route for Hopper (sm_90a): a tile's distinct rows
// served from shared memory.  Included by embedding_bag.cu, after
// Vec<T, VEC>.
//
// The per-bag kernel (embedding_bag.cu) fetches every lookup's row from L2,
// from many SMs at once.  The offline path's lookups are Zipf-skewed: at the
// paper's draw a thousand rows serve 85 % of the lookups, and inside a tile
// of 64 consecutive bags the distinct rows are about 37 % of the lookups.
// So here a block takes a tile of bags and:
//   1. stages the tile's weights (at most kTileLookups lookups) in shared
//      memory;
//   2. finds the tile's distinct rows with a shared-memory hash table
//      (open addressing, atomicCAS), counting each row's lookups;
//   3. bumps each distinct row's block counter once, by its count (exact:
//      int32 atomics in any order), and gives the distinct rows places on
//      chip -- rows looked up three times or more first, then twice, then
//      once -- up to kResident of them.  Rows past kResident (uniform ids
//      are the worst case) are read from global memory as the per-bag
//      kernel reads them, so a tile always finishes on this route;
//   4. for each 128-byte column slice of the rows, copies the resident
//      rows' slices into shared memory (cp.async, 16 bytes a lane, eight
//      lanes a slice), then each group of 8 lanes pools one bag, 16 bytes a
//      lane, reading its lookups' places and weights four at a time.
// Three blocks share an SM, so one block's copies overlap the others'
// pooling.  Each bag accumulates l = 0 .. L-1 in order in f32 registers
// with the per-bag kernel's fused multiply-add, rounded once to T, so the
// two routes give the same bits.  Designs that were timed against this one
// and were slower: a 1-D bulk copy (cp.async.bulk + mbarrier) per slice,
// two stages of copies, and column slices kept in L1.
//
// Bound: bytes, as the per-bag kernel's; what moves is the L2 -> SM traffic,
// one row slice per distinct row of a tile instead of one per lookup.

#include <stdint.h>

namespace {

constexpr int kTileThreads = 512;    // three blocks an SM
constexpr int kTileLookups = 1024;   // lookups a tile takes: L <= this
constexpr int kResident = 384;       // row slices a tile keeps on chip
constexpr int kHashBits = 11;        // 2,048 slots: at most half full
constexpr int kHashSlots = 1 << kHashBits;
constexpr int kSliceBytes = 128;     // 8 lanes x 16 bytes
constexpr int kGroupLanes = kSliceBytes / 16;
constexpr int kEmpty = -1;
constexpr int kOff = -1;             // no place: read from global memory
constexpr int kTwice = -2;           // looked up twice: placed second
constexpr int kOnce = -3;            // looked up once: placed last

struct TileSmem {
  alignas(128) unsigned char stage[kResident * kSliceBytes];
  alignas(16) float w[kTileLookups];
  int hash_row[kHashSlots];
  int hash_val[kHashSlots];        // lookups, then the place or kOff
  // a lookup's hash slot h, then its place, or -(h + 2) when it has none
  alignas(16) short where[kTileLookups];
  int res_row[kResident];
  int n_res;
};

// 16 bytes of T as floats (the same conversions as Vec<T, VEC>::load)
template <typename T> struct Bits;

template <> struct Bits<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void to_float(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
  }
};

template <> struct Bits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void to_float(const uint4& v, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x; x[2 * j + 1] = f.y;
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 3)
embedding_bag_tiled_kernel(const T* __restrict__ storage,
                           const int* __restrict__ idx,
                           const float* __restrict__ w, long long n_bags,
                           int bag_len, int dim, int block_rows,
                           int* __restrict__ counts, T* __restrict__ out) {
  constexpr int VEC = Bits<T>::kVec;
  constexpr int kSliceElems = kSliceBytes / (int)sizeof(T);
  constexpr int kGroups = kTileThreads / kGroupLanes;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int group = tid / kGroupLanes, gl = tid % kGroupLanes;
  const int bags_per_tile = kTileLookups / bag_len;
  const long long n_tiles = (n_bags + bags_per_tile - 1) / bags_per_tile;
  const int n_slices = dim / kSliceElems;
  const bool quads = bag_len % 4 == 0;   // a bag's entries 16-byte aligned
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b0 = tile * bags_per_tile;
    const int nb = (int)(n_bags - b0 < bags_per_tile ? n_bags - b0 : bags_per_tile);
    const int m = nb * bag_len;
    // 1. the tile's weights; an empty table
    for (int i = tid; i < kHashSlots; i += kTileThreads) {
      sm.hash_row[i] = kEmpty;
      sm.hash_val[i] = 0;
    }
    if (tid == 0) sm.n_res = 0;
    for (int i = tid; i < m; i += kTileThreads) sm.w[i] = __ldg(w + b0 * bag_len + i);
    __syncthreads();
    // 2. distinct rows and their lookups
    for (int i = tid; i < m; i += kTileThreads) {
      const int row = __ldg(idx + b0 * bag_len + i);
      unsigned h = ((unsigned)row * 2654435761u) >> (32 - kHashBits);
      for (;;) {
        const int prev = atomicCAS(&sm.hash_row[h], kEmpty, row);
        if (prev == kEmpty || prev == row) break;
        h = (h + 1) & (kHashSlots - 1);
      }
      atomicAdd(&sm.hash_val[h], 1);
      sm.where[i] = (short)h;
    }
    __syncthreads();
    // 3. counters once per distinct row; places on chip, most-used first
    for (int h = tid; h < kHashSlots; h += kTileThreads) {
      const int row = sm.hash_row[h];
      if (row == kEmpty) continue;
      const int c = sm.hash_val[h];
      atomicAdd(counts + row / block_rows, c);
      int r = c == 2 ? kTwice : kOnce;
      if (c >= 3) {
        r = atomicAdd(&sm.n_res, 1);
        if (r < kResident) sm.res_row[r] = row; else r = kOff;
      }
      sm.hash_val[h] = r;
    }
    for (int round = kTwice; round >= kOnce; --round) {
      __syncthreads();
      for (int h = tid; h < kHashSlots; h += kTileThreads) {
        if (sm.hash_row[h] == kEmpty || sm.hash_val[h] != round) continue;
        int r = atomicAdd(&sm.n_res, 1);
        if (r < kResident) sm.res_row[r] = sm.hash_row[h]; else r = kOff;
        sm.hash_val[h] = r;
      }
    }
    __syncthreads();
    for (int i = tid; i < m; i += kTileThreads) {
      const int h = sm.where[i];
      const int r = sm.hash_val[h];
      sm.where[i] = (short)(r >= 0 ? r : -(h + 2));
    }
    const int n_res = sm.n_res < kResident ? sm.n_res : kResident;
    __syncthreads();
    // 4. per column slice: resident slices on chip, then every bag pooled
    for (int sl = 0; sl < n_slices; ++sl) {
      const int c0 = sl * kSliceElems;
      // each group of 8 lanes copies one row slice at a time, 16 bytes a
      // lane, straight into shared memory
      for (int r = group; r < n_res; r += kGroups) {
        const T* src = storage + (long long)sm.res_row[r] * dim + c0 + gl * VEC;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_addr(sm.stage + r * kSliceBytes + gl * 16)),
                     "l"(src)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      for (int bb = group; bb < nb; bb += kGroups) {
        const int base = bb * bag_len;
        float acc[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
        for (int l0 = 0; l0 < bag_len; l0 += 4) {
          int r[4];
          float wl[4];
          if (quads) {             // four places and weights in two loads
            const short4 rv = *reinterpret_cast<const short4*>(sm.where + base + l0);
            const float4 wv = *reinterpret_cast<const float4*>(sm.w + base + l0);
            r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
            wl[0] = wv.x; wl[1] = wv.y; wl[2] = wv.z; wl[3] = wv.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              r[j] = l0 + j < bag_len ? sm.where[base + l0 + j] : 0;
              wl[j] = l0 + j < bag_len ? sm.w[base + l0 + j] : 0.f;
            }
          }
          uint4 bits[4];
          // four loads in flight, then the sums in order
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (l0 + j >= bag_len) break;
            if (r[j] >= 0) {
              bits[j] = *reinterpret_cast<const uint4*>(
                  sm.stage + r[j] * kSliceBytes + gl * 16);
            } else {
              const long long row = sm.hash_row[-r[j] - 2];
              bits[j] = __ldg(reinterpret_cast<const uint4*>(
                  storage + row * dim + c0 + gl * VEC));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (l0 + j >= bag_len) break;
            float x[VEC];
            Bits<T>::to_float(bits[j], x);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = __fmaf_rn(wl[j], x[v], acc[v]);
          }
        }
        Vec<T, VEC>::store(out + (b0 + bb) * dim + c0 + gl * VEC, acc);
      }
      __syncthreads();   // the stage is read before the next slice lands
    }
  }
}

template <typename T>
int launch_tiled(const void* storage, const int* idx, const float* w,
                 long long n_bags, int bag_len, int dim, int block_rows,
                 int* counts, void* out, cudaStream_t s) {
  constexpr int kSliceElems = kSliceBytes / (int)sizeof(T);
  if (bag_len < 1 || bag_len > kTileLookups || dim % kSliceElems != 0 ||
      (reinterpret_cast<uintptr_t>(storage) & 15u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (int)sizeof(TileSmem);
  cudaFuncSetAttribute(embedding_bag_tiled_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, embedding_bag_tiled_kernel<T>, kTileThreads, smem);
  per_sm = per_sm < 1 ? 1 : per_sm;
  const long long bags_per_tile = kTileLookups / bag_len;
  const long long n_tiles = (n_bags + bags_per_tile - 1) / bags_per_tile;
  long long grid = (long long)per_sm * sms;
  grid = grid > n_tiles ? n_tiles : grid;
  grid = grid < 1 ? 1 : grid;
  embedding_bag_tiled_kernel<T><<<(unsigned)grid, kTileThreads, smem, s>>>(
      static_cast<const T*>(storage), idx, w, n_bags, bag_len, dim, block_rows,
      counts, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace
