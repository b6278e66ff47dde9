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
// Bound: bytes.  Per paper-scale batch (2.4 M ids, 5,242,880 blocks) it
// reads 9.6 MB of ids and writes 2 x 21 MB of histograms (the wrapper's
// zeroing, about 13 us of the 15 us).
//
// What holds a scatter of global atomics far from that bound is atomics
// that meet: the paper's draw (Zipf 1.31) puts a quarter of a batch on one
// page and 72 % on 32, and atomics on one address serialise in the L2
// slice that owns it.  So every block sums its share of the stream on chip
// before it writes:
//   * a persistent grid of at most kBlocksPerSm blocks an SM, each on one
//     contiguous chunk of whole 16-byte vectors (no fewer than kMinChunk
//     ids), read 16 bytes a lane, the next round's vector loaded before
//     this one's ids are observed; the scalar head before the first 16-byte
//     boundary and the tail after the last whole vector are one round of
//     block 0's first warp;
//   * lanes of a warp that hold the same id merge first (__match_any_sync),
//     so one lane per distinct id touches the table;
//   * the table lives in shared memory, in one of two modes:
//       direct, where 2 * n_blocks ints fit (n_blocks <= kDirectMaxBins):
//         slot = id, no key, no probe; each block zeroes and flushes the
//         whole table, 16 bytes a lane, which costs less than the scatter
//         rounds that fewer, larger chunks would leave each block (SMALL's
//         5,000 bins: 20 blocks of 2,000 ids beat 4 of 10,000 by 3x);
//       hashed, otherwise: 1 << kSlotBits open-addressed (id, count, sampled
//         count) slots; the inserting lane claims or finds its slot by
//         atomicCAS on the key, re-reading what a failed CAS found, over at
//         most kProbes slots; an id that finds none sends its counts
//         straight to the outputs -- exact all the same, since integer adds
//         commute;
//   * after __syncthreads(), each used slot sends one atomicAdd per
//     non-zero count: the hottest page takes one atomic per block, not one
//     per warp round;
//   * a hashed block whose first round (1,024 ids) claimed more than
//     kFirstRoundClaims slots holds mostly distinct ids (uniform streams,
//     the mmap benchmark's hot region), where claiming only adds work: it
//     claims no more slots.  An id already in the table still adds there;
//     one that meets an empty slot first is not in it and goes straight
//     to the outputs.
// PEBS hits (one id in `period`) ride the slot's second count, so a
// short period does not bring the meeting atomics back.
//
// The C entry point takes the table mode from the caller (the wrapper picks
// it from n_blocks, so its launch counts say which table ran), refuses the
// direct table above kDirectMaxBins, launches on the caller's stream,
// allocates nothing (the wrapper passes zeroed outputs) and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotBits = 12;           // hashed table: 4,096 slots
constexpr int kSlots = 1 << kSlotBits;
constexpr int kProbes = 8;              // most slots an id probes
constexpr int kFirstRoundClaims = 512;  // of a first round's 1,024 ids
constexpr unsigned kHashMul = 2654435761u;
constexpr int kBlocksPerSm = 4;
constexpr int kMinChunk = 2048;         // fewest ids a block takes
// direct table: 2 x 4 B x 29,056 = 232,448 B, a Hopper block's shared memory
constexpr int kDirectMaxBins = 29056;
constexpr int kEmpty = -1;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Ints of a block's table: direct, counts and sampled counts of every bin,
// each padded to whole int4s; hashed, keys, counts and sampled counts, and
// the count of claimed slots (padded to an int4).
__host__ __device__ constexpr int table_ints(bool direct, int n_blocks) {
  return direct ? 2 * pad4(n_blocks) : 3 * kSlots + 4;
}

// What a block's rounds share.
struct Block {
  int* table;
  int* claimed;      // hashed: slots claimed so far
  bool claiming;     // hashed: new ids may claim slots
  int n_blocks, period, cursor;
  int* hist;
  int* pebs;
};

// c accesses and pc sampled ones of `bin` into the outputs.
__device__ __forceinline__ void global_add(const Block& b, int bin, int c,
                                           int pc) {
  atomicAdd(b.hist + bin, c);
  if (pc) atomicAdd(b.pebs + bin, pc);
}

// c accesses and pc sampled ones of `bin` into the block's table.
template <bool kDirect>
__device__ __forceinline__ void table_add(const Block& b, int bin, int c,
                                          int pc) {
  if (kDirect) {
    atomicAdd(b.table + bin, c);
    if (pc) atomicAdd(b.table + pad4(b.n_blocks) + bin, pc);
    return;
  }
  int* keys = b.table;
  int* counts = b.table + kSlots;
  unsigned slot = ((unsigned)bin * kHashMul) >> (32 - kSlotBits);
  for (int probe = 0; probe < kProbes; ++probe) {
    int key = *(volatile int*)(keys + slot);
    if (key == kEmpty) {
      if (!b.claiming) break;  // keys never move: `bin` has no slot
      key = atomicCAS(keys + slot, kEmpty, bin);
      if (key == kEmpty) atomicAdd(b.claimed, 1);
    }
    if (key == kEmpty || key == bin) {
      atomicAdd(counts + slot, c);
      if (pc) atomicAdd(counts + kSlots + slot, pc);
      return;
    }
    slot = (slot + 1) & (kSlots - 1);
  }
  global_add(b, bin, c, pc);   // no slot
}

// A table entry's counts into the outputs, where `ok` and non-zero.
__device__ __forceinline__ void flush(const Block& b, int bin, bool ok,
                                      int c, int pc) {
  if (ok && c) atomicAdd(b.hist + bin, c);
  if (ok && pc) atomicAdd(b.pebs + bin, pc);
}

// One id per lane (`in` false for a lane without one); every lane of the
// warp calls it, so the full-mask match and ballot are well defined.
template <bool kDirect>
__device__ __forceinline__ void observe(const Block& b, int id, bool in,
                                        long long i, bool kept) {
  const int bin = id < 0 ? id + b.n_blocks : id;
  const bool valid = in && bin >= 0 && bin < b.n_blocks;
  // int32 stream position, wrapping like the reference's int32 add; a
  // zero remainder is the same for C's % and floor mod
  const int pos = (int)((unsigned)b.cursor + (unsigned)i);
  const bool hit = valid && kept && pos % b.period == 0;
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? bin : -1);
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (valid && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    table_add<kDirect>(b, bin, __popc(peers), __popc(peers & hits));
  }
}

// Vector v of the stream and its 4 keep bytes (all kept without a mask).
__device__ __forceinline__ void load_vec(const int4* vec,
                                         const unsigned char* kv,
                                         bool keep_words, long long v,
                                         bool in, int4& x, unsigned& kw) {
  x = make_int4(0, 0, 0, 0);
  kw = 0x01010101u;
  if (!in) return;
  x = __ldg(vec + v);
  if (keep_words) {
    kw = __ldg(reinterpret_cast<const unsigned*>(kv) + v);
  } else if (kv != nullptr) {
    kw = kv[4 * v] | kv[4 * v + 1] << 8 | kv[4 * v + 2] << 16 |
         (unsigned)kv[4 * v + 3] << 24;
  }
}

template <bool kDirect>
__global__ void __launch_bounds__(kThreads)
observe_scatter_kernel(const int* __restrict__ ids,
                       const unsigned char* __restrict__ keep,
                       const int* __restrict__ cursor_ptr, long long m,
                       int head, long long n_vec, long long vec_per_block,
                       int n_blocks, int period, int* __restrict__ hist,
                       int* __restrict__ pebs) {
  extern __shared__ int4 table4[];
  // direct: hist counts at 0, sampled counts at `half`; hashed: keys at 0,
  // counts at kSlots, sampled counts at 2 * kSlots, claimed at 3 * kSlots
  const int half = kDirect ? pad4(n_blocks) : kSlots;
  const int n_table4 = table_ints(kDirect, n_blocks) / 4;
  for (int q = threadIdx.x; q < n_table4; q += kThreads) {
    const int z = !kDirect && q < kSlots / 4 ? kEmpty : 0;
    table4[q] = make_int4(z, z, z, z);
  }
  __syncthreads();
  int* table = reinterpret_cast<int*>(table4);
  Block b{table, kDirect ? nullptr : table + 3 * kSlots, true, n_blocks,
          period, *cursor_ptr, hist, pebs};
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x == 0 && warp == 0) {
    // lanes 0-3: the head; lanes 4-7: the tail
    const long long i = lane < 4 ? lane : head + 4 * n_vec + (lane - 4);
    const bool in = lane < 4 ? lane < head : (lane < 8 && i < m);
    observe<kDirect>(b, in ? ids[i] : 0, in, i,
                     in && (keep == nullptr || keep[i] != 0));
  }
  const int4* vec = reinterpret_cast<const int4*>(ids + head);
  const unsigned char* kv = keep == nullptr ? nullptr : keep + head;
  // the keep mask as 4-byte words where they line up with the id vectors
  const bool keep_words = kv != nullptr && ((uintptr_t)kv & 3) == 0;
  const long long v0 = (long long)blockIdx.x * vec_per_block;
  const long long v1 = v0 + vec_per_block < n_vec ? v0 + vec_per_block
                                                  : n_vec;
  // one round: every lane of a warp observes the 4 ids of its vector v
  // while the vector a round later is loaded
  int4 next;
  unsigned next_kw;
  long long v = v0 + 32 * warp + lane;
  load_vec(vec, kv, keep_words, v, v < v1, next, next_kw);
  auto step = [&]() {
    const int4 x = next;
    const unsigned kw = next_kw;
    const bool in = v < v1;
    const long long i = head + 4 * v;
    v += kThreads;
    load_vec(vec, kv, keep_words, v, v < v1, next, next_kw);
    observe<kDirect>(b, x.x, in, i, kw & 0xffu);
    observe<kDirect>(b, x.y, in, i + 1, kw & 0xff00u);
    observe<kDirect>(b, x.z, in, i + 2, kw & 0xff0000u);
    observe<kDirect>(b, x.w, in, i + 3, kw & 0xff000000u);
  };
  // warp-uniform trip counts: every lane runs every round.  After the
  // block's first round (kThreads vectors) a hashed block decides whether
  // it claims more slots
  const long long first = v0 + 32 * warp;
  if (first < v1) step();
  if (!kDirect) {
    __syncthreads();
    const bool claiming = *b.claimed <= kFirstRoundClaims;
    __syncthreads();
    b.claiming = claiming;
  }
  for (long long base = first + kThreads; base < v1; base += kThreads) {
    step();
  }
  __syncthreads();
  // the flush: one atomic per used slot (direct: bin) and non-zero count
  const int n_q = half / 4;
  for (int q = threadIdx.x; q < n_q; q += kThreads) {
    const int4 a = table4[q];
    const int4 c = table4[n_q + q];
    if (kDirect) {              // a: counts, c: sampled counts of 4 bins
      const int e = 4 * q;
      flush(b, e, e < n_blocks, a.x, c.x);
      flush(b, e + 1, e + 1 < n_blocks, a.y, c.y);
      flush(b, e + 2, e + 2 < n_blocks, a.z, c.z);
      flush(b, e + 3, e + 3 < n_blocks, a.w, c.w);
    } else {                    // a: keys, c: counts, p: sampled counts
      const int4 p = table4[2 * n_q + q];
      flush(b, a.x, a.x != kEmpty, c.x, p.x);
      flush(b, a.y, a.y != kEmpty, c.y, p.y);
      flush(b, a.z, a.z != kEmpty, c.z, p.z);
      flush(b, a.w, a.w != kEmpty, c.w, p.w);
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

// Blocks an SM runs at once with `smem` bytes of table, at most
// kBlocksPerSm; the last answer for each mode is kept.
template <bool kDirect>
int blocks_per_sm(int smem) {
  static int last_smem = -1, last = 1;
  if (smem != last_smem) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(observe_scatter_kernel<kDirect>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, observe_scatter_kernel<kDirect>, kThreads, smem);
    last = n < 1 ? 1 : (n > kBlocksPerSm ? kBlocksPerSm : n);
    last_smem = smem;
  }
  return last;
}

template <bool kDirect>
int launch(const int* ids, const unsigned char* keep, const int* cursor,
           long long m, int n_blocks, int period, int* hist, int* pebs,
           cudaStream_t stream) {
  const int smem = table_ints(kDirect, n_blocks) * (int)sizeof(int);
  const long long cap = (long long)blocks_per_sm<kDirect>(smem) *
                        device_attr(cudaDevAttrMultiProcessorCount);
  long long grid = (m + kMinChunk - 1) / kMinChunk;
  grid = grid < 1 ? 1 : (grid > cap ? cap : grid);
  // ids before the first 16-byte boundary
  long long head = (16 - (long long)((uintptr_t)ids & 15)) % 16 / 4;
  head = head < m ? head : m;
  const long long n_vec = (m - head) / 4;
  const long long vec_per_block = (n_vec + grid - 1) / grid;
  observe_scatter_kernel<kDirect><<<(unsigned)grid, kThreads, smem, stream>>>(
      ids, keep, cursor, m, (int)head, n_vec, vec_per_block, n_blocks,
      period, hist, pebs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest n_blocks that takes the direct table.
int observe_scatter_shared_limit() { return kDirectMaxBins; }

// direct != 0: the direct table (n_blocks <= kDirectMaxBins), else hashed.
int observe_scatter_launch(const int* ids, const unsigned char* keep,
                           const int* cursor, long long m, int n_blocks,
                           int period, int direct, int* hist, int* pebs,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!direct) {
    return launch<false>(ids, keep, cursor, m, n_blocks, period, hist, pebs,
                         s);
  }
  if (n_blocks > kDirectMaxBins) return (int)cudaErrorInvalidValue;
  return launch<true>(ids, keep, cursor, m, n_blocks, period, hist, pebs, s);
}

}  // extern "C"
