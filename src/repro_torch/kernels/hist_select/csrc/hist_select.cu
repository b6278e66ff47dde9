// hist_select for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hist_select/kernel.py
// (_kernel, kth_key_u_pallas): for each (row b, segment s), the k-th
// largest uint32 key -- the largest t with count(u >= t) >= ks[s] among the
// segment's elements.  ks[s] == 0 gives 0xFFFFFFFF; ks[s] beyond the
// segment gives 0 (the byte-level search's degenerate answer); segment id
// -1 (or any id outside [0, S)) is padding.
//
// Keys arrive as the int32 selection keys; u = bits(key) ^ 0x80000000 is the
// order-preserving uint32 image (selectk._to_u), formed in registers.
//
// The TPU kernel carries an (S, 256) f32 histogram across a sequential grid
// and fills it with a one-hot matmul, four byte levels in turn.  Here a
// radix pass is one launch of a persistent grid over the rows still open,
// and a call makes kPasses of them (4 with 8-bit digits) on the stream,
// with no host round trip.  Each
// (row, segment) keeps its candidates as an interval [lo, hi] of u (a bin
// is an interval, so "keys in the chosen bin" is "keys in [lo, hi]"):
//   * a pass histograms the candidates on the digit just below the
//     interval's common prefix (the highest bit where lo and hi differ, so
//     the digit adapts to the data), and keeps each bin's smallest and
//     largest key too;
//   * the block whose flush completes a row (an atomic ticket counts its
//     chunks) resolves each segment with one warp: a suffix scan of the
//     bins finds the bin that holds the k-th largest, whose [min, max] is
//     the next interval, and k drops by the count above it.  When min ==
//     max the threshold is that key and the (row, segment) is done: later
//     passes skip it.  A row with a segment still open is listed for the
//     next pass, whose blocks share out only the listed rows' chunks, so a
//     pass over one row still fills the card.
//     Each pass narrows the interval by at least a digit, so kPasses passes
//     always finish; tie-heavy rows (a value that holds most keys) finish
//     after one;
//   * keys are read as 16-byte vectors, kUnroll of them in flight per
//     thread, with a scalar head and tail where a row start is not 16-byte
//     aligned (row b starts at keys + b * n, any n);
//   * each thread counts the first bin it meets in registers (its run:
//     count, smallest and largest key) and sends keys of any other bin to
//     its warp's copy of the bins in shared memory one atomic at a time
//     (as many copies as fit at full occupancy, summed when the block
//     flushes into the global bins).  On the online path's rows about one
//     key in 60 is not the tie value, so a 128-key warp round is mostly
//     mixed, and a warp-wide test for one shared bin rarely passes (a
//     first design that had it was slower); here the tie value costs no
//     atomic at all.
// The launch's scratch -- global bins, tickets and the open-row lists --
// must be zero (the wrapper allocates it with torch.zeros); each resolve
// re-zeroes the bins and ticket it read, so the next pass finds them zero.  Pass 0 needs no state: it
// starts every (row, segment) at [0, 0xFFFFFFFF] with k = ks[s].
//
// Bound: bytes.  The work needs the B x n keys read once; a pass reads only
// rows with a segment left to resolve.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 8;               // digit width: 11 bits was slower
constexpr int kBins = 1 << kBits;
constexpr int kPasses = (32 + kBits - 1) / kBits;
constexpr int kUnroll = 4;                 // 16-byte loads in flight a thread
constexpr int kChunkVec = kThreads * kUnroll;   // 16-byte vectors an item
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSkip = 0xfffffffeu;    // no candidate (padding, resolved)
// per-block shared memory that still lets 8 blocks of 256 threads share an SM
constexpr int kFullOccupancySmem = 232448 / 8 - 1024;

static_assert(kBits >= 5 && kBits <= 12, "digit width");

// The bin id (segment * kBins + digit) of key u in segment s, or kSkip;
// p is the segment's (lo, hi, shift, mask).
__device__ __forceinline__ unsigned classify(unsigned u, unsigned s, uint4 p) {
  if (p.w == 0u || u < p.x || u > p.y) return kSkip;
  return s * kBins + ((u >> p.z) & p.w);
}

__device__ __forceinline__ unsigned classify_seg(unsigned u, int s, int segs,
                                                 const uint4* prm) {
  if (s < 0 || s >= segs) return kSkip;
  return classify(u, (unsigned)s, prm[s]);
}

// A thread's run: the first bin it meets, counted in registers.
struct Run {
  unsigned bin, n, lo, hi;
};

__device__ __forceinline__ void add_key(Run& run, unsigned* cnt, unsigned* nmin,
                                        unsigned* mx, unsigned c, unsigned u) {
  if (c == kSkip) return;
  if (c == run.bin) {
    ++run.n;
    run.lo = min(run.lo, u);
    run.hi = max(run.hi, u);
  } else if (run.bin == kSkip) {
    run = {c, 1u, u, u};
  } else {
    atomicAdd(cnt + c, 1u);
    if (~u > nmin[c]) atomicMax(nmin + c, ~u);
    if (u > mx[c]) atomicMax(mx + c, u);
  }
}

// Resolve (row b, segment s) with one warp after a pass: g holds its
// kBins counts, then kBins maxima of ~u (bin minima), then kBins maxima.
// Returns whether the (row, segment) is still open.
__device__ bool resolve(unsigned* __restrict__ g, uint4 cell,
                        uint4* __restrict__ st, long long* __restrict__ out,
                        int pass) {
  constexpr int kPer = kBins / 32;
  const int lane = threadIdx.x & 31;
  if (cell.w) return false;
  unsigned c[kPer];                 // the lane's bins, read once
  unsigned long long mine = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    c[i] = __ldcg(g + lane * kPer + i);
    mine += c[i];
  }
  // suffix sums over lanes: suf = count of the bins at and above lane's
  unsigned long long suf = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long t = __shfl_down_sync(kFull, suf, off);
    if (lane + off < 32) suf += t;
  }
  const unsigned long long total = __shfl_sync(kFull, suf, 0);
  const unsigned k = cell.z;
  if (total < k) {            // k beyond the segment: degenerate to 0
    cell = make_uint4(0u, 0u, 0u, 1u);
    if (lane == 0) *out = 0;
  } else {
    const unsigned top = __ballot_sync(kFull, suf >= k);
    const int owner = 31 - __clz(top);
    // in the owner lane, walk its bins down from the top
    unsigned long long cum = suf - mine;        // keys in bins above lane's
    int pick = 0;
    bool found = false;
#pragma unroll
    for (int i = kPer - 1; i >= 0; --i) {
      if (!found && (i == 0 || cum + c[i] >= k)) {
        pick = lane * kPer + i;
        found = true;
      } else if (!found) {
        cum += c[i];
      }
    }
    unsigned krem = k - (unsigned)cum;
    pick = __shfl_sync(kFull, pick, owner);
    krem = __shfl_sync(kFull, krem, owner);
    const unsigned lo = ~__ldcg(g + kBins + pick);
    const unsigned hi = __ldcg(g + 2 * kBins + pick);
    const bool done = lo == hi || pass == kPasses - 1;
    cell = make_uint4(lo, hi, krem, done ? 1u : 0u);
    if (done && lane == 0) *out = (long long)lo;
  }
  if (lane == 0) *st = cell;
  __syncwarp();
  for (int i = lane; i < 3 * kBins; i += 32) g[i] = 0u;
  return cell.w == 0u;
}

// One pass.  The work is (row, chunk) items over the rows still open --
// every row in pass 0, then the rows the previous pass's resolves listed --
// and each block of a persistent grid takes a contiguous run of items, so
// the card stays full when only a few rows are left.  A block flushes its
// bins when its run leaves a row; the flush that brings the row's ticket
// to its chunk count resolves the row.
template <bool kOneSeg>
__global__ void __launch_bounds__(kThreads)
hs_pass(const int* __restrict__ keys, const int* __restrict__ seg,
        const int* __restrict__ ks, int rows, long long n, int segs, int copies,
        int pass, uint4* __restrict__ state, unsigned* __restrict__ gbins,
        unsigned* __restrict__ tickets, unsigned* __restrict__ open,
        long long* __restrict__ out) {
  extern __shared__ uint4 sh4[];
  uint4* prm = sh4;                          // per segment: lo, hi, shift, mask
  const int nb = segs * kBins;
  unsigned* cnt = reinterpret_cast<unsigned*>(sh4 + segs);  // copies x nb
  unsigned* nmin = cnt + copies * nb;        // nb: max of ~u per bin
  unsigned* mx = nmin + nb;                  // nb: max of u per bin
  __shared__ unsigned ticket;
  __shared__ int row_open;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_open = pass == 0 ? rows : (long long)open[pass];
  const unsigned* list = open + kPasses + (size_t)pass * rows;
  const long long cpr = max(1LL, ((n >> 2) + kChunkVec - 1) / kChunkVec);
  const long long items = n_open * cpr;
  const long long per = (items + gridDim.x - 1) / gridDim.x;
  const long long i1 = min(items, ((long long)blockIdx.x + 1) * per);
  unsigned* my_cnt = cnt + (warp % copies) * nb;

  for (long long item = (long long)blockIdx.x * per; item < i1;) {
    const long long ai = item / cpr;
    const int b = pass == 0 ? (int)ai : (int)list[ai];
    const long long cell0 = (long long)b * segs;
    const long long ch0 = item - ai * cpr;
    const long long ch1 = min(i1, (ai + 1) * cpr) - ai * cpr;
    item = ai * cpr + ch1;

    // the row's intervals and empty bins
    __syncthreads();
    for (int s = tid; s < segs; s += kThreads) {
      unsigned lo = 0u, hi = kFull;
      bool live = ks[s] > 0;
      if (pass > 0) {
        const uint4 c = state[cell0 + s];
        lo = c.x; hi = c.y; live = c.w == 0u;
      }
      unsigned shift = 0u, mask = 0u;
      if (live) {
        const int hb = 31 - __clz(lo ^ hi);  // lo != hi while unresolved
        shift = (unsigned)max(hb - kBits + 1, 0);
        mask = (2u << (hb - (int)shift)) - 1u;
      }
      prm[s] = make_uint4(lo, hi, shift, mask);
    }
    for (int i = tid; i < (copies + 2) * nb; i += kThreads) cnt[i] = 0u;
    __syncthreads();

    const uint4 p0 = prm[0];
    Run run = {kSkip, 0u, kFull, 0u};
    const int* row = keys + b * n;
    // scalar head up to the first 16-byte boundary, 16-byte body, scalar
    // tail; the block with the row's first chunk takes head and tail
    long long head = (long long)((4u - ((unsigned)(size_t)row >> 2)) & 3u);
    head = head < n ? head : n;
    const long long nvec = (n - head) >> 2;
    const long long tail0 = head + 4 * nvec;
    if (ch0 == 0 && warp == 0) {
      long long i = -1;
      if (lane < head) i = lane;
      else if (lane >= 4 && lane - 4 < n - tail0) i = tail0 + lane - 4;
      if (i >= 0) {
        const unsigned u = (unsigned)row[i] ^ 0x80000000u;
        add_key(run, my_cnt, nmin, mx,
                kOneSeg ? classify(u, 0u, p0) : classify_seg(u, seg[i], segs, prm),
                u);
      }
    }
    const int4* vrow = reinterpret_cast<const int4*>(row + head);
    const bool seg_vec = !kOneSeg && (((size_t)(seg + head)) & 15u) == 0u;
    for (long long ch = ch0; ch < ch1; ++ch) {
      int4 kv[kUnroll], sv[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const long long v = ch * kChunkVec + r * kThreads + tid;
        kv[r] = make_int4(0, 0, 0, 0);
        sv[r] = make_int4(-1, -1, -1, -1);
        if (v < nvec) {
          kv[r] = __ldcs(vrow + v);
          if (kOneSeg) {
            sv[r] = make_int4(0, 0, 0, 0);
          } else if (seg_vec) {
            sv[r] = __ldg(reinterpret_cast<const int4*>(seg + head) + v);
          } else {
            const int* sp = seg + head + 4 * v;
            sv[r] = make_int4(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2), __ldg(sp + 3));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int kk[4] = {kv[r].x, kv[r].y, kv[r].z, kv[r].w};
        const int ss[4] = {sv[r].x, sv[r].y, sv[r].z, sv[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned u = (unsigned)kk[j] ^ 0x80000000u;
          const unsigned c = kOneSeg ? (ss[j] == 0 ? classify(u, 0u, p0) : kSkip)
                                     : classify_seg(u, ss[j], segs, prm);
          add_key(run, my_cnt, nmin, mx, c, u);
        }
      }
    }
    if (run.n) {
      atomicAdd(my_cnt + run.bin, run.n);
      atomicMax(nmin + run.bin, ~run.lo);
      atomicMax(mx + run.bin, run.hi);
    }
    __syncthreads();

    // flush into the row's global bins; the last chunk's flush resolves
    for (int i = tid; i < nb; i += kThreads) {
      unsigned total = 0u;
      for (int c = 0; c < copies; ++c) total += cnt[c * nb + i];
      if (total) {
        unsigned* g = gbins + (cell0 + i / kBins) * 3 * kBins + i % kBins;
        atomicAdd(g, total);
        atomicMax(g + kBins, nmin[i]);
        atomicMax(g + 2 * kBins, mx[i]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const unsigned mine = (unsigned)(ch1 - ch0);
      ticket = atomicAdd(tickets + b, mine) + mine;
      row_open = 0;
    }
    __syncthreads();
    if (ticket != (unsigned)cpr) continue;
    __threadfence();
    for (int s = warp; s < segs; s += kWarps) {
      uint4* st = state + cell0 + s;
      uint4 cell;
      if (pass == 0) {         // k = 0 is resolved before any key is read
        cell = make_uint4(0u, kFull, (unsigned)ks[s], ks[s] > 0 ? 0u : 1u);
        if (cell.w && lane == 0) {
          *st = cell;
          out[cell0 + s] = (long long)kFull;
        }
      } else {
        cell = *st;
      }
      if (resolve(gbins + (cell0 + s) * 3 * kBins, cell, st, out + cell0 + s,
                  pass) && lane == 0) {
        row_open = 1;
      }
    }
    __syncthreads();
    if (tid == 0) {
      tickets[b] = 0u;
      if (row_open && pass + 1 < kPasses) {   // list the row for the next pass
        const unsigned at = atomicAdd(open + pass + 1, 1u);
        open[kPasses + (size_t)(pass + 1) * rows + at] = (unsigned)b;
      }
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

size_t smem_bytes(int segs, int copies) {
  return sizeof(uint4) * segs +
         (size_t)(copies + 2) * segs * kBins * sizeof(unsigned);
}

template <bool kOneSeg>
void launch_passes(const int* keys, const int* seg, const int* ks, int rows,
                   long long n, int segs, long long* out, void* state,
                   unsigned* gbins, unsigned* tickets, unsigned* open,
                   cudaStream_t s) {
  int copies = (kFullOccupancySmem - (int)smem_bytes(segs, 0)) /
               (segs * kBins * (int)sizeof(unsigned));
  copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  const size_t smem = smem_bytes(segs, copies);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(hs_pass<kOneSeg>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hs_pass<kOneSeg>,
                                                kThreads, smem);
  per_sm = per_sm < 1 ? 1 : per_sm;
  // one resident wave, never more blocks than pass 0 has items
  long long grid = (long long)per_sm * device_attr(cudaDevAttrMultiProcessorCount);
  const long long cpr = ((n >> 2) + kChunkVec - 1) / kChunkVec;
  const long long items = (long long)rows * (cpr > 1 ? cpr : 1);
  grid = grid > items ? items : grid;
  for (int pass = 0; pass < kPasses; ++pass) {
    hs_pass<kOneSeg><<<(unsigned)grid, kThreads, smem, s>>>(
        keys, seg, ks, rows, n, segs, copies, pass, static_cast<uint4*>(state),
        gbins, tickets, open, out);
  }
}

}  // namespace

extern "C" {

// Most segments one call takes: one copy of the bins, the bin minima and
// maxima, and the segment's interval in shared memory.
int hist_select_max_segments() {
  return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) /
         (int)smem_bytes(1, 1);
}

int hist_select_digit_bits() { return kBits; }

int hist_select_passes() { return kPasses; }

// keys (rows, n) int32; seg (n,) int32 or null (one segment); ks (segs,)
// int32 on the device; out (rows, segs) int64; state (rows, segs) uint4;
// gbins (rows, segs, 3, kBins), tickets (rows,) and open (kPasses counts,
// then kPasses lists of rows) uint32, all zero.
int hist_select_launch(const int* keys, const int* seg, const int* ks, int rows,
                       long long n, int segs, long long* out, void* state,
                       unsigned* gbins, unsigned* tickets, unsigned* open,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg == nullptr && segs == 1) {
    launch_passes<true>(keys, seg, ks, rows, n, segs, out, state, gbins, tickets,
                        open, s);
  } else {
    launch_passes<false>(keys, seg, ks, rows, n, segs, out, state, gbins, tickets,
                         open, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
