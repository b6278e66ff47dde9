// flash_attention for Hopper (sm_90a): the C entry points of its two routes
// and of their backward (flash_attention_bwd.cuh), and the CUDA-core kernel
// that the routes replaced, kept as a yardstick.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, flash_attention_pallas): blocked attention with an online
// softmax,
//   o[bh, i] = sum_j p_ij v[bh / q_per_kv, j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij),  s_ij = scale * q[bh, i] . k[bh / q_per_kv, j]
// over the keys j that the mask lets through (causal: j <= i; window w:
// j >= i - w), with the running max, sum and accumulator in float32 and the
// output rounded once to q's dtype (float32 or bfloat16).  A row with no
// valid key gives 0 (the reference oracle's rule).  Unlike the TPU kernel
// there is no block-size restriction: any Sq and Sk work, the ragged edges
// are masked here.
//
// The TPU kernel walks KV blocks as a sequential grid dimension and carries
// max/sum/acc in VMEM scratch between grid steps.  On the card blocks run in
// no order, so one thread block owns one (bh, 64-query tile) and loops over
// the KV tiles itself:
//   * the Q tile is staged once in shared memory as float32 (transposed, so
//     the score loop reads 4 query rows with one 16-byte load);
//   * per KV tile (64 keys for d <= 64, 32 for d >= 128) K (transposed) and
//     V are staged in shared memory as float32; each of the 256 threads
//     computes a 4 x (BK/16) block of scores in registers, the row max and
//     sum go across the 16 threads of a row with xor shuffles (which give
//     every lane the same bits), and p is written to shared memory for the
//     P.V product, where each thread owns 4 rows x d/16 output columns;
//   * KV tiles that the causal mask or the window hides from every row of
//     the query tile are never loaded (the causal triangle halves the work);
//     the heaviest query tiles go first, to shorten the causal tail;
//   * element offsets are 64-bit.
//
// Two routes, fixed by dtype (kernel.py's route()), each at every head dim
// (16, 32, 64, 80, 112, 128, 256):
//   * bfloat16 runs on the tensor cores through wgmma
//     (flash_attention_wgmma.cuh; d that is not whole 64-column panels, 16,
//     32, 80 and 112, with a last shared-memory panel that TMA fills past d
//     with zeros; d 256 in four panels, with 64-key tiles in 2 stages);
//   * float32 on the TF32 tensor cores through mma.sync, each product split
//     three ways so that it keeps float32 accuracy
//     (flash_attention_tf32x3.cuh): one TF32 product misses the float32
//     tolerance of 2e-5, three of them meet it, and the TF32 rate is 7x the
//     CUDA cores'.
// No path launches the CUDA-core kernel below.  It takes float32 at every d
// and bfloat16 at d in {16, 32, 80, 112, 256} when it is named (kernel.py's
// _launch), to be held against the tensor-core routes on the same input and
// timed in turns with them.
//
// Bound, on this card: operations for long prompts, bytes for short ones.
// At the qwen2-0.5b prefill shape (B=4, H=14, KVH=2, d=64, S=4096) the
// causal products are 2*B*H*S^2*d = 120 GFLOP, 0.12 ms at the dense bf16
// tensor-core rate (989 TFLOP/s), against 67 MB of q, k, v and output in
// bfloat16 (0.02 ms at 3.35 TB/s); at S=19 or 64 the bytes and the launch
// dominate.  This kernel does its products on the CUDA cores in float32 (67
// TFLOP/s: 1.8 ms at that shape), so by construction it cannot come within
// 15x of the bf16 bound; it spends the CUDA cores well (register tiles, one
// staging of each K/V tile for 64 query rows, masked tiles skipped).
//
// The C entry points launch on the caller's stream, allocate nothing (the
// wrapper passes the output) and return the first CUDA error they meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_attention_bwd.cuh"
#include "flash_attention_tf32x3.cuh"
#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block: 16 row groups of 4
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int N> struct VecF;
template <> struct VecF<2> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};
template <> struct VecF<4> {
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  // d a multiple of 64: 4 neighbouring columns per 64-wide group (16-byte
  // shared loads of V); else (d = 16, 32) one column every 16
  if constexpr (D % 64 == 0) return tx * 4 + 64 * (c >> 2) + (c & 3);
  else return tx + 16 * c;
}

template <int D>
__host__ __device__ constexpr int block_k() { return D <= 64 ? 64 : 32; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int BK = block_k<D>();
  return sizeof(float) * ((size_t)D * (kBQ + 4) + (size_t)D * (BK + 4) +
                          (size_t)BK * D + (size_t)kBQ * (BK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       long long n_bh, int sq, int sk, int q_per_kv,
                       int causal, int window, float scale, int n_qt) {
  constexpr int BK = block_k<D>();
  constexpr int KPT = BK / 16;       // keys per thread in a score tile
  constexpr int CPT = D / 16;        // output columns per thread
  constexpr int QSTR = kBQ + 4, KSTR = BK + 4, PSTR = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [D][QSTR]
  float* Kt = Qs + D * QSTR;                     // [D][KSTR]
  float* Vs = Kt + D * KSTR;                     // [BK][D]
  float* Ps = Vs + BK * D;                       // [kBQ][PSTR]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long bh = (long long)blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - (int)((long long)blockIdx.x / n_bh)) * kBQ;
  const long long kv = bh / q_per_kv;
  const T* qb = q + bh * sq * D;
  const T* kb = k + kv * sk * D;
  const T* vb = v + kv * sk * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[c * QSTR + r] = q0 + r < sq ? to_f32(qb[(long long)(q0 + r) * D + c]) : 0.f;
  }

  // the KV tiles some row of this query tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window >= 0 ? max(0, q0 - window) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                 // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk) {
        const long long off = (long long)(k0 + r) * D + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      Kt[c * KSTR + r] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kx[KPT];
      VecF<4>::load(&Qs[c * QSTR + ty * 4], qv);
      VecF<KPT>::load(&Kt[c * KSTR + tx * KPT], kx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] += qv[i] * kx[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      bool ok[KPT];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + tx * KPT + j;
        ok[j] = kp < sk && qr < sq && (!causal || kp <= qr) &&
                (window < 0 || kp >= qr - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rsum += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      VecF<KPT>::store(&Ps[(ty * 4 + i) * PSTR + tx * KPT], s[i]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) VecF<4>::load(&Ps[(ty * 4 + i) * PSTR + kk], p[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = &Vs[(kk + u) * D];
        if constexpr (D % 64 == 0) {
#pragma unroll
          for (int g = 0; g < D / 64; ++g) {
            float vx[4];
            VecF<4>::load(&vr[tx * 4 + 64 * g], vx);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][4 * g + e] += p[i][u] * vx[e];
          }
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float vx = vr[tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] += p[i][u] * vx;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + (bh * sq + qr) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) put(orow + out_col<D>(tx, c), acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, long long n_bh,
           int sq, int sk, int q_per_kv, int causal, int window, float scale,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  static bool opted_in = false;       // per instantiation, once per process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const long long grid = (long long)n_qt * n_bh;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, D><<<(unsigned)grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n_bh, sq, sk, q_per_kv, causal, window, scale, n_qt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, long long n_bh,
             int sq, int sk, int d, int q_per_kv, int causal, int window,
             float scale, cudaStream_t s) {
  // every (dtype, d) is a tensor-core route's; this kernel takes the ones
  // below when it is named (bf16 at d = 64 and 128 never)
  constexpr bool kF32 = std::is_same<T, float>::value;
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
    case 64:
      if constexpr (kF32) return launch<T, 64>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
      break;
    case 80: return launch<T, 80>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
    case 112: return launch<T, 112>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
    case 128:
      if constexpr (kF32) return launch<T, 128>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
      break;
    case 256: return launch<T, 256>(q, k, v, out, n_bh, sq, sk, q_per_kv, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The CUDA-core kernel, named only.  q: (n_bh, sq, d); k, v: (n_bh / q_per_kv,
// sk, d); out like q.  dtype: 0 = float32 (d in 16, 32, 64, 80, 112, 128,
// 256), 1 = bfloat16 (d in 16, 32, 80, 112, 256); the routes below are the
// wrapper's choice at each.  window < 0: no window.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                           long long n_bh, long long sq, long long sk, int d,
                           int q_per_kv, int causal, int window, float scale,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq > 0x7fffffffLL || sk > 0x7fffffffLL || q_per_kv < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, n_bh, (int)sq, (int)sk, d, q_per_kv, causal,
                           window, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, n_bh, (int)sq, (int)sk, d, q_per_kv,
                                   causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bfloat16 q, k, v and out as above, d in 16, 32, 64,
// 80, 112, 128, 256, sk >= 1, every pointer 16-byte aligned.  Returns a cudaError_t, or a
// negative code for a refused tensor map (fa_wgmma::kNoDriverEntry,
// fa_wgmma::kEncodeFailed minus the CUresult).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* out,
                                 long long n_bh, long long sq, long long sk, int d,
                                 int q_per_kv, int causal, int window, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq > 0x7fffffffLL || sk > 0x7fffffffLL || q_per_kv < 1)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return fa_wgmma::launch<16>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 32: return fa_wgmma::launch<32>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 64: return fa_wgmma::launch<64>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 80: return fa_wgmma::launch<80>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 112: return fa_wgmma::launch<112>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 128: return fa_wgmma::launch<128>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 256: return fa_wgmma::launch<256>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The TF32 tensor-core kernel (3xTF32 mma.sync): float32 q, k, v and out as
// above, d in 16, 32, 64, 80, 112, 128, 256, every pointer 16-byte aligned
// (cp.async).  Returns a cudaError_t.
int flash_attention_tf32x3_launch(const void* q, const void* k, const void* v, void* out,
                                  long long n_bh, long long sq, long long sk, int d,
                                  int q_per_kv, int causal, int window, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq > 0x7fffffffLL || sk > 0x7fffffffLL || q_per_kv < 1)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return fa_tf32x3::launch<16>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 32: return fa_tf32x3::launch<32>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 64: return fa_tf32x3::launch<64>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 80: return fa_tf32x3::launch<80>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 112: return fa_tf32x3::launch<112>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 128: return fa_tf32x3::launch<128>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
    case 256: return fa_tf32x3::launch<256>(q, k, v, out, n_bh, (int)sq, (int)sk, q_per_kv, causal, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The TF32 kernel's resident blocks an SM at head dim d, or minus the
// cudaError_t that stopped the query.
int flash_attention_tf32x3_blocks_per_sm(int d) {
  switch (d) {
    case 16: return fa_tf32x3::blocks_per_sm<16>();
    case 32: return fa_tf32x3::blocks_per_sm<32>();
    case 64: return fa_tf32x3::blocks_per_sm<64>();
    case 80: return fa_tf32x3::blocks_per_sm<80>();
    case 112: return fa_tf32x3::blocks_per_sm<112>();
    case 128: return fa_tf32x3::blocks_per_sm<128>();
    case 256: return fa_tf32x3::blocks_per_sm<256>();
  }
  return -(int)cudaErrorInvalidValue;
}

// The backward (flash_attention_bwd.cuh): dq, dk, dv of the function above
// for q, k, v and dout (the output's gradient, q's shape and dtype), each
// pointer 16-byte aligned (cp.async); dq like q, dk and dv like k; scratch:
// stats, float32, 3 x n_bh x ceil(sq / 64) * 64; with q_per_kv > 1 parts,
// float32, n_bh x 2 x ceil(sk / 64) * 64 x d, and tickets, int32, n_bh /
// q_per_kv x ceil(sk / 32), zero.  d in 16, 32, 64, 80, 112, 128, 256;
// sq, sk >= 1.  bf16: the tensor-core route (mma.sync m16n8k16, P
// and dS split hi + lo); float32: the TF32 route (3xTF32 mma.sync m16n8k8).
// Returns a cudaError_t.
#define FA_BWD_ARGS q, k, v, dout, dq, dk, dv, stats, parts, tickets, n_bh, (int)sq, (int)sk, \
                    q_per_kv, \
                    causal, window, scale, s
#define FA_BWD_SWITCH(BF16)                                                   \
  switch (d) {                                                                \
    case 16: return fa_bwd::launch<16, BF16>(FA_BWD_ARGS);                    \
    case 32: return fa_bwd::launch<32, BF16>(FA_BWD_ARGS);                    \
    case 64: return fa_bwd::launch<64, BF16>(FA_BWD_ARGS);                    \
    case 80: return fa_bwd::launch<80, BF16>(FA_BWD_ARGS);                    \
    case 112: return fa_bwd::launch<112, BF16>(FA_BWD_ARGS);                  \
    case 128: return fa_bwd::launch<128, BF16>(FA_BWD_ARGS);                  \
    case 256: return fa_bwd::launch<256, BF16>(FA_BWD_ARGS);                  \
  }                                                                           \
  return (int)cudaErrorInvalidValue;

int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                               void* dq, void* dk, void* dv, void* stats, void* parts,
                               void* tickets, long long n_bh, long long sq, long long sk, int d,
                               int q_per_kv, int causal, int window, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq < 1 || sk < 1 || sq > 0x7fffffffLL || sk > 0x7fffffffLL || q_per_kv < 1)
    return (int)cudaErrorInvalidValue;
  FA_BWD_SWITCH(true)
}

int flash_attention_bwd_tf32x3_launch(const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      void* stats, void* parts, void* tickets, long long n_bh,
                                      long long sq, long long sk, int d, int q_per_kv,
                                      int causal, int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq < 1 || sk < 1 || sq > 0x7fffffffLL || sk > 0x7fffffffLL || q_per_kv < 1)
    return (int)cudaErrorInvalidValue;
  FA_BWD_SWITCH(false)
}

}  // extern "C"
