// Flash-attention forward for Hopper (sm_90a), causal GQA with an optional
// sliding window and tanh soft cap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (pallas_call in flash_attention_fwd). It computes the same thing, term by
// term: s = (q.k) * D^-0.5; s = cap*tanh(s/cap) if cap; the mask
// kv<Skv & q<Sq & kv<=q (causal) & kv>q-window (window) applied as the finite
// NEG_INF = -1e30; the online softmax m/l/acc in f32; l = max(l, 1e-30) at
// the end; o = acc / l in the input type.  p stays f32 in the p.v product.
//
// Layout: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), o (B,Sq,Hq,D), all contiguous.
// The kernel reads them in place through their strides (no transposed or
// padded copies) and finds the kv head of q head h as h / (Hq/Hkv), so K/V
// are never broadcast in memory.
//
// Design.  One block of 128 threads per (64-row q tile, q head, batch).  The
// TPU's sequential kv grid axis becomes a loop inside the block, and it runs
// only over the kv tiles that the causal/window range of this q tile needs
// (loop bounds, not a predicate).  Q, K and V tiles are staged through shared
// memory as f32 (rows padded by one word against bank conflicts); each
// thread owns 4 rows x 8 columns of the 64x64 score tile and 4 rows x D/8
// columns of the output accumulator, so a row's max and sum are reduced over
// the 8 lanes that share it with warp shuffles.  m, l and acc stay in f32
// registers for the whole loop.
//
// Bound on this card.  At the prefill shape of smollm-360m (B=8, S=1024,
// Hq=15, Hkv=5, D=64, bf16) one call does about 16 GFLOP (causal half of
// 4*S^2*D per head) against about 42 MB of q, k, v and o, so it is bound by
// operations, not bytes.  This first version runs its products on the CUDA
// cores in f32 FMA, not on the tensor cores (mma.sync / wgmma) and without
// TMA: that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 128;    // 16 row groups x 8 column lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// max / sum over the 8 consecutive lanes that hold one row of a tile
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Skv, int Hq, int Hkv,
                 int causal, int window, float cap, float scale) {
  constexpr int LD = D + 1;     // padded row stride of the Q/K/V tiles
  constexpr int LP = BK + 1;    // padded row stride of the P tile
  constexpr int DC = D / 8;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD
  float* Ks = Qs + BQ * LD;     // BK x LD
  float* Vs = Ks + BK * LD;     // BK x LD
  float* Ps = Vs + BK * LD;     // BQ x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 3;      // rows tr*4 .. tr*4+3 of the tile
  const int tc = tid & 7;       // columns tc, tc+8, tc+16, ...
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const size_t q_stride = (size_t)Hq * D;   // between sequence positions
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const T* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  T* ob = o + ((size_t)b * Sq * Hq + h) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? to_f32(qb[(size_t)qi * q_stride + d]) : 0.f;
  }

  // kv positions this q tile can see: [kv_lo, kv_hi]
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 - window + 1, 0) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = kv_hi >= kv_lo ? kv_hi / BK : t_lo - 1;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the previous tile's K/V/P are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * LD + d] = in ? to_f32(kb[(size_t)kj * kv_stride + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f32(vb[(size_t)kj * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    // s = q . k for this thread's 4 x 8 scores
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = Ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // scale, cap, mask, online softmax; p goes to shared memory for p.v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tc + 8 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool keep = kj < Skv && qi < Sq;
        if (causal) keep = keep && kj <= qi;
        if (window) keep = keep && kj > qi - window;
        x = keep ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(tr * 4 + i) * LP + tc + 8 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * LD + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(&ob[(size_t)qi * q_stride + tc + 8 * c], acc[i][c] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                   int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Sq, Skv, Hq, Hkv, causal, window, cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Skv, int Hq, int Hkv, int D,
                       int causal, int window, float cap, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, cap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, cap, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, cap, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, cap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Sq, int Skv, int Hq,
                                   int Hkv, int D, int dtype, int causal,
                                   int window, float cap, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, cap, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window, cap, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
