// Flash-attention forward for Hopper (sm_90a), causal GQA with an optional
// sliding window and tanh soft cap.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (pallas_call in flash_attention_fwd). It computes the same thing, term by
// term: s = (q.k) * D^-0.5; s = cap*tanh(s/cap) if cap; the mask
// kv<Skv & q<Sq & kv<=q (causal) & kv>q-window (window) applied as the finite
// NEG_INF = -1e30; the online softmax m/l/acc in f32; l = max(l, 1e-30) at
// the end; o = acc / l in the input type.  A row that sees no key at all
// (only possible with Sq > Skv and a window) gets o = 0 and lse = NEG_INF,
// whether or not a kv tile in its range was visited: the reference's
// blockwise version gives such a row a mean of v that depends on its
// block size, and the contract here is FlashAttention's (ref.py).
//
// Layout: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), o (B,Sq,Hq,D), all contiguous.
// The kernel reads them in place through their strides (no transposed or
// padded copies) and finds the kv head of q head h as h / (Hq/Hkv), so K/V
// are never broadcast in memory.  The TPU's sequential kv grid axis becomes
// a loop inside the block, and it runs only over the kv tiles that the
// causal/window range of the q tile needs (loop bounds, not a predicate).
//
// Two kernels, chosen by dtype inside the library; neither falls back to
// the other.
//
// bf16: flash_fwd_mma_kernel, the FlashAttention-2 structure on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate).  One block of 4 warps
// per (64-row q tile, q head, batch); each warp owns 16 q rows (two m-tiles
// per warp, which would halve the shared-memory reads of K and V, need 243
// registers at D = 64 and ran slower).  The q tiles
// with the most kv tiles are scheduled first (causal: the q tile index runs
// backwards over blockIdx.z, the slowest grid axis).  Q is loaded once into
// registers with ldmatrix; K and V tiles of 64 rows stay bf16 in shared
// memory, rows padded by 16 bytes against bank conflicts, double-buffered
// with cp.async so that tile t+1 loads while tile t computes (at D = 256
// that is 165 KB of shared memory, and Q's fragments are read from shared
// memory at each k-step instead of held: acc alone takes 128 registers).  S = Q K^T
// accumulates in f32; the online softmax runs on the accumulator fragments
// in log2 units (log2(e) folded into the scale, ex2.approx), a row's max reduced
// over the 4 lanes of a quad, its sum kept per lane until the end.  P is
// rounded to bf16 in registers and used directly as the A operand of P V
// (the C layout of m16n8k16 is its A layout); V is read with
// ldmatrix.trans.  P never touches shared memory.  Masks are applied only
// on tiles that cross the diagonal, the window edge or Skv.  P rounds to
// bf16 before P V, as the plain version rounds p (ref.py).
//
// lse (optional, f32 (B,Sq,Hq), null for none): the natural-log
// log-sum-exp of each row's scaled, capped, masked scores, m + log(max(l,
// 1e-30)) as the reference's _flash_fwd returns it
// (src/repro/models/attention.py:93); the flash backward (K1b,
// flash_attention_bwd.cu) reads it.  The bf16 path keeps m in log2 units
// with the scale folded in, so there lse = (m2 + log2 max(l, 1e-30)) * ln 2;
// a row that saw no key keeps m = NEG_INF and writes NEG_INF, as the
// reference's f32 sum -1e30 + log(l) rounds to.  The serving prefill passes
// null and writes nothing more.
//
// f32: flash_fwd_kernel<D>, products in f32 FMA on the CUDA cores.
// TF32 tensor cores keep about 3 digits and could not meet the f32
// tolerance of 3e-5, so f32 stays there.  Q, K and V tiles are staged
// through shared memory (rows padded by one word); each thread owns 4 rows
// x 8 columns of the 64x64 score tile (2 x 4 of a 32x32 tile at D = 256),
// and p goes through shared memory to the p.v product.
//
// Bound on this card.  At the prefill shape of smollm-360m (B=8, S=1024,
// Hq=15, Hkv=5, D=64, bf16) one call does about 16 GFLOP (causal half of
// 4*S^2*D per head) against about 42 MB of q, k, v and o, so it is bound by
// operations: the bf16 kernel puts them on the tensor cores.  wgmma and TMA
// are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 128;    // f32: 16 row groups x 8 column lanes; bf16: 4 warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x in one MUFU instruction; results below 2^-126 flush to 0, which a
// softmax weight of that size is anyway
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- bf16 ---

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                     float cap, float scale, int vec) {
  constexpr int LD = D + mma::PAD;   // shared row stride, bf16 elements
  constexpr int KS = D / 16;         // k-steps of Q K^T
  constexpr int NT = D / 8;          // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* Ks = Qs + BQ * LD;                                // 2 x BK x LD
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                            // 2 x BK x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);

  const long long q_stride = (long long)Hq * D;   // between sequence positions
  const long long kv_stride = (long long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * Hkv + hk) * D;
  __nv_bfloat16* ob = o + ((long long)b * Sq * Hq + h) * D;

  // kv positions this q tile can see: [kv_lo, kv_hi]
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 - window + 1, 0) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = kv_hi >= kv_lo ? kv_hi / BK : t_lo - 1;

  auto load_kv = [&](int t) {
    const int k0 = t * BK, buf = (t - t_lo) & 1;
    const int rows = Skv - k0;
    mma::load_tile(Ks + buf * BK * LD, LD, kb + k0 * kv_stride, kv_stride, BK,
                   rows, D, D, vec, tid, THREADS);
    mma::load_tile(Vs + buf * BK * LD, LD, vb + k0 * kv_stride, kv_stride, BK,
                   rows, D, D, vec, tid, THREADS);
  };
  mma::load_tile(Qs, LD, qb + (long long)q0 * q_stride, q_stride, BQ, Sq - q0,
                 D, D, vec, tid, THREADS);
  mma::cp_async_commit();
  if (t_lo <= t_hi) load_kv(t_lo);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();           // Q has landed
  __syncthreads();

  const int qw = q0 + warp * 16;     // first q row of this warp
  // Q fragments of the warp's 16 rows, held in registers up to D = 128;
  // at D = 256 they would take 64 registers beside the 128 of acc, so
  // they are read from shared memory (ldmatrix) at each k-step instead
  constexpr bool QREG = D <= 128;
  const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) mma::ldmatrix_x4(qf[ks], qrow + ks * 16);
  }
  float acc[NT][4];
  float m[2] = {NEG_INF, NEG_INF};   // row max (log2 units) of rows g, g+8
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int t = t_lo; t <= t_hi; ++t) {
    if (t < t_hi) load_kv(t + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();         // everything but tile t+1 has landed
    __syncthreads();
    const int k0 = t * BK, buf = (t - t_lo) & 1;
    const __nv_bfloat16* Kt = Ks + buf * BK * LD;
    const __nv_bfloat16* Vt = Vs + buf * BK * LD;

    // S = Q K^T: 16 rows x 64 kv columns, 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int c = 0; c < 4; ++c) qa[c] = qf[ks][c];
      } else {
        mma::ldmatrix_x4(qa, qrow + ks * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                 ks * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // scale, cap and mask, in log2 units; masks only where the tile needs them
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qw) ||
                      (window && k0 <= qw + 15 - window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c];
        if (cap != 0.f) x = cap * tanhf(x * scale / cap) * LOG2E;
        else x *= sl2;
        if (edge) {
          const int kj = k0 + n * 8 + 2 * t4 + (c & 1);
          const int qi = qw + g + (c >> 1) * 8;
          bool keep = kj < Skv;
          if (causal) keep = keep && kj <= qi;
          if (window) keep = keep && kj > qi - window;
          x = keep ? x : NEG_INF;
        }
        s[n][c] = x;
      }

    // online softmax of rows g (c = 0, 1) and g+8 (c = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2_ftz(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          const float p = exp2_ftz(s[n][c] - m_new);
          s[n][c] = p;
          sum += p;
        }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: P from registers (bf16), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pf[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        mma::ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dp], pf, vf[0], vf[1]);
        mma::mma_bf16(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();                 // buffer `buf` is free for tile t+2
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    // a row that saw no key (m still NEG_INF) writes 0, not the mean of
    // the masked tile's v
    const float inv = m[r] <= NEG_INF ? 0.f : 1.f / fmaxf(lr, 1e-30f);
    const int qi = qw + g + r * 8;
    if (qi >= Sq) continue;
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * Sq + qi) * Hq + h] =
          m[r] <= NEG_INF ? NEG_INF : (m[r] + log2f(fmaxf(lr, 1e-30f))) * LN2;
    __nv_bfloat16* orow = ob + (long long)qi * q_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          mma::pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------- f32 ---

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

// T: rows of a q tile and of a kv tile; 64, and 32 at D = 256, where 64
// rows would give each thread 4 x 32 accumulators (128 registers) and
// three tiles of 214 KB.  Each thread owns RT = T/16 rows and CT = T/8
// columns of the T x T score tile.
template <int D, int T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                 int causal, int window, float cap, float scale) {
  constexpr int LD = D + 1;     // padded row stride of the Q/K/V tiles
  constexpr int LP = T + 1;     // padded row stride of the P tile
  constexpr int DC = D / 8;     // accumulator columns per thread
  constexpr int RT = T / 16;    // rows per thread
  constexpr int CT = T / 8;     // score columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // T x LD
  float* Ks = Qs + T * LD;      // T x LD
  float* Vs = Ks + T * LD;      // T x LD
  float* Ps = Vs + T * LD;      // T x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 3;      // rows tr*RT .. tr*RT+RT-1 of the tile
  const int tc = tid & 7;       // columns tc, tc+8, tc+16, ...
  const int q0 = blockIdx.x * T;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const size_t q_stride = (size_t)Hq * D;   // between sequence positions
  const size_t kv_stride = (size_t)Hkv * D;
  const float* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  float* ob = o + ((size_t)b * Sq * Hq + h) * D;

  for (int i = tid; i < T * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    Qs[r * LD + d] = qi < Sq ? qb[(size_t)qi * q_stride + d] : 0.f;
  }

  // kv positions this q tile can see: [kv_lo, kv_hi]
  const int q_last = min(q0 + T, Sq) - 1;
  const int kv_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 - window + 1, 0) : 0;
  const int t_lo = kv_lo / T;
  const int t_hi = kv_hi >= kv_lo ? kv_hi / T : t_lo - 1;

  float m[RT], l[RT], acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * T;
    __syncthreads();            // the previous tile's K/V/P are no longer read
    for (int i = tid; i < T * D; i += THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * LD + d] = in ? kb[(size_t)kj * kv_stride + d] : 0.f;
      Vs[r * LD + d] = in ? vb[(size_t)kj * kv_stride + d] : 0.f;
    }
    __syncthreads();

    // s = q . k for this thread's RT x CT scores
    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RT], bk[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = Qs[(tr * RT + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CT; ++j) bk[j] = Ks[(tc + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // scale, cap, mask, online softmax; p goes to shared memory for p.v
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qi = q0 + tr * RT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
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
      for (int j = 0; j < CT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(tr * RT + i) * LP + tc + 8 * j] = p;
      }
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float p[RT], vv[DC];
#pragma unroll
      for (int i = 0; i < RT; ++i) p[i] = Ps[(tr * RT + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * LD + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + tr * RT + i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    const bool none = m[i] <= NEG_INF;   // the row saw no key: o = 0
    if (lse != nullptr && tc == 0)
      lse[((size_t)b * Sq + qi) * Hq + h] = none ? NEG_INF : m[i] + logf(li);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(size_t)qi * q_stride + tc + 8 * c] = none ? 0.f : acc[i][c] / li;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, float cap, float scale, cudaStream_t stream) {
  constexpr int T = D > 128 ? 32 : 64;
  const size_t smem = (size_t)(3 * T * (D + 1) + T * (T + 1)) * sizeof(float);
  auto kernel = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + T - 1) / T, Hq, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      Sq, Skv, Hq, Hkv, causal, window, cap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * BK) * (D + mma::PAD) * sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (Sq + BQ - 1) / BQ;
  if (B > 65535 || nq > 65535) return cudaErrorInvalidValue;
  // cp.async needs 16-byte aligned rows: the row strides (Hq*D, Hkv*D
  // elements) are multiples of 16 bytes, so only the base pointers decide
  const int vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid(Hq, B, nq);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Sq, Skv, Hq, Hkv, causal, window, cap, scale, vec);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                       int causal, int window, float cap, float scale,
                       cudaStream_t stream) {
#define FLASH_LAUNCH(DD) \
  return BF16 ? launch_bf16<DD>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, cap, scale, stream) \
              : launch_f32<DD>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, cap, scale, stream)
  switch (D) {
    case 16: FLASH_LAUNCH(16);
    case 32: FLASH_LAUNCH(32);
    case 64: FLASH_LAUNCH(64);
    case 128: FLASH_LAUNCH(128);
    case 256: FLASH_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_LAUNCH
}

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32 (CUDA-core kernel),
// 1 = bfloat16 (tensor-core kernel).  lse: f32 (B,Sq,Hq) or null.
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int D, int dtype,
                                   int causal, int window, float cap,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<false>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, window, cap, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, window, cap, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
