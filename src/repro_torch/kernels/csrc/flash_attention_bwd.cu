// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of causal GQA
// attention with an optional sliding window and tanh soft cap (K1b).
//
// The reference has no Pallas kernel for it: it replaces the jnp custom VJP
// _flash_bwd of blockwise_attention (src/repro/models/attention.py:146),
// whose forward K1 (flash_attention_fwd.cu) replaces.  Term by term, as
// there: s = (q.k) * D^-0.5, capped s = cap*tanh(s/cap); p = exp(s - lse)
// with the lse the forward wrote; delta = rowsum(o * do) in f32;
// dv = p^T do; dp = do v^T; ds = p (dp - delta), times 1 - (s/cap)^2 under
// the cap; masked entries of ds set to 0, then ds scaled by D^-0.5;
// dq = ds k; dk = ds^T q.  The mask is the forward's: kv < Skv, q < Sq,
// kv <= q (causal), kv > q - window (window).  A masked entry has p = 0,
// and a row that sees no key at all (lse = NEG_INF, only possible with
// Sq > Skv and a window) gives no gradient: p = ds = 0 on all its entries,
// the contract K1 and the plain versions keep for such rows (ref.py).
//
// Deterministic, with no atomics: three launches on one stream, a pass
// for delta, then a dk/dv kernel (one block per kv tile, kv head and
// batch, looping over the G = Hq/Hkv q heads of its kv head and over the
// q tiles that the causal/window range lets see the kv tile: loop bounds,
// not a predicate) and a dq kernel (one block per q tile, q head and
// batch, looping over the kv tiles the q tile sees).  Each keeps its sums
// in registers until the end.  Both recompute S = Q K^T and dP = dO V^T,
// so a call runs 7 tile products where FlashAttention-2's version, which
// adds dq across kv blocks with atomics, runs 5; in exchange every sum is
// taken in one fixed order and the gradients are bitwise the same from
// run to run.
//
// bf16, D = 64 and 128: the *_wgmma kernels, on wgmma with TMA
// (hopper_helpers.cuh).  A block is one consumer warpgroup (64 rows: kv
// rows in dk/dv, q rows in dq) and one producer warp.  The producer's
// first lane loads the block's fixed operands once by TMA (K and V for
// dk/dv; Q and dO for dq) and streams the others through a ring of
// 128-byte-swizzled stages, each completing on an mbarrier: Q, dO and 64
// rows of lse and delta for dk/dv; K and V for dq.  The consumer waits on
// a stage, runs S^T = K Q^T and dP^T = V dO^T (dk/dv) or S = Q K^T and
// dP = dO V^T (dq) as wgmma with both operands in shared memory, forms p
// and ds on the accumulator fragments in log2 units, rounds them to bf16
// in registers, and uses them there as the A operand of dV += P^T dO,
// dK += dS^T Q (dk/dv) or dQ += dS K (dq), whose B operand is read through
// an MN-major (transposed) descriptor; then it frees the stage.  The
// terms of a tile run without a branch per entry: the cap is a template
// parameter of the kernels, masks are a separate instantiation taken only
// on tiles that the diagonal, the window or Skv cut, and ds leaves out its
// factor D^-0.5, applied once to dK and dQ at the end (with a branch per
// entry the terms took half of each kernel's time).  TMA zero-fills rows
// past Sq and Skv.  The delta pass (flash_bwd_prep), a launch of its own,
// also writes lse * log2 e beside delta, both as (B, Hq, Sq rounded up to
// 64) rows that a stage takes in one bulk copy each; rows past Sq, and
// rows that see no key, get lse2 = +inf, so their p is exactly 0 without
// a mask.  The reference keeps p and ds in f32 for these products;
// rounding them to bf16 is what the tolerance of 3e-2 allows for.
// Work order as in the first version: kv tile 0, which the most q rows
// see, first (dk/dv); the q tiles with the most kv tiles first (dq).
// Blocks an SM: dk/dv 2 at D = 64 (156 registers), 1 at D = 128; dq 3 at
// D = 64.  Two things measured slower and were left out (PERF.md):
// setmaxnreg, which made ptxas build the whole kernel to the launch
// bound's smaller budget and spill; and issuing the next pair's scores
// behind this pair's products, which ptxas serialized.
//
// bf16, D = 16 and 32 (the sweep grid only; no config has them) and 256
// (gemma2-9b): the *_mma kernels of the first version, chosen by head dim,
// on mma.sync m16n8k16 with every operand through ldmatrix from cp.async
// tiles, 4 warps of 16 rows.  A 64 x 16 or 64 x 32 operand is below what a
// wgmma tile of 128-byte rows holds.  At D = 256 one consumer warpgroup
// could not hold dK and dV (64 x 256 f32 each: 256 registers a thread),
// so the block has 8 warps: warps w and w + 4 own the same 16 rows, both
// form their scores, and each keeps the gradients of one half of the head
// dim (247 and 180 registers, no spills; 199 KB of shared memory).
//
// f32: the kernels without _mma or _wgmma, products in f32 FMA on the CUDA
// cores, as K1's f32 path: TF32 could not meet the f32 tolerance.  Each
// thread owns 4 rows x 8 columns of a 64x64 score tile (2 x 4 of a 32x32
// tile at D = 256); p and ds go through shared memory to the products
// that follow.
//
// Bound on this card.  At smollm-360m's training shape (B=8, S=1024, Hq=15,
// Hkv=5, D=64, causal, bf16) the five products a backward needs are about
// 40 GFLOP against about 84 MB of q, k, v, o, do, lse in and dq, dk, dv
// out, so it is bound by operations: 0.041 ms at the H100's 989 TFLOP/s.
// This version does 7 products, all on wgmma; where its time goes is
// measured by tools/kernel_variants.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_helpers.cuh"
#include "mma_helpers.cuh"

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 128;    // bf16: 4 warps of 16 rows; f32: 16 row groups x 8 lanes
constexpr int WG_THREADS = 160; // wgmma: one consumer warpgroup + one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// p and ds of one (q row qi, kv row kj) entry from its raw score s (q.k)
// and dp (do.v).  LOG2: lse is in log2 units and p = 2^(s log2 e - lse);
// otherwise natural units and expf.
template <bool LOG2>
__device__ __forceinline__ void grad_terms(float s, float dp, int qi, int kj,
                                           float lse, float delta, int Sq,
                                           int Skv, int causal, int window,
                                           float cap, float scale, float& p,
                                           float& ds) {
  bool keep = qi < Sq && kj < Skv;
  if (causal) keep = keep && kj <= qi;
  if (window) keep = keep && kj > qi - window;
  float x = s * scale, fac = 1.f;
  if (cap != 0.f) {
    const float th = tanhf(x / cap);
    x = cap * th;
    fac = 1.f - th * th;            // d(cap tanh(x/cap))/dx
  }
  const float e = LOG2 ? exp2_ftz(x * LOG2E - lse) : expf(x - lse);
  p = keep ? e : 0.f;
  ds = keep ? e * (dp - delta) * fac * scale : 0.f;
}

// ------------------------------------------------------------- delta ---

// f32 and the mma.sync path: delta (B,Sq,Hq), one warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int D) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * (THREADS / 32);
  for (long long r = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       r < rows; r += step) {
    const T* orow = o + r * D;
    const T* drow = dout + r * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[r] = acc;
  }
}

// ------------------------------------------- bf16, mma.sync (D < 64) ---

// A operand (16 rows from row0, 16 columns from ks*16) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const __nv_bfloat16* s,
                                       int ld, int row0, int ks, int lane) {
  mma::ldmatrix_x4(f, s + (row0 + (lane & 15)) * ld + ks * 16 + (lane >> 4) * 8);
}
// B operands of n-tiles 2np and 2np+1 from a tile stored [n][k] row-major
__device__ __forceinline__ void load_b_nk(uint32_t (&f)[4], const __nv_bfloat16* s,
                                          int ld, int np, int ks, int lane) {
  mma::ldmatrix_x4(f, s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld + ks * 16 +
                          ((lane >> 3) & 1) * 8);
}
// B operands of n-tiles 2np and 2np+1 from a tile stored [k][n] row-major
__device__ __forceinline__ void load_b_kn(uint32_t (&f)[4], const __nv_bfloat16* s,
                                          int ld, int np, int ks, int lane) {
  mma::ldmatrix_x4_trans(f, s + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                np * 16 + (lane >> 4) * 8);
}
// the A fragment of k-step kk from the f32 accumulators of n-tiles 2kk, 2kk+1
__device__ __forceinline__ void pack_a(uint32_t (&f)[4], const float (&x)[8][4], int kk) {
  f[0] = mma::pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  f[1] = mma::pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  f[2] = mma::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  f[3] = mma::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// Warps of the mma.sync kernels: 4 of 16 rows; at D = 256, 8, where warps
// w and w + 4 share rows and split the head dim of the outputs (a warp's
// dk and dv over all 256 columns would take 256 registers), both forming
// the rows' scores.
__host__ __device__ constexpr int mma_warps(int D) { return D > 128 ? 8 : 4; }

template <int D>
__global__ void __launch_bounds__(mma_warps(D) * 32)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Skv,
                          int Hq, int Hkv, int causal, int window, float cap,
                          float scale, int vec) {
  constexpr int LD = D + mma::PAD;
  constexpr int KS = D / 16;        // k-steps over the head dim
  constexpr int NTH = mma_warps(D) * 32;
  constexpr int DW = D * 4 / mma_warps(D);   // head-dim columns of a warp's dk, dv
  constexpr int NT = DW / 8;        // n-tiles of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BK x LD
  __nv_bfloat16* Vs = Ks + BK * LD;                                // BK x LD
  __nv_bfloat16* Qs = Vs + BK * LD;                                // 2 x BQ x LD
  __nv_bfloat16* dOs = Qs + 2 * BQ * LD;                           // 2 x BQ x LD
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);         // 2 x BQ, log2 units
  float* Dl = Ls + 2 * BQ;                                         // 2 x BQ

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, c0 = (tid >> 7) * DW;   // rows, columns
  const int g = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;   // kv tile 0, the one most q rows see, first
  const int G = Hq / Hkv;
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;

  // q rows that can see a kv row of this tile: [q_lo, q_hi]
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq - 1, k0 + BK - 1 + window - 1) : Sq - 1;
  const int tq_lo = q_lo / BQ;
  const int nt = q_hi >= q_lo ? q_hi / BQ - tq_lo + 1 : 0;
  const int iters = G * nt;         // (q head, q tile) pairs

  auto load_q = [&](int i) {
    const int h = hk * G + i / nt, q0 = (tq_lo + i % nt) * BQ, buf = i & 1;
    const long long off = ((long long)b * Sq + q0) * Hq + h;
    mma::load_tile(Qs + buf * BQ * LD, LD, q + off * D, q_stride, BQ, Sq - q0,
                   D, D, vec, tid, NTH);
    mma::load_tile(dOs + buf * BQ * LD, LD, dout + off * D, q_stride, BQ,
                   Sq - q0, D, D, vec, tid, NTH);
    for (int e = tid; e < BQ; e += NTH) {
      const bool in = q0 + e < Sq;
      Ls[buf * BQ + e] = in ? lse[off + (long long)e * Hq] * LOG2E : 0.f;
      Dl[buf * BQ + e] = in ? delta[off + (long long)e * Hq] : 0.f;
    }
  };
  const long long kv_off = ((long long)b * Skv + k0) * Hkv + hk;
  mma::load_tile(Ks, LD, k + kv_off * D, kv_stride, BK, Skv - k0, D, D, vec,
                 tid, NTH);
  mma::load_tile(Vs, LD, v + kv_off * D, kv_stride, BK, Skv - k0, D, D, vec,
                 tid, NTH);
  mma::cp_async_commit();
  if (iters > 0) load_q(0);
  mma::cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;
  const int kw = k0 + warp * 16;    // first kv row of this warp

  for (int i = 0; i < iters; ++i) {
    if (i + 1 < iters) load_q(i + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();        // everything but tile i+1 has landed
    __syncthreads();
    const int q0 = (tq_lo + i % nt) * BQ, buf = i & 1;
    const __nv_bfloat16* Qt = Qs + buf * BQ * LD;
    const __nv_bfloat16* dOt = dOs + buf * BQ * LD;
    const float* Lt = Ls + buf * BQ;
    const float* Dt = Dl + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 64 q columns per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4], vf[4];
      load_a(kf, Ks, LD, warp * 16, ks, lane);
      load_a(vf, Vs, LD, warp * 16, ks, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        load_b_nk(bf, Qt, LD, np, ks, lane);
        mma::mma_bf16(s[2 * np], kf, bf[0], bf[1]);
        mma::mma_bf16(s[2 * np + 1], kf, bf[2], bf[3]);
        load_b_nk(bf, dOt, LD, np, ks, lane);
        mma::mma_bf16(dp[2 * np], vf, bf[0], bf[1]);
        mma::mma_bf16(dp[2 * np + 1], vf, bf[2], bf[3]);
      }
    }

    // P^T into s, dS^T into dp
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t4 + (c & 1);
        float p, ds;
        grad_terms<true>(s[n][c], dp[n][c], q0 + col, kw + g + (c >> 1) * 8,
                         Lt[col], Dt[col], Sq, Skv, causal, window, cap, scale,
                         p, ds);
        s[n][c] = p;
        dp[n][c] = ds;
      }

    // dV += P^T dO and dK += dS^T Q, summing over the tile's q rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pf[4], sf[4];
      pack_a(pf, s, kk);
      pack_a(sf, dp, kk);
#pragma unroll
      for (int e = 0; e < DW / 16; ++e) {
        uint32_t bf[4];
        load_b_kn(bf, dOt, LD, c0 / 16 + e, kk, lane);
        mma::mma_bf16(dva[2 * e], pf, bf[0], bf[1]);
        mma::mma_bf16(dva[2 * e + 1], pf, bf[2], bf[3]);
        load_b_kn(bf, Qt, LD, c0 / 16 + e, kk, lane);
        mma::mma_bf16(dka[2 * e], sf, bf[0], bf[1]);
        mma::mma_bf16(dka[2 * e + 1], sf, bf[2], bf[3]);
      }
    }
    __syncthreads();                // buffer `buf` is free for tile i+2
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + g + r * 8;
    if (kj >= Skv) continue;
    const long long row = (((long long)b * Skv + kj) * Hkv + hk) * D + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + row + n * 8) =
          mma::pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + n * 8) =
          mma::pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(mma_warps(D) * 32)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
                        int Hq, int Hkv, int causal, int window, float cap,
                        float scale, int vec) {
  constexpr int LD = D + mma::PAD;
  constexpr int KS = D / 16;
  constexpr int NTH = mma_warps(D) * 32;
  constexpr int DW = D * 4 / mma_warps(D);   // head-dim columns of a warp's dq
  constexpr int NT = DW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x LD
  __nv_bfloat16* dOs = Qs + BQ * LD;                               // BQ x LD
  __nv_bfloat16* Ks = dOs + BQ * LD;                               // 2 x BK x LD
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                            // 2 x BK x LD

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, c0 = (tid >> 7) * DW;   // rows, columns
  const int g = lane >> 2, t4 = lane & 3;
  // causal: the q tiles with the most kv tiles first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const long long q_stride = (long long)Hq * D;
  const long long kv_stride = (long long)Hkv * D;
  const long long q_off = ((long long)b * Sq + q0) * Hq + h;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * Hkv + hk) * D;

  // kv positions this q tile can see: [kv_lo, kv_hi]
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 - window + 1, 0) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = kv_hi >= kv_lo ? kv_hi / BK : t_lo - 1;

  auto load_kv = [&](int t) {
    const int kt0 = t * BK, buf = (t - t_lo) & 1;
    mma::load_tile(Ks + buf * BK * LD, LD, kb + kt0 * kv_stride, kv_stride, BK,
                   Skv - kt0, D, D, vec, tid, NTH);
    mma::load_tile(Vs + buf * BK * LD, LD, vb + kt0 * kv_stride, kv_stride, BK,
                   Skv - kt0, D, D, vec, tid, NTH);
  };
  mma::load_tile(Qs, LD, q + q_off * D, q_stride, BQ, Sq - q0, D, D, vec, tid,
                 NTH);
  mma::load_tile(dOs, LD, dout + q_off * D, q_stride, BQ, Sq - q0, D, D, vec,
                 tid, NTH);
  mma::cp_async_commit();
  if (t_lo <= t_hi) load_kv(t_lo);
  mma::cp_async_commit();

  const int qw = q0 + warp * 16;    // first q row of this warp
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + r * 8;
    const long long idx = ((long long)b * Sq + qi) * Hq + h;
    lse2[r] = qi < Sq ? lse[idx] * LOG2E : 0.f;
    dlt[r] = qi < Sq ? delta[idx] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    if (t < t_hi) load_kv(t + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();        // everything but tile t+1 has landed
    __syncthreads();
    const int kt0 = t * BK, buf = (t - t_lo) & 1;
    const __nv_bfloat16* Kt = Ks + buf * BK * LD;
    const __nv_bfloat16* Vt = Vs + buf * BK * LD;

    // S = Q K^T and dP = dO V^T: 16 q rows x 64 kv columns per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qf[4], df[4];
      load_a(qf, Qs, LD, warp * 16, ks, lane);
      load_a(df, dOs, LD, warp * 16, ks, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        load_b_nk(bf, Kt, LD, np, ks, lane);
        mma::mma_bf16(s[2 * np], qf, bf[0], bf[1]);
        mma::mma_bf16(s[2 * np + 1], qf, bf[2], bf[3]);
        load_b_nk(bf, Vt, LD, np, ks, lane);
        mma::mma_bf16(dp[2 * np], df, bf[0], bf[1]);
        mma::mma_bf16(dp[2 * np + 1], df, bf[2], bf[3]);
      }
    }

    // dS into s
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p, ds;
        grad_terms<true>(s[n][c], dp[n][c], qw + g + (c >> 1) * 8,
                         kt0 + n * 8 + 2 * t4 + (c & 1), lse2[c >> 1],
                         dlt[c >> 1], Sq, Skv, causal, window, cap, scale, p,
                         ds);
        s[n][c] = ds;
      }

    // dQ += dS K, summing over the tile's kv rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sf[4];
      pack_a(sf, s, kk);
#pragma unroll
      for (int e = 0; e < DW / 16; ++e) {
        uint32_t bf[4];
        load_b_kn(bf, Kt, LD, c0 / 16 + e, kk, lane);
        mma::mma_bf16(acc[2 * e], sf, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * e + 1], sf, bf[2], bf[3]);
      }
    }
    __syncthreads();                // buffer `buf` is free for tile t+2
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + g + r * 8;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (((long long)b * Sq + qi) * Hq + h) * D + c0 + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          mma::pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ------------------------------------------------------ bf16, wgmma ---

// wgmma path: lse2 = lse * log2 e and delta = rowsum(o * do), each as
// (B, Hq, Sqp) f32 with Sqp = Sq rounded up to 64.  Rows are read in their
// own order (b, q, h), 16 bytes a thread, D / 8 threads a row.  Rows past
// Sq and rows that saw no key (lse = NEG_INF) get lse2 = +inf and delta =
// 0: their p = 2^(x - inf) is exactly 0.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int B, int Sq, int Sqp,
                      int Hq) {
  constexpr int CH = D / 8;         // 16-byte chunks a row
  const int lane = threadIdx.x & 31;
  const long long n = (long long)B * Sq * Hq * CH;
  const long long step = (long long)gridDim.x * THREADS;
  const uint4* o4 = reinterpret_cast<const uint4*>(o);
  const uint4* d4 = reinterpret_cast<const uint4*>(dout);
  for (long long t0 = (long long)blockIdx.x * THREADS + (threadIdx.x & ~31);
       t0 < n; t0 += step) {        // whole warps, for the shuffles
    const long long t = t0 + lane;
    float acc = 0.f;
    if (t < n) {
      const uint4 a = o4[t], b = d4[t];
      const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 xf = mma::unpack_bf16(x[u]), yf = mma::unpack_bf16(y[u]);
        acc = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, acc));
      }
    }
#pragma unroll
    for (int off = CH / 2; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (t < n && t % CH == 0) {
      const long long row = t / CH;     // ((b * Sq) + q) * Hq + h
      const int h = (int)(row % Hq);
      const long long bq = row / Hq;
      const int qi = (int)(bq % Sq), b = (int)(bq / Sq);
      const long long out = ((long long)b * Hq + h) * Sqp + qi;
      const float l = lse[row];
      lse2[out] = l <= NEG_INF ? INFINITY : l * LOG2E;
      delta[out] = acc;
    }
  }
  const int pad = Sqp - Sq;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < (long long)B * Hq * pad; i += step) {
    const long long out = i / pad * Sqp + Sq + i % pad;
    lse2[out] = INFINITY;
    delta[out] = 0.f;
  }
}

// Shared memory of the wgmma kernels: 64-row tiles of NP = D/64 panels.
template <int D, int STAGES>
struct WgSmem {
  static constexpr int TILE = (D / 64) * hopper::PANEL_BYTES;
  static constexpr int FIXED = 2 * TILE;               // K, V or Q, dO
  static constexpr int STAGE_DKDV = 2 * TILE + 1024;   // Q, dO, lse2, delta
  static constexpr int STAGE_DQ = 2 * TILE;            // K, V
  static constexpr int BARS = (2 * STAGES + 1) * 8;
  static constexpr int DKDV = FIXED + STAGES * STAGE_DKDV + BARS + 1024;
  static constexpr int DQ = FIXED + STAGES * STAGE_DQ + BARS + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// the A operand of k-step kk (16 columns) from a 64 x 64 accumulator
__device__ __forceinline__ void pack_a_wg(uint32_t (&f)[4], const float (&x)[32], int kk) {
  f[0] = mma::pack_bf16(x[8 * kk], x[8 * kk + 1]);
  f[1] = mma::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  f[2] = mma::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  f[3] = mma::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

__device__ __forceinline__ bool seen(int qi, int kj, int Skv, int causal,
                                     int window) {
  return kj < Skv && (!causal || kj <= qi) && (!window || kj > qi - window);
}

// does the (q tile q0, kv tile k0) pair need masks?
__device__ __forceinline__ bool edge_tile(int q0, int k0, int Skv, int causal,
                                          int window) {
  return k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
         (window && k0 <= q0 + BQ - 1 - window);
}

// The terms of one tile from its raw scores s = q.k and dp = do.v, on the
// accumulator fragments: p = 2^(x log2 e - lse2) with x the scaled and
// capped score, and ds = p (dp - delta) (times 1 - (x/cap)^2 under the
// cap) without its factor D^-0.5, which the caller applies to dK or dQ
// once at the end.  c1 = D^-0.5 log2 e, or D^-0.5 / cap under the cap;
// c2 = cap log2 e.  MASK: the tile is cut by the diagonal, the window or
// Skv, and masked entries get p = ds = 0; other tiles skip the test.
template <bool CAP>
__device__ __forceinline__ void grad_terms_wg(float& s, float& dp, float l2,
                                              float dl, float c1, float c2) {
  if (CAP) {
    const float th = tanhf(s * c1);
    const float p = exp2_ftz(th * c2 - l2);
    dp = p * (1.f - th * th) * (dp - dl);
    s = p;
  } else {
    const float p = exp2_ftz(s * c1 - l2);
    dp = p * (dp - dl);
    s = p;
  }
}

// dk/dv: rows are kv rows kw (+ 8), columns the q rows q0 + 8j + 2t4 + c,
// whose lse2 and delta lie in shared memory
template <bool CAP, bool MASK>
__device__ __forceinline__ void dkdv_terms(float (&st)[32], float (&dpt)[32],
                                           const float* Lt, const float* Dt,
                                           int q0, int kw, int t4, int Skv,
                                           int causal, int window, float c1,
                                           float c2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * t4);
    const float2 dl = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * t4);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * r + c;
        grad_terms_wg<CAP>(st[e], dpt[e], c ? l2.y : l2.x, c ? dl.y : dl.x,
                           c1, c2);
        if (MASK && !seen(q0 + 8 * j + 2 * t4 + c, kw + 8 * r, Skv, causal, window))
          st[e] = dpt[e] = 0.f;
      }
  }
}

// dq: rows are q rows qw (+ 8) with their lse2 and delta in registers,
// columns the kv rows k0 + 8j + 2t4 + c; ds goes into dp
template <bool CAP, bool MASK>
__device__ __forceinline__ void dq_terms(float (&sc)[32], float (&dp)[32],
                                         const float (&l2)[2],
                                         const float (&dl)[2], int qw, int k0,
                                         int t4, int Skv, int causal,
                                         int window, float c1, float c2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * r + c;
        grad_terms_wg<CAP>(sc[e], dp[e], l2[r], dl[r], c1, c2);
        if (MASK && !seen(qw + 8 * r, k0 + 8 * j + 2 * t4 + c, Skv, causal, window))
          dp[e] = 0.f;
      }
}

template <int D, int STAGES, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, D == 64 ? 2 : 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse2,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int Sq, int Sqp,
                            int Skv, int Hq, int Hkv, int causal, int window,
                            float cap, float scale) {
  using L = WgSmem<D, STAGES>;
  constexpr int NP = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = align1024(smem_wg);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::TILE;
  unsigned char* stages = smem + L::FIXED;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * L::STAGE_DKDV);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;   // kv tile 0, the one most q rows see, first
  const int G = Hq / Hkv;
  // q rows that can see a kv row of this tile: [q_lo, q_hi]
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq - 1, k0 + BK - 1 + window - 1) : Sq - 1;
  const int tq_lo = q_lo / BQ;
  const int nt = q_hi >= q_lo ? q_hi / BQ - tq_lo + 1 : 0;
  const int iters = G * nt;         // (q head, q tile) pairs

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                  // producer
    if (lane == 0 && iters > 0) {
      hopper::mbar_expect_tx(kv_bar, 2 * L::TILE);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_4d(Ks + p * hopper::PANEL_BYTES, &k_map, kv_bar, p * 64, hk, k0, b);
        hopper::tma_load_4d(Vs + p * hopper::PANEL_BYTES, &v_map, kv_bar, p * 64, hk, k0, b);
      }
      for (int i = 0; i < iters; ++i) {
        const int s = i % STAGES, u = i / STAGES;
        if (u > 0) hopper::mbar_wait(&empty[s], (u - 1) & 1);
        const int h = hk * G + i / nt, q0 = (tq_lo + i % nt) * BQ;
        unsigned char* st = stages + s * L::STAGE_DKDV;
        hopper::mbar_expect_tx(&full[s], 2 * L::TILE + 2 * BQ * 4);
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_4d(st + p * hopper::PANEL_BYTES, &q_map, &full[s], p * 64, h, q0, b);
          hopper::tma_load_4d(st + L::TILE + p * hopper::PANEL_BYTES, &do_map, &full[s],
                              p * 64, h, q0, b);
        }
        const long long row = ((long long)b * Hq + h) * Sqp + q0;
        hopper::bulk_load(st + 2 * L::TILE, lse2 + row, BQ * 4, &full[s]);
        hopper::bulk_load(st + 2 * L::TILE + BQ * 4, delta + row, BQ * 4, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup: kv rows k0 + 16 warp + g (+ 8)
  const int g = lane >> 2, t4 = lane & 3;
  const float c1 = CAP ? scale / cap : scale * LOG2E, c2 = cap * LOG2E;
  const int kw = k0 + warp * 16 + g;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dka[n] = dva[n] = 0.f;
  if (iters > 0) hopper::mbar_wait(kv_bar, 0);

  for (int i = 0; i < iters; ++i) {
    const int s = i % STAGES, u = i / STAGES;
    const int q0 = (tq_lo + i % nt) * BQ;
    const unsigned char* Qt = stages + s * L::STAGE_DKDV;
    const unsigned char* dOt = Qt + L::TILE;
    const float* Lt = reinterpret_cast<const float*>(Qt + 2 * L::TILE);
    const float* Dt = Lt + BQ;
    hopper::mbar_wait(&full[s], u & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns
    float st[32], dpt[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_ss<64, 0>(st, hopper::desc_kmajor(Ks, ks),
                              hopper::desc_kmajor(Qt, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_ss<64, 0>(dpt, hopper::desc_kmajor(Vs, ks),
                              hopper::desc_kmajor(dOt, ks), ks);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // P^T into st, dS^T into dpt
    if (edge_tile(q0, k0, Skv, causal, window))
      dkdv_terms<CAP, true>(st, dpt, Lt, Dt, q0, kw, t4, Skv, causal, window, c1, c2);
    else
      dkdv_terms<CAP, false>(st, dpt, Lt, Dt, q0, kw, t4, Skv, causal, window, c1, c2);

    // dV += P^T dO and dK += dS^T Q, summing over the tile's q rows
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a_wg(pa[kk], st, kk);
      pack_a_wg(sa[kk], dpt, kk);
    }
    hopper::wgmma_fence();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<D, 1>(dva, pa[kk], hopper::desc_mnmajor(dOt, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<D, 1>(dka, sa[kk], hopper::desc_mnmajor(Qt, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dva);
    hopper::fence_regs(dka);
    hopper::mbar_arrive(&empty[s]);   // the stage is free for the producer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kw + 8 * r;
    if (kj >= Skv) continue;
    const long long row = (((long long)b * Skv + kj) * Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * j) =
          mma::pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * j) =
          mma::pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, int STAGES, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, D == 64 ? 3 : 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Sqp,
                          int Skv, int Hq, int Hkv, int causal, int window,
                          float cap, float scale) {
  using L = WgSmem<D, STAGES>;
  constexpr int NP = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = align1024(smem_wg);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + L::TILE;
  unsigned char* stages = smem + L::FIXED;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * L::STAGE_DQ);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // causal: the q tiles with the most kv tiles first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  // kv positions this q tile can see: [kv_lo, kv_hi]
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 - window + 1, 0) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = kv_hi >= kv_lo ? kv_hi / BK : t_lo - 1;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {                  // producer
    if (lane == 0 && t_lo <= t_hi) {
      hopper::mbar_expect_tx(q_bar, 2 * L::TILE);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_4d(Qs + p * hopper::PANEL_BYTES, &q_map, q_bar, p * 64, h, q0, b);
        hopper::tma_load_4d(dOs + p * hopper::PANEL_BYTES, &do_map, q_bar, p * 64, h, q0, b);
      }
      for (int t = t_lo; t <= t_hi; ++t) {
        const int i = t - t_lo, s = i % STAGES, u = i / STAGES;
        if (u > 0) hopper::mbar_wait(&empty[s], (u - 1) & 1);
        unsigned char* st = stages + s * L::STAGE_DQ;
        hopper::mbar_expect_tx(&full[s], 2 * L::TILE);
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_4d(st + p * hopper::PANEL_BYTES, &k_map, &full[s], p * 64, hk, t * BK, b);
          hopper::tma_load_4d(st + L::TILE + p * hopper::PANEL_BYTES, &v_map, &full[s],
                              p * 64, hk, t * BK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: q rows q0 + 16 warp + g (+ 8)
  const int g = lane >> 2, t4 = lane & 3;
  const float c1 = CAP ? scale / cap : scale * LOG2E, c2 = cap * LOG2E;
  const int qw = q0 + warp * 16 + g;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long idx = ((long long)b * Hq + h) * Sqp + qw + 8 * r;
    l2[r] = lse2[idx];
    dl[r] = delta[idx];
  }
  float dqa[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dqa[n] = 0.f;
  if (t_lo <= t_hi) hopper::mbar_wait(q_bar, 0);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int i = t - t_lo, s = i % STAGES, u = i / STAGES;
    const int k0 = t * BK;
    const unsigned char* Kt = stages + s * L::STAGE_DQ;
    const unsigned char* Vt = Kt + L::TILE;
    hopper::mbar_wait(&full[s], u & 1);

    // S = Q K^T and dP = dO V^T: 64 q rows x 64 kv columns
    float sc[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_ss<64, 0>(sc, hopper::desc_kmajor(Qs, ks),
                              hopper::desc_kmajor(Kt, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_ss<64, 0>(dp, hopper::desc_kmajor(dOs, ks),
                              hopper::desc_kmajor(Vt, ks), ks);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // dS into dp
    if (edge_tile(q0, k0, Skv, causal, window))
      dq_terms<CAP, true>(sc, dp, l2, dl, qw, k0, t4, Skv, causal, window, c1, c2);
    else
      dq_terms<CAP, false>(sc, dp, l2, dl, qw, k0, t4, Skv, causal, window, c1, c2);

    // dQ += dS K, summing over the tile's kv rows
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a_wg(sa[kk], dp, kk);
    hopper::wgmma_fence();
    hopper::fence_regs(dqa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<D, 1>(dqa, sa[kk], hopper::desc_mnmajor(Kt, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dqa);
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + (((long long)b * Sq + qi) * Hq + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          mma::pack_bf16(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------- f32 ---

// T: rows of a q tile and of a kv tile; 64, and 32 at D = 256, where 64
// rows would give each thread 4 x 32 dk and 4 x 32 dv accumulators and
// four tiles of 263 KB.  Each thread owns RT = T/16 rows and CT = T/8
// columns of the T x T score tile.
template <int D, int T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                      int causal, int window, float cap, float scale) {
  constexpr int LD = D + 1;     // padded row stride of the Q/dO/K/V tiles
  constexpr int LP = T + 1;     // padded row stride of the P and dS tiles
  constexpr int DC = D / 8;     // dk/dv columns per thread
  constexpr int RT = T / 16;    // kv rows per thread
  constexpr int CT = T / 8;     // q columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // T x LD
  float* Vs = Ks + T * LD;      // T x LD
  float* Qs = Vs + T * LD;      // T x LD
  float* dOs = Qs + T * LD;     // T x LD
  float* Ps = dOs + T * LD;     // T x LP
  float* Ss = Ps + T * LP;      // T x LP
  float* Ls = Ss + T * LP;      // T
  float* Dl = Ls + T;           // T

  const int tid = threadIdx.x;
  const int tr = tid >> 3;      // kv rows tr*RT .. tr*RT+RT-1
  const int tc = tid & 7;       // q columns tc + 8j; d columns tc + 8c
  const int k0 = blockIdx.x * T;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  for (int i = tid; i < T * D; i += THREADS) {
    const int r = i / D, d = i % D, kj = k0 + r;
    const bool in = kj < Skv;
    Ks[r * LD + d] = in ? kb[(size_t)kj * kv_stride + d] : 0.f;
    Vs[r * LD + d] = in ? vb[(size_t)kj * kv_stride + d] : 0.f;
  }
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window ? min(Sq - 1, k0 + T - 1 + window - 1) : Sq - 1;

  float dka[RT][DC], dva[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int h = hk * G; h < (hk + 1) * G; ++h) {
    const float* qb = q + ((size_t)b * Sq * Hq + h) * D;
    const float* dob = dout + ((size_t)b * Sq * Hq + h) * D;
    for (int q0 = (q_lo / T) * T; q0 <= q_hi; q0 += T) {
      __syncthreads();          // the previous tile is no longer read
      for (int i = tid; i < T * D; i += THREADS) {
        const int r = i / D, d = i % D, qi = q0 + r;
        const bool in = qi < Sq;
        Qs[r * LD + d] = in ? qb[(size_t)qi * q_stride + d] : 0.f;
        dOs[r * LD + d] = in ? dob[(size_t)qi * q_stride + d] : 0.f;
      }
      for (int e = tid; e < T; e += THREADS) {
        const bool in = q0 + e < Sq;
        const size_t idx = ((size_t)b * Sq + q0 + e) * Hq + h;
        Ls[e] = in ? lse[idx] : 0.f;
        Dl[e] = in ? delta[idx] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this thread's RT x CT entries
      float s[RT][CT], dp[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[RT], av[RT], bq[CT], bd[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          a[i] = Ks[(tr * RT + i) * LD + d];
          av[i] = Vs[(tr * RT + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          bq[j] = Qs[(tc + 8 * j) * LD + d];
          bd[j] = dOs[(tc + 8 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            s[i][j] = fmaf(a[i], bq[j], s[i][j]);
            dp[i][j] = fmaf(av[i], bd[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int col = tc + 8 * j;
          float p, ds;
          grad_terms<false>(s[i][j], dp[i][j], q0 + col, k0 + tr * RT + i,
                            Ls[col], Dl[col], Sq, Skv, causal, window, cap,
                            scale, p, ds);
          Ps[(tr * RT + i) * LP + col] = p;
          Ss[(tr * RT + i) * LP + col] = ds;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int jj = 0; jj < T; ++jj) {
        float p[RT], ds[RT], dov[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          p[i] = Ps[(tr * RT + i) * LP + jj];
          ds[i] = Ss[(tr * RT + i) * LP + jj];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = dOs[jj * LD + tc + 8 * c];
          qv[c] = Qs[jj * LD + tc + 8 * c];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[i][c] = fmaf(p[i], dov[c], dva[i][c]);
            dka[i][c] = fmaf(ds[i], qv[c], dka[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kj = k0 + tr * RT + i;
    if (kj >= Skv) continue;
    const size_t row = (((size_t)b * Skv + kj) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[row + tc + 8 * c] = dka[i][c];
      dv[row + tc + 8 * c] = dva[i][c];
    }
  }
}

template <int D, int T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                    float cap, float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = T + 1;
  constexpr int DC = D / 8;
  constexpr int RT = T / 16;    // q rows per thread
  constexpr int CT = T / 8;     // kv columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // T x LD
  float* dOs = Qs + T * LD;     // T x LD
  float* Ks = dOs + T * LD;     // T x LD
  float* Vs = Ks + T * LD;      // T x LD
  float* Ss = Vs + T * LD;      // T x LP

  const int tid = threadIdx.x;
  const int tr = tid >> 3;      // q rows tr*RT .. tr*RT+RT-1
  const int tc = tid & 7;       // kv columns tc + 8j; d columns tc + 8c
  const int q0 = blockIdx.x * T;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const float* qb = q + ((size_t)b * Sq * Hq + h) * D;
  const float* dob = dout + ((size_t)b * Sq * Hq + h) * D;
  const float* kb = k + ((size_t)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((size_t)b * Skv * Hkv + hk) * D;

  for (int i = tid; i < T * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    const bool in = qi < Sq;
    Qs[r * LD + d] = in ? qb[(size_t)qi * q_stride + d] : 0.f;
    dOs[r * LD + d] = in ? dob[(size_t)qi * q_stride + d] : 0.f;
  }
  float lse_r[RT], dlt_r[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + tr * RT + i;
    const size_t idx = ((size_t)b * Sq + qi) * Hq + h;
    lse_r[i] = qi < Sq ? lse[idx] : 0.f;
    dlt_r[i] = qi < Sq ? delta[idx] : 0.f;
  }
  const int q_last = min(q0 + T, Sq) - 1;
  const int kv_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 - window + 1, 0) : 0;

  float acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = (kv_lo / T) * T; k0 <= kv_hi; k0 += T) {
    __syncthreads();            // the previous tile is no longer read
    for (int i = tid; i < T * D; i += THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r * LD + d] = in ? kb[(size_t)kj * kv_stride + d] : 0.f;
      Vs[r * LD + d] = in ? vb[(size_t)kj * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[RT][CT], dp[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RT], ad[RT], bk[CT], bv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        a[i] = Qs[(tr * RT + i) * LD + d];
        ad[i] = dOs[(tr * RT + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        bk[j] = Ks[(tc + 8 * j) * LD + d];
        bv[j] = Vs[(tc + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        float p, ds;
        grad_terms<false>(s[i][j], dp[i][j], q0 + tr * RT + i, k0 + tc + 8 * j,
                          lse_r[i], dlt_r[i], Sq, Skv, causal, window, cap,
                          scale, p, ds);
        Ss[(tr * RT + i) * LP + tc + 8 * j] = ds;
      }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float ds[RT], kv[DC];
#pragma unroll
      for (int i = 0; i < RT; ++i) ds[i] = Ss[(tr * RT + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * LD + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + tr * RT + i;
    if (qi >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[(((size_t)b * Sq + qi) * Hq + h) * D + tc + 8 * c] = acc[i][c];
  }
}

// ------------------------------------------------------------- launch ---

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Skv, Hq, Hkv, causal, window;
  float cap, scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a, int D) {
  const long long rows = (long long)a.B * a.Sq * a.Hq;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  flash_bwd_delta_kernel<T><<<(unsigned)(blocks < 65536 ? blocks : 65536),
                              THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  cudaError_t err = launch_delta<float>(a, D);
  if (err != cudaSuccess) return err;
  constexpr int T = D > 128 ? 32 : 64;
  const size_t smem_kv = (size_t)(4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T) * sizeof(float);
  const size_t smem_q = (size_t)(4 * T * (D + 1) + T * (T + 1)) * sizeof(float);
  auto kv_kernel = flash_bwd_dkdv_kernel<D, T>;
  auto q_kernel = flash_bwd_dq_kernel<D, T>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  if (a.B > 65535 || a.Hq > 65535) return cudaErrorInvalidValue;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  kv_kernel<<<dim3((a.Skv + T - 1) / T, a.Hkv, a.B), THREADS, smem_kv, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.cap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((a.Sq + T - 1) / T, a.Hq, a.B), THREADS, smem_q, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq),
      a.Sq, a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.cap, a.scale);
  return cudaGetLastError();
}

// D = 16, 32 or 256: the delta pass, then dk/dv and dq on mma.sync
template <int D>
cudaError_t launch_bf16(const Args& a) {
  cudaError_t err = launch_delta<__nv_bfloat16>(a, D);
  if (err != cudaSuccess) return err;
  constexpr int LD = D + mma::PAD;
  const size_t smem_kv = (size_t)(2 * BK + 4 * BQ) * LD * sizeof(__nv_bfloat16) + 4 * BQ * sizeof(float);
  const size_t smem_q = (size_t)(2 * BQ + 4 * BK) * LD * sizeof(__nv_bfloat16);
  auto kv_kernel = flash_bwd_dkdv_mma_kernel<D>;
  auto q_kernel = flash_bwd_dq_mma_kernel<D>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  const int nq = (a.Sq + BQ - 1) / BQ, nk = (a.Skv + BK - 1) / BK;
  if (a.B > 65535 || nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  // cp.async needs 16-byte aligned rows: the row strides (Hq*D, Hkv*D
  // elements) are multiples of 16 bytes, so only the base pointers decide
  const int vec = ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                    reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout)) &
                   15) == 0;
  using bf = __nv_bfloat16;
  const bf *q = static_cast<const bf*>(a.q), *k = static_cast<const bf*>(a.k),
           *v = static_cast<const bf*>(a.v), *dout = static_cast<const bf*>(a.dout);
  constexpr int NTH = mma_warps(D) * 32;
  kv_kernel<<<dim3(a.Hkv, a.B, nk), NTH, smem_kv, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
      a.Sq, a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.cap, a.scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3(a.Hq, a.B, nq), NTH, smem_q, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dq),
      a.Sq, a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.cap, a.scale, vec);
  return cudaGetLastError();
}

// D = 64 or 128: the delta pass, then dk/dv and dq on wgmma.  The scratch
// `delta` holds lse2 and delta, each (B, Hq, Sqp).
template <int D>
cudaError_t launch_wgmma(const Args& a) {
  constexpr int STAGES = D == 64 ? 3 : 2;
  using L = WgSmem<D, STAGES>;
  const int Sqp = (a.Sq + BQ - 1) / BQ * BQ;
  float* lse2 = a.delta;
  float* delta = a.delta + (long long)a.B * a.Hq * Sqp;
  const int nq = Sqp / BQ, nk = (a.Skv + BK - 1) / BK;
  if (a.B > 65535 || nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  // TMA, and the delta pass's 16-byte loads of o and dout, read 16-byte
  // aligned bases (the wrapper checks them too)
  if (((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
        reinterpret_cast<uintptr_t>(a.dout)) & 15) != 0)
    return cudaErrorMisalignedAddress;
  CUtensorMap qm, km, vm, dom;
  if (hopper::bshd_map(&qm, a.q, a.B, a.Sq, a.Hq, D) != CUDA_SUCCESS ||
      hopper::bshd_map(&km, a.k, a.B, a.Skv, a.Hkv, D) != CUDA_SUCCESS ||
      hopper::bshd_map(&vm, a.v, a.B, a.Skv, a.Hkv, D) != CUDA_SUCCESS ||
      hopper::bshd_map(&dom, a.dout, a.B, a.Sq, a.Hq, D) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  const long long chunks = (long long)a.B * a.Sq * a.Hq * (D / 8);
  const long long blocks = (chunks + THREADS - 1) / THREADS;
  using bf = __nv_bfloat16;
  flash_bwd_prep_kernel<D><<<(unsigned)(blocks < 65536 ? blocks : 65536),
                             THREADS, 0, a.stream>>>(
      static_cast<const bf*>(a.o), static_cast<const bf*>(a.dout), a.lse, lse2,
      delta, a.B, a.Sq, Sqp, a.Hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv_kernel = a.cap != 0.f ? flash_bwd_dkdv_wgmma_kernel<D, STAGES, true>
                                : flash_bwd_dkdv_wgmma_kernel<D, STAGES, false>;
  auto q_kernel = a.cap != 0.f ? flash_bwd_dq_wgmma_kernel<D, STAGES, true>
                               : flash_bwd_dq_wgmma_kernel<D, STAGES, false>;
  err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DKDV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DQ);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3(a.Hkv, a.B, nk), WG_THREADS, L::DKDV, a.stream>>>(
      qm, km, vm, dom, lse2, delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
      a.Sq, Sqp, a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.cap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3(a.Hq, a.B, nq), WG_THREADS, L::DQ, a.stream>>>(
      qm, km, vm, dom, lse2, delta, static_cast<bf*>(a.dq),
      a.Sq, Sqp, a.Skv, a.Hq, a.Hkv, a.causal, a.window, a.cap, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const Args& a, int D, bool bf16) {
  switch (D) {
    case 16: return bf16 ? launch_bf16<16>(a) : launch_f32<16>(a);
    case 32: return bf16 ? launch_bf16<32>(a) : launch_f32<32>(a);
    case 64: return bf16 ? launch_wgmma<64>(a) : launch_f32<64>(a);
    case 128: return bf16 ? launch_wgmma<128>(a) : launch_f32<128>(a);
    case 256: return bf16 ? launch_bf16<256>(a) : launch_f32<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes.  q, o, dout, dq: (B,Sq,Hq,D); k, v, dk, dv:
// (B,Skv,Hkv,D), all contiguous, float32 (dtype 0, CUDA-core kernels) or
// bfloat16 (dtype 1, tensor-core kernels; at D = 64 and 128 q, k, v, dout
// 16-byte aligned for TMA); lse: f32 (B,Sq,Hq), as flash_attention_fwd
// writes it; delta: f32 scratch of 2 * B * Hq * (Sq rounded up to 64)
// elements.  Three launches on `stream` without synchronising; returns the
// first CUDA error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int D, int dtype,
                                   int causal, int window, float cap,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
               causal, window, cap, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 || dtype == 1) return (int)dispatch_d(a, D, dtype == 1);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
