// Mamba2 SSD intra-chunk terms for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py::_kernel
// (pallas_call in ssd_chunk_kernel).  Per (batch b, head h, chunk c) of
// length Q, with cum = inclusive cumsum(dt * A) over the chunk:
//   y_intra[i]  = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j
//   state       = sum_j x_j (outer) B_j * (exp(cum_{Q-1} - cum_j) * dt_j)
//   decay_all   = exp(cum),  decay_chunk = exp(cum_{Q-1})
// Everything is computed in f32 from x, B, C in f32 or bf16 and dt, A in
// f32, except cum, which is summed and differenced in f64: |cum| reaches
// ~1000 across a 256-long chunk at the model's decays, where an f32 cum
// carries ~1e-4 of absolute error into every exp(cum_i - cum_j) (the
// reference's f32 cumsum does; tools/ssd_conditioning.py measures both
// against a float64 truth).  Above the diagonal the pairwise decay is a select, never a product
// with a mask: there cum_i - cum_j is large and positive, its exp is inf,
// and inf * 0 would be NaN.
//
// Layout.  x (B,S,H,P) is read in place through its batch and sequence
// strides (heads packed at stride P, elements at stride 1), and B, C (B,S,N)
// through theirs, so the split views of the model's xBC projection need no
// copy.  dt (B,S,H) and A (H,) are contiguous f32.  Outputs are contiguous
// f32 in the reference's layouts: y_intra (B,S,H,P), states (B,H,nc,P,N),
// decay_all (B,H,nc,Q), decay_chunk (B,H,nc).
//
// Three routes, chosen by the input type and, for bf16, by shape and layout
// alone (`route`, from kernels/ssd.py::ssd_route; the library checks the
// same rule, wgmma_shape, and refuses a route the inputs do not fit); none
// falls back to another:
//  - bf16 at P = 64 or 128, N a multiple of 16 up to 256, Q a multiple of
//    64 up to 256, x, B and C 16-byte aligned with strides of 8 elements
//    (the models' full widths, the split views of xBC): wgmma fed by TMA,
//    ssd_chunk_prep_kernel and ssd_chunk_wgmma_kernel<P> (below, "bf16,
//    wgmma + TMA");
//  - every other bf16 shape: mma.sync, ssd_chunk_mma_kernel;
//  - f32: the CUDA cores, ssd_chunk_kernel.
//
// bf16 off the wgmma route: ssd_chunk_mma_kernel, on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate).  All heads share B and C, so one block of 4 warps
// serves a group of G heads of one (batch, chunk), G chosen so that the grid
// holds at least 8 blocks per SM.  Its roles:
//  - y blocks, one per 64-row tile i of the chunk: C B^T for the rows of the
//    tile and every j at or below it, once for all G heads, as bf16 products
//    (exact in f32) summed in f32, kept in shared memory as a band of up to
//    64 x 256 f32 (longer chunks go in slabs of 256 columns; y is then
//    summed in place).  Then for each head the tiles of x_h stream through
//    a cp.async double buffer; each warp builds M = CB * exp(cum_i - cum_j)
//    * dt_j for its 16 rows in registers, in the A layout (below its
//    diagonal 16 x 16 block as CB * exp(cum_i - cum_r) * [exp(cum_r -
//    cum_j) * dt_j], r the last column of the k-step, the bracket computed
//    once per head and column: two exps per k-step instead of eight; both
//    factors are at most 1 and both differences are taken in f64), splits it into
//    three bf16 parts (M to about 2^-27 relative, as good as f32; x is bf16
//    and exact) and runs all three through the tensor cores into one f32
//    accumulator, x read with ldmatrix.trans.  k-steps wholly above the diagonal are skipped at
//    16-row granularity.
//  - state blocks, one per 64 state columns: the tiles of x_h and B stream
//    through a cp.async double buffer; w_j = exp(cum_{Q-1} - cum_j) * dt_j
//    scales B's fragments in registers, split in three the same way, and the
//    state x^T (w B) accumulates over the chunk, x read with ldmatrix.trans.
//    The first state block also writes decay_all and decay_chunk.
// The state blocks, the largest, come first in the grid, then the y tiles
// from the last (most j tiles) down.  Each block scans cum per head with
// all its threads, in f64.  Tiles load with 16-byte cp.async when the views
// allow it (base 16-byte aligned, strides and widths multiples of 8
// elements: the model's split views of xBC do) and with element loads
// otherwise; N and P are zero-padded to multiples of 16 in shared memory.
//
// f32: ssd_chunk_kernel<PC>, products in f32 FMA on the CUDA cores,
// as the f32 tolerance needs.  One 256-thread block per (64-row tile or
// state, head, chunk, batch); tiles staged through shared memory as f32.
//
// Bound on this card.  At the mamba2-1.3b prefill shape (B=8, S=1024, H=64,
// P=64, N=128, Q=256, bf16 in) one call reads about 73 MB and writes about
// 204 MB of f32 outputs, against about 17.5 GFLOP of products (lower
// triangle only, C B^T once per (b, c); about 52 GFLOP with M and w x
// split in three), so it is bound by bytes, mostly its f32 outputs: the
// wgmma route writes them by TMA stores from a staging tile under the next
// head's products.  Fusing the recurrence between chunks (fewer output
// bytes) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_helpers.cuh"
#include "mma_helpers.cuh"

namespace {

constexpr int TQ = 64;          // chunk rows per tile
constexpr int THREADS = 256;    // f32: 16 row groups x 16 column lanes
constexpr int NSLAB = 128;      // f32: state columns per pass: 16 lanes x 8
constexpr int LM = TQ + 1;      // f32: padded row stride of the M tile
constexpr int MT = 128;         // bf16: 4 warps
constexpr int JS = 256;         // bf16: j columns of the C B^T band per slab
constexpr int NS = 64;          // bf16: state columns per state block
constexpr int LS = NS + mma::PAD;   // bf16: row stride of a state block's B tile
constexpr int GMAX = 16;        // bf16: most heads per block

struct Args {
  const void* x; const float* dt; const float* A; const void* Bm; const void* Cm;
  float* y; float* st; float* dall; float* dch;
  int S, H, P, N, Q, nc, n_it;
  long long sxb, sxs, sbb, sbs, scb, scs;   // strides in elements
  // bf16 kernel only
  int G, n_grp, n_st, n_pad, vx, vbc;      // heads per block, groups, state
                                           // blocks, padded N, cp.async ok
  unsigned char* rec;                      // wgmma route: the heads' records
};

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(double) * (size_t)Q +
         sizeof(float) * ((size_t)Q + (size_t)2 * TQ * (N + 1) +
                          (size_t)TQ * (P + 1) + (size_t)TQ * LM);
}

// ---------------------------------------------------------------- bf16 ---

__host__ __device__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// cum and the scan's 4 warp totals (f64), dt of two heads and w (f32)
__host__ __device__ size_t mma_head_bytes(int Q) { return align16((size_t)Q * 20 + 4 * sizeof(double)); }

size_t mma_smem_bytes(int Q, int n_it, int n_pad, int LX) {
  const size_t LN = n_pad + mma::PAD, LB = (size_t)std::min(n_it, JS / TQ) * TQ + 8;
  const size_t y = TQ * LN * 2 + TQ * LB * 4 + std::max(TQ * LN * 2, (size_t)2 * TQ * LX * 2);
  const size_t st = (size_t)2 * TQ * (LX + LS) * 2;
  return mma_head_bytes(Q) + std::max(y, st);
}

// Start copying dt of one head, rows [0, n) of the chunk, into dts.
__device__ __forceinline__ void load_dt(float* dts, const float* dtg, int H, int n) {
  for (int t = threadIdx.x; t < n; t += MT) mma::cp_async4(dts + t, dtg + (long long)t * H);
}

// cum[t] = sum_{u<=t} (double)(dts[t] * A_h) for t < n, by all MT threads:
// a sequential run per thread, then a scan of the runs.  The caller has
// synchronised (dts has landed); returns synchronised.
__device__ void chunk_cum(const float* dts, float Ah, int n, double* cum,
                          double* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + MT - 1) / MT;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  double run = 0.0;
  for (int t = lo; t < hi; ++t) {
    run += (double)(dts[t] * Ah);     // the log-decay itself rounds in f32
    cum[t] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  double before = incl - run;
  for (int w = 0; w < warp; ++w) before += wtot[w];
  for (int t = lo; t < hi; ++t) cum[t] += before;
  __syncthreads();
}

// PT = P_pad / 16: m-tiles of the state, pairs of n-tiles of y.
template <int PT>
__global__ void __launch_bounds__(MT) ssd_chunk_mma_kernel(Args a) {
  constexpr int PP = PT * 16, LX = PP + mma::PAD;
  const int Q = a.Q, N = a.N, P = a.P, H = a.H;
  const int n_pad = a.n_pad, LN = n_pad + mma::PAD;
  const int LB = min(a.n_it, JS / TQ) * TQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);      // Q
  double* wtot = cum + Q;                                 // 4
  float* dts = reinterpret_cast<float*>(wtot + 4);        // 2 x Q: heads in turn
  float* ws = dts + 2 * Q;                                // Q
  unsigned char* rest = smem_raw + mma_head_bytes(Q);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_roles = a.n_st + a.n_it;
  int bid = blockIdx.x;
  const int role = bid % n_roles;
  bid /= n_roles;
  const int grp = bid % a.n_grp;
  bid /= a.n_grp;
  const int c = bid % a.nc;
  const int b = bid / a.nc;
  const int h0 = grp * a.G, G = min(a.G, H - h0);
  const long long s0 = (long long)c * Q;    // first position of the chunk

  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) + b * a.sxb + s0 * a.sxs;
  const __nv_bfloat16* Bg = static_cast<const __nv_bfloat16*>(a.Bm) + b * a.sbb + s0 * a.sbs;
  const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(a.Cm) + b * a.scb + s0 * a.scs;
  const float* dtg = a.dt + ((long long)b * a.S + s0) * H;
  const bool vx = a.vx, vbc = a.vbc;

  if (role >= a.n_st) {
    // ---- y_intra for rows i0 .. i0+63 of the chunk, heads h0 .. h0+G-1 ----
    const int it = a.n_it - 1 - (role - a.n_st);
    const int i0 = it * TQ, i_end = min(i0 + TQ, Q);
    __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(rest);          // TQ x LN
    float* band = reinterpret_cast<float*>(rest + TQ * LN * 2);          // TQ x LB
    __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(
        rest + TQ * LN * 2 + TQ * LB * 4);                               // TQ x LN
    __nv_bfloat16* Xs = Bs;                                              // 2 x TQ x LX
    const int wrow = i0 + warp * 16;        // first row of this warp
    const bool wact = wrow < Q;             // rows past the chunk are not stored
    mma::load_tile(Cs, LN, Cg + (long long)i0 * a.scs, a.scs, TQ, Q - i0, N,
                   n_pad, vbc, tid, MT);
    mma::cp_async_commit();

    for (int jt0 = 0; jt0 <= it; jt0 += JS / TQ) {
      const int jt1 = min(jt0 + JS / TQ, it + 1), njs = jt1 - jt0;
      // C B^T for the band's j tiles, 16 rows x 64 columns per warp
      for (int jt = jt0; jt < jt1; ++jt) {
        __syncthreads();                    // Bs (and the x buffers) are free
        mma::load_tile(Bs, LN, Bg + (long long)jt * TQ * a.sbs, a.sbs, TQ,
                       Q - jt * TQ, N, n_pad, vbc, tid, MT);
        mma::cp_async_commit();
        mma::cp_async_wait<0>();
        __syncthreads();
        if (!wact) continue;
        float cb[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
        for (int ks = 0; ks < n_pad / 16; ++ks) {
          uint32_t af[4];
          mma::ldmatrix_x4(af, Cs + (warp * 16 + (lane & 15)) * LN + ks * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bf[4];
            mma::ldmatrix_x4(bf, Bs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LN +
                                     ks * 16 + ((lane >> 3) & 1) * 8);
            mma::mma_bf16(cb[2 * np], af, bf[0], bf[1]);
            mma::mma_bf16(cb[2 * np + 1], af, bf[2], bf[3]);
          }
        }
        float* brow = band + (warp * 16 + g) * LB + (jt - jt0) * TQ + 2 * t4;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<float2*>(brow + n * 8) = make_float2(cb[n][0], cb[n][1]);
          *reinterpret_cast<float2*>(brow + 8 * LB + n * 8) = make_float2(cb[n][2], cb[n][3]);
        }
      }
      __syncthreads();                      // the band is complete; Bs is free

      // y_h += M_h x_h over the band, the (head, j tile) tiles streamed
      const int n_tiles = G * njs;
      auto load_x = [&](int k) {          // with the head's dt at its first tile
        const int hh = k / njs, jt = jt0 + k - hh * njs;
        mma::load_tile(Xs + (k & 1) * TQ * LX, LX,
                       xg + (long long)jt * TQ * a.sxs + (long long)(h0 + hh) * P,
                       a.sxs, TQ, Q - jt * TQ, P, PP, vx, tid, MT);
        if (jt == jt0) load_dt(dts + (hh & 1) * Q, dtg + h0 + hh, H, i_end);
      };
      load_x(0);
      mma::cp_async_commit();
      float acc[2 * PT][4];
      double cum_i[2];
      for (int k = 0; k < n_tiles; ++k) {
        const int hh = k / njs, jt = jt0 + k - hh * njs, h = h0 + hh;
        const float* dth = dts + (hh & 1) * Q;
        if (k + 1 < n_tiles) load_x(k + 1);
        mma::cp_async_commit();
        mma::cp_async_wait<1>();
        __syncthreads();                    // tile k (and its head's dt) landed
        if (jt == jt0) {                    // a new head: its cum and y so far
          chunk_cum(dth, a.A[h], i_end, cum, wtot);
          // column factors exp(cum_r - cum_j) * dt_j, r the last column of
          // j's 16-column k-step
          for (int t = tid; t < i_end; t += MT)
            ws[t] = expf((float)(cum[min(t | 15, i_end - 1)] - cum[t])) * dth[t];
          __syncthreads();
#pragma unroll
          for (int r = 0; r < 2; ++r) cum_i[r] = cum[min(wrow + g + 8 * r, i_end - 1)];
#pragma unroll
          for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = wrow + g + 8 * (e >> 1), p = n * 8 + 2 * t4 + (e & 1);
              acc[n][e] = (jt0 > 0 && i < Q && p < P)
                              ? a.y[(((long long)b * a.S + s0 + i) * H + h) * P + p]
                              : 0.f;
            }
        }
        if (wact) {
          const __nv_bfloat16* Xt = Xs + (k & 1) * TQ * LX;
          const float* bt = band + (warp * 16 + g) * LB + (jt - jt0) * TQ + 2 * t4;
          const int kk_n = jt == it ? warp + 1 : 4;   // k-steps at or below the diagonal
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk >= kk_n) break;
            const int jb = jt * TQ + kk * 16 + 2 * t4;
            float mv[2][4];
            if (jt < it || kk < warp) {
              // wholly below the diagonal: exp(cum_i - cum_j) = exp(cum_i -
              // cum_r) * exp(cum_r - cum_j) with r = the k-step's last
              // column; both factors <= 1, both differences in f64
              const double cr = cum[jt * TQ + kk * 16 + 15];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int i = wrow + g + 8 * r;
                const float ri = expf((float)(cum_i[r] - cr));
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int o = (e & 1) + (e >> 1) * 8;
                  const float cbv = bt[8 * r * LB + kk * 16 + o];
                  mv[r][e] = i < Q ? cbv * ri * ws[jb + o] : 0.f;
                }
              }
            } else {
              // the warp's diagonal k-step: the pairwise decay directly
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = jb + (e & 1) + (e >> 1) * 8;
                const int jc = min(j, i_end - 1);
                const double cj = cum[jc];
                const float dj = dth[jc];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const int i = wrow + g + 8 * r;
                  const float cbv = bt[8 * r * LB + kk * 16 + (e & 1) + (e >> 1) * 8];
                  mv[r][e] = (j <= i && i < Q)
                                 ? cbv * expf((float)(cum_i[r] - cj)) * dj : 0.f;
                }
              }
            }
            uint32_t part[3][4];            // M as hi + mid + lo, A layout
#pragma unroll
            for (int q = 0; q < 4; ++q)
              mma::split3_bf16(mv[q & 1][(q >> 1) * 2], mv[q & 1][(q >> 1) * 2 + 1],
                               part[0][q], part[1][q], part[2][q]);
#pragma unroll
            for (int np = 0; np < PT; ++np) {
              uint32_t xf[4];
              mma::ldmatrix_x4_trans(xf, Xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LX +
                                             np * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int u = 0; u < 3; ++u) {
                mma::mma_bf16(acc[2 * np], part[u], xf[0], xf[1]);
                mma::mma_bf16(acc[2 * np + 1], part[u], xf[2], xf[3]);
              }
            }
          }
          if (jt == jt1 - 1) {              // the head's last tile of the slab
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = wrow + g + 8 * r;
              if (i >= Q) continue;
              float* yr = a.y + (((long long)b * a.S + s0 + i) * H + h) * P;
#pragma unroll
              for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int p = n * 8 + 2 * t4 + e;
                  if (p < P) yr[p] = acc[n][2 * r + e];
                }
            }
          }
        }
        __syncthreads();                    // buffer k & 1 is free
      }
      mma::cp_async_wait<0>();
    }
    return;
  }

  // ---- the state's columns nb .. nb+63, heads h0 .. h0+G-1; decays ----
  const int nb = role * NS;
  const int wn = warp * 16;                 // this warp's columns within the block
  const bool wact = nb + wn < n_pad;
  const int nqt = (Q + TQ - 1) / TQ;
  const int n_tiles = G * nqt;
  auto stage_x = [&](int k) {
    return reinterpret_cast<__nv_bfloat16*>(rest) + (k & 1) * TQ * (LX + LS);
  };
  auto load_st = [&](int k) {
    const int hh = k / nqt, jt = k - hh * nqt;
    __nv_bfloat16* xs = stage_x(k);
    mma::load_tile(xs, LX, xg + (long long)jt * TQ * a.sxs + (long long)(h0 + hh) * P,
                   a.sxs, TQ, Q - jt * TQ, P, PP, vx, tid, MT);
    // B's tile again for every head: all heads share B, the reads hit L2
    mma::load_tile(xs + TQ * LX, LS, Bg + (long long)jt * TQ * a.sbs + nb, a.sbs,
                   TQ, Q - jt * TQ, min(N - nb, NS), NS, vbc, tid, MT);
    if (jt == 0) load_dt(dts + (hh & 1) * Q, dtg + h0 + hh, H, Q);
  };
  load_st(0);
  mma::cp_async_commit();
  float acc[PT][2][4];
  for (int k = 0; k < n_tiles; ++k) {
    const int hh = k / nqt, jt = k - hh * nqt, h = h0 + hh;
    if (k + 1 < n_tiles) load_st(k + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();                        // tile k (and its head's dt) landed
    const long long bhc = ((long long)b * H + h) * a.nc + c;
    if (jt == 0) {                          // a new head: cum, w and the decays
      const float* dth = dts + (hh & 1) * Q;
      chunk_cum(dth, a.A[h], Q, cum, wtot);
      const double c_last = cum[Q - 1];
      for (int t = tid; t < Q; t += MT) {
        ws[t] = expf((float)(c_last - cum[t])) * dth[t];
        if (role == 0) a.dall[bhc * Q + t] = expf((float)cum[t]);
      }
      if (role == 0 && tid == 0) a.dch[bhc] = expf((float)c_last);
#pragma unroll
      for (int m = 0; m < PT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      __syncthreads();                      // ws is ready
    }
    if (wact) {
      const __nv_bfloat16* Xt = stage_x(k);
      const __nv_bfloat16* Bt = Xt + TQ * LX;
      const int kk_n = min(4, (Q - jt * TQ + 15) / 16);
      for (int kk = 0; kk < kk_n; ++kk) {
        const int jl = kk * 16, jg = jt * TQ + jl + 2 * t4;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jg + (e & 1) + (e >> 1) * 8;
          w[e] = j < Q ? ws[j] : 0.f;
        }
        uint32_t bf[4], part[3][4];         // w B as hi + mid + lo, B layout
        mma::ldmatrix_x4_trans(bf, Bt + (jl + (lane & 7) + ((lane >> 3) & 1) * 8) * LS +
                                       wn + (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {       // b0, b1 of two n-tiles: rows 2t, 2t+1 | 2t+8, 2t+9
          const float2 v = mma::unpack_bf16(bf[e]);
          const int wi = (e & 1) * 2;
          mma::split3_bf16(v.x * w[wi], v.y * w[wi + 1], part[0][e], part[1][e], part[2][e]);
        }
#pragma unroll
        for (int m = 0; m < PT; ++m) {
          uint32_t xf[4];
          mma::ldmatrix_x4_trans(xf, Xt + (jl + (lane & 7) + (lane >> 4) * 8) * LX +
                                         m * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            mma::mma_bf16(acc[m][0], xf, part[u][0], part[u][1]);
            mma::mma_bf16(acc[m][1], xf, part[u][2], part[u][3]);
          }
        }
      }
      if (jt == nqt - 1) {                  // the head's state is complete
        float* st = a.st + bhc * P * N;
#pragma unroll
        for (int m = 0; m < PT; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int p = m * 16 + g + (e >> 1) * 8;
              const int col = nb + wn + n * 8 + 2 * t4 + (e & 1);
              if (p < P && col < N) st[(long long)p * N + col] = acc[m][n][e];
            }
      }
    }
    __syncthreads();                        // buffer k & 1 is free
  }
  mma::cp_async_wait<0>();
}

// --------------------------------------------------- bf16, wgmma + TMA ---
//
// The wgmma route (see the top): one warpgroup a block.  A first kernel,
// ssd_chunk_prep_kernel, scans cum once per (b, c, h) and writes a record
// of the head's vectors (cum in f64; dt, the column factors exp(cum_r -
// cum_j) dt_j with r the last column of j's 16-column k-step, and w_j, in
// f32) and the decays.  Then ssd_chunk_wgmma_kernel<P>, per (b, c, group of
// heads), has two roles:
//  - y role, rows i0 .. i0+63 of the chunk: the band CB_IJ = C_I B_J^T for
//    J <= I by wgmma (both sides exact bf16 in shared memory, from TMA),
//    kept in shared memory as f32, each thread its own accumulator
//    entries; then per head and J tile, M = CB e dt is formed in the
//    registers in which the band's entries are the A operand of wgmma_rs,
//    split in three bf16 parts, and y += M x_J with x_J (TMA) read through
//    an MN-major descriptor.  Below the diagonal tile e comes as two
//    factors (as the mma.sync kernel forms it); on the diagonal a select.
//  - state role, 64 columns of N: B's columns for the whole chunk by TMA,
//    once; per head state = (w x)^T B, with x^T read from the x tiles by
//    ldmatrix.trans, scaled by w and split in three in the registers as
//    wgmma_rs's A operand, B through an MN-major descriptor.
// x tiles (and each head's record) stream through a ring of STAGES tiles
// filled by TMA, each completing on an mbarrier; thread 0 refills a stage
// once the block has passed the barrier after its products.  Each head's
// y tile or state slab (f32, the bytes that bound the kernel) goes through
// a staging tile in shared memory to a TMA store, which runs on under the
// next head's products.

namespace wg {

constexpr int T = 128;                        // one warpgroup a block
constexpr int STAGES = 2;                     // x tiles in flight
constexpr int PANEL = hopper::PANEL_BYTES;    // 64 rows x 64 bf16
constexpr int GMAX = 16;                      // most heads a block
constexpr int NS = 64;                        // state columns a block

// the record of one (b, c, h): cum (Q f64), dt, column factors, w (Q f32
// each); the y role loads its first 16 Q bytes, the state role w
__host__ __device__ inline size_t rec_bytes(int Q) { return (size_t)Q * 20; }

// Shared memory of ssd_chunk_wgmma_kernel<P> (offsets from a 1024-byte
// aligned base).  y role: the band (Q / 64 tiles of 64 x 64 f32), then
// C_I and B_J (panels of N), whose place the x ring and the staging tile
// take after the band; state role: B's slab for the chunk, then the x ring
// and the staging tile.  Both: the heads' records (a ring of STAGES) and
// the mbarriers.  The staging tile holds 64 x P (y) or P x 64 (state) f32
// in 128-byte-swizzled boxes of 32 floats a row.
struct Layout {
  int npn, nqt;           // panels of N, 64-row tiles of the chunk
  size_t reg, ring, stg, vec, bars, total;
  __host__ __device__ Layout(int Q, int n_pad, int P) {
    npn = (n_pad + 63) / 64;
    nqt = Q / 64;
    ring = (size_t)STAGES * (P / 64) * PANEL;
    stg = (size_t)P * 64 * 4;
    reg = (size_t)nqt * 64 * 64 * 4;
    const size_t cb = (size_t)2 * npn * PANEL;
    const size_t y = reg + (cb > ring + stg ? cb : ring + stg);
    const size_t st = (size_t)nqt * PANEL + ring + stg;
    vec = y > st ? y : st;
    bars = vec + (size_t)STAGES * 16 * Q;
    total = bars + (STAGES + 1) * 8 + 1024;
  }
};

// rec of (b, c, h): cum (f64), dt, wcol, w (f32), the decays.  One block
// of MT threads per (b, c, h), h fastest.
__global__ void __launch_bounds__(MT) ssd_chunk_prep_kernel(Args a) {
  __shared__ double cum[256];
  __shared__ double wtot[4];
  __shared__ float dts[256];
  const int Q = a.Q, H = a.H, tid = threadIdx.x;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % a.nc, b = bc / a.nc;
  const long long s0 = (long long)c * Q;
  for (int t = tid; t < Q; t += MT) dts[t] = a.dt[((long long)b * a.S + s0 + t) * H + h];
  __syncthreads();
  chunk_cum(dts, a.A[h], Q, cum, wtot);
  double* rc = reinterpret_cast<double*>(a.rec + (size_t)blockIdx.x * rec_bytes(Q));
  float* rdt = reinterpret_cast<float*>(rc + Q);
  float* rwc = rdt + Q;
  float* rws = rwc + Q;
  const double c_last = cum[Q - 1];
  const long long bhc = ((long long)b * H + h) * a.nc + c;
  for (int t = tid; t < Q; t += MT) {
    rc[t] = cum[t];
    rdt[t] = dts[t];
    rwc[t] = expf((float)(cum[t | 15] - cum[t])) * dts[t];
    rws[t] = expf((float)(c_last - cum[t])) * dts[t];
    a.dall[bhc * Q + t] = expf((float)cum[t]);
  }
  if (tid == 0) a.dch[bhc] = expf((float)c_last);
}

__device__ __forceinline__ const unsigned char* rec_of(const Args& a, int b, int c, int h) {
  return a.rec + (((size_t)b * a.nc + c) * a.H + h) * rec_bytes(a.Q);
}

// The f32 entry pair (row, col), (row, col + 1) of a staging tile of `rows`
// rows in 128-byte-swizzled boxes of 32 floats: its byte offset
__device__ __forceinline__ int stg_off(int row, int col, int rows) {
  const int cc = col & 31;
  return (col >> 5) * rows * 128 + hopper::sw128(row, cc >> 2) + (cc & 3) * 4;
}

// A head's output tile is in the staging tile once every thread has
// written its entries; thread 0 stores it by TMA.  Before the threads
// write, the last store must have read the staging tile.
__device__ __forceinline__ void stage_begin() {
  if (threadIdx.x == 0) hopper::bulk_wait_read();
  __syncthreads();
}
__device__ __forceinline__ void stage_end() {
  hopper::fence_proxy_async();
  __syncthreads();
}

// y role: rows it * 64 .. +63 of chunk c, heads h0 .. h0+G-1
template <int P>
__device__ __forceinline__ void y_role(const Args& a, const CUtensorMap* xm, const CUtensorMap* bm,
                                       const CUtensorMap* cm, const CUtensorMap* ym,
                                       unsigned char* smem, int b, int c, int h0, int G, int it) {
  constexpr int NP = P / 64, XT = NP * PANEL;
  const int Q = a.Q;
  const Layout L(Q, a.n_pad, P);
  float* band = reinterpret_cast<float*>(smem);
  unsigned char* Cs = smem + L.reg;
  unsigned char* Bs = Cs + L.npn * PANEL;
  unsigned char* Xs = smem + L.reg;             // after the band
  unsigned char* Ys = Xs + L.ring;              // the staging tile
  unsigned char* vec = smem + L.vec;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* cbar = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = c * Q, i0 = it * 64;
  const size_t VY = (size_t)16 * Q;

  // ---- the band CB_IJ, J = 0 .. it; B_J single-buffered behind C_I
  if (tid == 0) {
    hopper::mbar_expect_tx(cbar, 2 * L.npn * PANEL);
    for (int p = 0; p < L.npn; ++p) {
      hopper::tma_load_3d(Cs + p * PANEL, cm, cbar, 64 * p, s0 + i0, b);
      hopper::tma_load_3d(Bs + p * PANEL, bm, cbar, 64 * p, s0, b);
    }
  }
  for (int jt = 0; jt <= it; ++jt) {
    hopper::mbar_wait(cbar, jt & 1);
    float cb[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) cb[e] = 0.f;
    hopper::fence_regs(cb);
    hopper::wgmma_fence();
    for (int p = 0; p < L.npn; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss<64, 0>(cb, hopper::desc_kmajor(Cs, 4 * p + kk),
                                hopper::desc_kmajor(Bs, 4 * p + kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(cb);
#pragma unroll
    for (int e = 0; e < 32; ++e) band[(jt * 32 + e) * T + tid] = cb[e];
    __syncthreads();                            // B_J is read
    if (tid == 0 && jt < it) {
      hopper::mbar_expect_tx(cbar, L.npn * PANEL);
      for (int p = 0; p < L.npn; ++p)
        hopper::tma_load_3d(Bs + p * PANEL, bm, cbar, 64 * p, s0 + (jt + 1) * 64, b);
    }
  }

  // ---- y_h += M_h x_h over J = 0 .. it, the (head, J) tiles streamed
  const int ntj = it + 1, n_t = G * ntj;
  auto issue = [&](int t) {
    const int hh = t / ntj, jt = t - hh * ntj, s = t % STAGES;
    hopper::mbar_expect_tx(&full[s], XT + (jt == 0 ? (uint32_t)VY : 0u));
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_4d(Xs + s * XT + p * PANEL, xm, &full[s], 64 * p, h0 + hh, s0 + jt * 64, b);
    if (jt == 0)
      hopper::bulk_load(vec + (hh % STAGES) * VY, rec_of(a, b, c, h0 + hh), (uint32_t)VY, &full[s]);
  };
  if (tid == 0)
    for (int t = 0; t < n_t && t < STAGES; ++t) issue(t);

  const int rl = 16 * warp + g, rw = i0 + rl;   // this thread's rows rw, rw + 8
  float y[P / 2];
  double ci[2] = {0.0, 0.0};
  for (int t = 0; t < n_t; ++t) {
    const int hh = t / ntj, jt = t - hh * ntj, s = t % STAGES;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    const double* cum = reinterpret_cast<const double*>(vec + (hh % STAGES) * VY);
    const float* dtv = reinterpret_cast<const float*>(cum + Q);
    const float* wcol = dtv + Q;
    if (jt == 0) {
#pragma unroll
      for (int e = 0; e < P / 2; ++e) y[e] = 0.f;
      ci[0] = cum[rw];
      ci[1] = cum[rw + 8];
    }
    const unsigned char* Xt = Xs + s * XT;
    const float* bt = band + jt * 32 * T + tid;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int jb = jt * 64 + kk * 16;         // the k-step's first column
      float mv[8];
      if (jt < it || kk < warp) {
        // wholly below the diagonal: exp(cum_i - cum_j) = exp(cum_i - cum_r)
        // exp(cum_r - cum_j), r the k-step's last column; both <= 1
        const double cr = cum[jb + 15];
        const float ri[2] = {expf((float)(ci[0] - cr)), expf((float)(ci[1] - cr))};
#pragma unroll
        for (int q = 0; q < 8; ++q)
          mv[q] = bt[(8 * kk + q) * T] * ri[(q >> 1) & 1] * wcol[jb + 8 * (q >> 2) + 2 * t4 + (q & 1)];
      } else if (kk == warp) {
        // the warp's diagonal 16 x 16: the pairwise decay, a select above
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = jb + 8 * (q >> 2) + 2 * t4 + (q & 1), i = rw + 8 * ((q >> 1) & 1);
          const float ex = bt[(8 * kk + q) * T] * expf((float)(ci[(q >> 1) & 1] - cum[j])) * dtv[j];
          mv[q] = j <= i ? ex : 0.f;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) mv[q] = 0.f;
      }
      uint32_t pa[3][4];                        // M as hi + mid + lo, A layout
#pragma unroll
      for (int f = 0; f < 4; ++f) mma::split3_bf16(mv[2 * f], mv[2 * f + 1], pa[0][f], pa[1][f], pa[2][f]);
#pragma unroll
      for (int u = 0; u < 3; ++u) hopper::fence_regs(pa[u]);
      hopper::fence_regs(y);
      hopper::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 3; ++u) hopper::wgmma_rs<P, 1>(y, pa[u], hopper::desc_mnmajor(Xt, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(y);
    if (jt == it) {                             // the head's y tile, by TMA
      stage_begin();
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(Ys + stg_off(rl + 8 * r, 8 * n + 2 * t4, 64)) =
              make_float2(y[4 * n + 2 * r], y[4 * n + 2 * r + 1]);
      stage_end();
      if (tid == 0) {
        for (int q = 0; q < P / 32; ++q)
          hopper::tma_store_4d(ym, Ys + q * 64 * 128, 32 * q, h0 + hh, s0 + i0, b);
        hopper::bulk_commit();
      }
    }
    __syncthreads();                            // stage s and the record slot are read
    if (tid == 0 && t + STAGES < n_t) issue(t + STAGES);
  }
}

// state role: columns nb .. nb + 63 of the states of chunk c, heads h0 ..
// h0+G-1
template <int P>
__device__ __forceinline__ void state_role(const Args& a, const CUtensorMap* xm,
                                           const CUtensorMap* bm, const CUtensorMap* sm,
                                           unsigned char* smem, int b, int c, int h0, int G,
                                           int nb) {
  constexpr int NP = P / 64, XT = NP * PANEL;
  const int Q = a.Q, H = a.H;
  const Layout L(Q, a.n_pad, P);
  const int nqt = L.nqt;
  unsigned char* Bs = smem;                     // nqt panels
  unsigned char* Xs = smem + (size_t)nqt * PANEL;
  unsigned char* Ss = Xs + L.ring;              // the staging tile
  unsigned char* vec = smem + L.vec;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* bbar = full + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = c * Q;
  const size_t VY = (size_t)16 * Q, VS = (size_t)4 * Q;

  const int n_t = G * nqt;
  auto issue = [&](int t) {
    const int hh = t / nqt, jt = t - hh * nqt, s = t % STAGES;
    hopper::mbar_expect_tx(&full[s], XT + (jt == 0 ? (uint32_t)VS : 0u));
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_4d(Xs + s * XT + p * PANEL, xm, &full[s], 64 * p, h0 + hh, s0 + jt * 64, b);
    if (jt == 0)
      hopper::bulk_load(vec + (hh % STAGES) * VY, rec_of(a, b, c, h0 + hh) + VY, (uint32_t)VS,
                        &full[s]);
  };
  if (tid == 0) {
    hopper::mbar_expect_tx(bbar, nqt * PANEL);
    for (int jt = 0; jt < nqt; ++jt)
      hopper::tma_load_3d(Bs + jt * PANEL, bm, bbar, nb, s0 + jt * 64, b);
    for (int t = 0; t < n_t && t < STAGES; ++t) issue(t);
  }
  hopper::mbar_wait(bbar, 0);

  float acc[NP][NS / 2];
  for (int t = 0; t < n_t; ++t) {
    const int hh = t / nqt, jt = t - hh * nqt, s = t % STAGES;
    hopper::mbar_wait(&full[s], (t / STAGES) & 1);
    const float* ws = reinterpret_cast<const float*>(vec + (hh % STAGES) * VY);
    if (jt == 0) {
#pragma unroll
      for (int m = 0; m < NP; ++m)
#pragma unroll
        for (int e = 0; e < NS / 2; ++e) acc[m][e] = 0.f;
    }
    const unsigned char* Xt = Xs + s * XT;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int jb = jt * 64 + kk * 16 + 2 * t4;
      const float w[4] = {ws[jb], ws[jb + 1], ws[jb + 8], ws[jb + 9]};
      // lane l addresses row kk * 16 + (l & 7) + 8 (l >> 4) of the tile and
      // the 8 columns from 16 warp + 8 ((l >> 3) & 1) of its panel
      const int R = kk * 16 + (lane & 7) + 8 * (lane >> 4);
      const int ch = 2 * warp + ((lane >> 3) & 1);
      uint32_t pa[NP][3][4];                    // (w x)^T as hi + mid + lo, A layout
#pragma unroll
      for (int m = 0; m < NP; ++m) {
        uint32_t xf[4];
        mma::ldmatrix_x4_trans(xf, Xt + m * PANEL + hopper::sw128(R, ch));
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float2 v = mma::unpack_bf16(xf[f]);
          const int wi = (f >> 1) * 2;
          mma::split3_bf16(v.x * w[wi], v.y * w[wi + 1], pa[m][0][f], pa[m][1][f], pa[m][2][f]);
        }
      }
#pragma unroll
      for (int m = 0; m < NP; ++m) {
#pragma unroll
        for (int u = 0; u < 3; ++u) hopper::fence_regs(pa[m][u]);
        hopper::fence_regs(acc[m]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int m = 0; m < NP; ++m)
#pragma unroll
        for (int u = 0; u < 3; ++u)
          hopper::wgmma_rs<NS, 1>(acc[m], pa[m][u], hopper::desc_mnmajor(Bs + jt * PANEL, kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < NP; ++m) hopper::fence_regs(acc[m]);
    if (jt == nqt - 1) {                        // the head's state slab, by TMA
      stage_begin();
#pragma unroll
      for (int m = 0; m < NP; ++m)
#pragma unroll
        for (int n = 0; n < NS / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(Ss + stg_off(64 * m + 16 * warp + g + 8 * r,
                                                    8 * n + 2 * t4, P)) =
                make_float2(acc[m][4 * n + 2 * r], acc[m][4 * n + 2 * r + 1]);
      stage_end();
      if (tid == 0) {
        const int bhc = (int)(((long long)b * H + h0 + hh) * a.nc + c);
        for (int q = 0; q < 2; ++q) hopper::tma_store_3d(sm, Ss + q * P * 128, nb + 32 * q, 0, bhc);
        hopper::bulk_commit();
      }
    }
    __syncthreads();                            // stage s and the record slot are read
    if (tid == 0 && t + STAGES < n_t) issue(t + STAGES);
  }
}

// The state slabs first, then the y tiles from the last (most J tiles) down
template <int P>
__global__ void __launch_bounds__(T, 1)
ssd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap b_map,
                       const __grid_constant__ CUtensorMap c_map,
                       const __grid_constant__ CUtensorMap y_map,
                       const __grid_constant__ CUtensorMap st_map, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = hopper::align1024(smem_wg);
  const Layout L(a.Q, a.n_pad, P);
  const int n_roles = a.n_st + a.n_it;
  int bid = blockIdx.x;
  const int role = bid % n_roles;
  bid /= n_roles;
  const int grp = bid % a.n_grp;
  bid /= a.n_grp;
  const int c = bid % a.nc, b = bid / a.nc;
  const int h0 = grp * a.G, G = min(a.G, a.H - h0);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
    for (int s = 0; s <= STAGES; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (role < a.n_st)
    state_role<P>(a, &x_map, &b_map, &st_map, smem, b, c, h0, G, role * NS);
  else
    y_role<P>(a, &x_map, &b_map, &c_map, &y_map, smem, b, c, h0, G,
              a.n_it - 1 - (role - a.n_st));
  if (threadIdx.x == 0) hopper::bulk_wait();    // the last stores are done
}

}  // namespace wg

// ---------------------------------------------------------------- f32 ---

// PC = ceil(P / 16): columns of y (rows of the state) per thread.
template <int PC>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(Args a) {
  const int Q = a.Q, N = a.N, P = a.P;
  const int LN = N + 1, LX = P + 1;
  extern __shared__ double smem[];
  double* cum = smem;               // Q
  float* dts = reinterpret_cast<float*>(cum + Q);   // Q
  float* Cs = dts + Q;              // TQ x LN: C rows i of the tile
  float* Bs = Cs + TQ * LN;         // TQ x LN: B rows j (state: weighted B)
  float* Xs = Bs + TQ * LN;         // TQ x LX: x rows j
  float* Ms = Xs + TQ * LX;         // TQ x LM: M = (C B^T) * L * dt

  int bid = blockIdx.x;
  const int tile = bid % (a.n_it + 1);
  bid /= a.n_it + 1;
  const int h = bid % a.H;
  bid /= a.H;
  const int c = bid % a.nc;
  const int b = bid / a.nc;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const long long s0 = (long long)c * Q;    // first position of the chunk

  const float* xg = static_cast<const float*>(a.x) + b * a.sxb + s0 * a.sxs + (long long)h * P;
  const float* Bg = static_cast<const float*>(a.Bm) + b * a.sbb + s0 * a.sbs;
  const float* Cg = static_cast<const float*>(a.Cm) + b * a.scb + s0 * a.scs;
  const float* dtg = a.dt + ((long long)b * a.S + s0) * a.H + h;
  const float Ah = a.A[h];

  for (int t = tid; t < Q; t += THREADS) dts[t] = dtg[(long long)t * a.H];
  __syncthreads();
  if (tid < 32) {                   // cum = inclusive prefix of dt * A
    const int per = (Q + 31) / 32;
    const int lo = min(tid * per, Q), hi = min(lo + per, Q);
    double run = 0.0;
    for (int t = lo; t < hi; ++t) {
      run += (double)(dts[t] * Ah);   // the log-decay itself rounds in f32
      cum[t] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    double before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) before = 0.0;
    for (int t = lo; t < hi; ++t) cum[t] += before;
  }
  __syncthreads();

  if (tile < a.n_it) {
    // ---- y_intra for rows i0 .. i0+63 of the chunk ----
    const int i0 = tile * TQ;
    const int i_end = min(i0 + TQ, Q);      // rows past the chunk are not stored
    for (int e = tid; e < TQ * N; e += THREADS) {
      const int r = e / N, n = e - r * N, i = i0 + r;
      Cs[r * LN + n] = i < Q ? Cg[(long long)i * a.scs + n] : 0.f;
    }
    float acc[4][PC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;

    for (int j0 = 0; j0 < i_end; j0 += TQ) {
      __syncthreads();              // the previous tile's Bs/Xs/Ms are read
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int r = e / N, n = e - r * N, j = j0 + r;
        Bs[r * LN + n] = j < Q ? Bg[(long long)j * a.sbs + n] : 0.f;
      }
      for (int e = tid; e < TQ * P; e += THREADS) {
        const int r = e / P, p = e - r * P, j = j0 + r;
        Xs[r * LX + p] = j < Q ? xg[(long long)j * a.sxs + p] : 0.f;
      }
      __syncthreads();

      // C_i . B_j for rows tr*4 + r and columns tc + 16k of the tile
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) s[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(tr * 4 + r) * LN + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = Bs[(tc + 16 * k) * LN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) s[r][k] = fmaf(cv[r], bv[k], s[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + tr * 4 + r;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tc + 16 * k;
          Ms[(tr * 4 + r) * LM + tc + 16 * k] =
              (i < Q && j <= i) ? s[r][k] * expf((float)(cum[i] - cum[j])) * dts[j]
                                : 0.f;
        }
      }
      __syncthreads();

      // acc += M . x_j over the rows j this tile can see
      const int kk_end = min(TQ, i_end - j0);
      for (int kk = 0; kk < kk_end; ++kk) {
        float m[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) m[r] = Ms[(tr * 4 + r) * LM + kk];
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          const int p = tc + 16 * q;
          xv[q] = p < P ? Xs[kk * LX + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < PC; ++q) acc[r][q] = fmaf(m[r], xv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + tr * 4 + r;
      if (i >= Q) continue;
      float* yr = a.y + (((long long)b * a.S + s0 + i) * a.H + h) * P;
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        const int p = tc + 16 * q;
        if (p < P) yr[p] = acc[r][q];
      }
    }
    return;
  }

  // ---- the chunk's state and decays ----
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  for (int t = tid; t < Q; t += THREADS) a.dall[bhc * Q + t] = expf((float)cum[t]);
  if (tid == 0) a.dch[bhc] = expf((float)cum[Q - 1]);
  const double c_last = cum[Q - 1];
  float* st = a.st + bhc * P * N;
  for (int n0 = 0; n0 < N; n0 += NSLAB) {
    const int ns = min(NSLAB, N - n0);
    float acc[PC][8];
#pragma unroll
    for (int q = 0; q < PC; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[q][k] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += TQ) {
      __syncthreads();              // the previous tile's Bs/Xs are read
      for (int e = tid; e < TQ * ns; e += THREADS) {
        const int r = e / ns, n = e - r * ns, j = j0 + r;
        Bs[r * LN + n] = j < Q ? Bg[(long long)j * a.sbs + n0 + n] *
                                     (expf((float)(c_last - cum[j])) * dts[j])
                               : 0.f;
      }
      for (int e = tid; e < TQ * P; e += THREADS) {
        const int r = e / P, p = e - r * P, j = j0 + r;
        Xs[r * LX + p] = j < Q ? xg[(long long)j * a.sxs + p] : 0.f;
      }
      __syncthreads();
      const int kk_end = min(TQ, Q - j0);
      for (int kk = 0; kk < kk_end; ++kk) {
        float xv[PC], wv[8];
#pragma unroll
        for (int q = 0; q < PC; ++q) {
          const int p = tr + 16 * q;
          xv[q] = p < P ? Xs[kk * LX + p] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = tc + 16 * k;
          wv[k] = n < ns ? Bs[kk * LN + n] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < PC; ++q)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[q][k] = fmaf(xv[q], wv[k], acc[q][k]);
      }
    }
#pragma unroll
    for (int q = 0; q < PC; ++q) {
      const int p = tr + 16 * q;
      if (p >= P) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tc + 16 * k;
        if (n < ns) st[(long long)p * N + n0 + n] = acc[q][k];
      }
    }
  }
}

template <int PC>
cudaError_t launch_f32(const Args& a, int Bsz, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Q, a.P, a.N);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_kernel<PC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)(a.n_it + 1) * a.H * a.nc * Bsz;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_bf16(Args a, int Bsz, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(a.Q, a.n_it, a.n_pad, PT * 16 + mma::PAD);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = ssd_chunk_mma_kernel<PT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // heads per block: the most (up to GMAX) that still gives 8 blocks per SM
  const int roles = a.n_st + a.n_it;
  auto blocks_for = [&](int G) {
    return (long long)roles * ((a.H + G - 1) / G) * a.nc * Bsz;
  };
  a.G = std::min(GMAX, a.H);
  while (a.G > 1 && blocks_for(a.G) < 8LL * sms) a.G = (a.G + 1) / 2;
  a.n_grp = (a.H + a.G - 1) / a.G;
  const long long blocks = blocks_for(a.G);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, MT, smem, stream>>>(a);
  return cudaGetLastError();
}

// the wgmma route at head dim P: TMA maps of x, B and C, the records,
// then the products
template <int P>
cudaError_t launch_wgmma(Args a, int Bsz, cudaStream_t stream) {
  const wg::Layout L(a.Q, a.n_pad, P);
  if (L.total > 232448) return cudaErrorInvalidValue;
  CUtensorMap xm, bm, cm, ym, sm;
  // y (B, S, H, P) and the states (B, H, nc, P, N), f32, as boxes of 32
  // columns, 128-byte swizzled
  const cuuint64_t y_dims[4] = {(cuuint64_t)P, (cuuint64_t)a.H, (cuuint64_t)a.S,
                                (cuuint64_t)Bsz};
  const cuuint64_t y_strides[3] = {(cuuint64_t)P * 4, (cuuint64_t)a.H * P * 4,
                                   (cuuint64_t)a.S * a.H * P * 4};
  const cuuint32_t y_box[4] = {32, 1, 64, 1};
  const cuuint64_t s_dims[3] = {(cuuint64_t)a.N, (cuuint64_t)P,
                                (cuuint64_t)Bsz * a.H * a.nc};
  const cuuint64_t s_strides[2] = {(cuuint64_t)a.N * 4, (cuuint64_t)P * a.N * 4};
  const cuuint32_t s_box[3] = {32, (cuuint32_t)P, 1};
  if (hopper::strided_bshd_map(&xm, a.x, Bsz, a.S, a.H, P, a.sxb, a.sxs) != CUDA_SUCCESS ||
      hopper::bsn_map(&bm, a.Bm, Bsz, a.S, a.N, a.sbb, a.sbs) != CUDA_SUCCESS ||
      hopper::bsn_map(&cm, a.Cm, Bsz, a.S, a.N, a.scb, a.scs) != CUDA_SUCCESS ||
      hopper::f32_map(&ym, a.y, 4, y_dims, y_strides, y_box, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS ||
      hopper::f32_map(&sm, a.st, 3, s_dims, s_strides, s_box, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = wg::ssd_chunk_wgmma_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const long long heads = (long long)Bsz * a.nc * a.H;
  if (heads > 0x7fffffffLL) return cudaErrorInvalidValue;
  wg::ssd_chunk_prep_kernel<<<(unsigned)heads, MT, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // heads per block: the most (up to GMAX) that still gives 8 blocks per SM
  // (4 ran 8% slower at mamba2's shape on an H100 80GB HBM3 at 700 W:
  // tools/kernel_variants.py)
  a.n_st = (a.N + wg::NS - 1) / wg::NS;
  const int roles = a.n_st + a.n_it;
  auto blocks_for = [&](int G) {
    return (long long)roles * ((a.H + G - 1) / G) * a.nc * Bsz;
  };
  a.G = std::min(wg::GMAX, a.H);
  while (a.G > 1 && blocks_for(a.G) < 8LL * sms) a.G = (a.G + 1) / 2;
  a.n_grp = (a.H + a.G - 1) / a.G;
  const long long blocks = blocks_for(a.G);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, wg::T, L.total, stream>>>(xm, bm, cm, ym, sm, a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The wgmma route takes bf16 at P = 64 or 128, N a multiple of 16 up to
// 256, Q a multiple of 64 up to 256, with x, B and C as TMA reads them
// (16-byte aligned bases, strides multiples of 8 elements); the wrapper
// (kernels/ssd.py::ssd_route) chooses it by the same rule.
bool wgmma_shape(const Args& a, bool bf16) {
  return bf16 && (a.P == 64 || a.P == 128) && a.N % 16 == 0 && a.N <= 256 &&
         a.Q % 64 == 0 && a.Q <= 256 && aligned16(a.x) && aligned16(a.Bm) &&
         aligned16(a.Cm) && a.sxb % 8 == 0 && a.sxs % 8 == 0 && a.sbb % 8 == 0 &&
         a.sbs % 8 == 0 && a.scb % 8 == 0 && a.scs % 8 == 0;
}

cudaError_t dispatch_p(Args a, int Bsz, bool bf16, int route, cudaStream_t stream) {
  a.n_pad = (a.N + 15) / 16 * 16;
  if (route == 1) {
    if (!wgmma_shape(a, bf16) || a.rec == nullptr) return cudaErrorInvalidValue;
    return a.P == 64 ? launch_wgmma<64>(a, Bsz, stream) : launch_wgmma<128>(a, Bsz, stream);
  }
  const int pc = (a.P + 15) / 16;
  if (!bf16) {
    switch (pc) {
      case 1: return launch_f32<1>(a, Bsz, stream);
      case 2: return launch_f32<2>(a, Bsz, stream);
      case 3:
      case 4: return launch_f32<4>(a, Bsz, stream);
      case 5: case 6: case 7:
      case 8: return launch_f32<8>(a, Bsz, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  a.n_st = (a.n_pad + NS - 1) / NS;
  a.vx = aligned16(a.x) && a.P % 8 == 0 && a.sxb % 8 == 0 && a.sxs % 8 == 0;
  a.vbc = aligned16(a.Bm) && aligned16(a.Cm) && a.N % 8 == 0 &&
          a.sbb % 8 == 0 && a.sbs % 8 == 0 && a.scb % 8 == 0 && a.scs % 8 == 0;
  switch (pc) {
    case 1: return launch_bf16<1>(a, Bsz, stream);
    case 2: return launch_bf16<2>(a, Bsz, stream);
    case 3:
    case 4: return launch_bf16<4>(a, Bsz, stream);
    case 5: case 6: case 7:
    case 8: return launch_bf16<8>(a, Bsz, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of workspace the wgmma route needs (the heads' records); 0 for the
// other routes.
extern "C" long long ssd_chunk_workspace(int Bsz, int S, int H, int Q, int route) {
  return route == 1 && Q > 0 ? (long long)Bsz * S * H * 20 : 0;
}

// C entry bound with ctypes.  dtype of x, B and C: 0 = float32 (CUDA-core
// kernel), 1 = bfloat16 (tensor-core kernels); route (bf16 only): 0 =
// mma.sync, 1 = wgmma + TMA, which `work` (ssd_chunk_workspace bytes)
// serves.  Strides are in elements.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (cudaErrorInvalidValue for
// shapes it does not take, before any launch).
extern "C" int ssd_chunk(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* st,
                         void* dall, void* dch, void* work, int Bsz, int S, int H,
                         int P, int N, int Q, int dtype, int route, long long sxb,
                         long long sxs, long long sbb, long long sbs, long long scb,
                         long long scs, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 128 || N <= 0 || Q <= 0 ||
      S % Q != 0 || (dtype != 0 && dtype != 1) || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
         static_cast<float*>(y), static_cast<float*>(st),
         static_cast<float*>(dall), static_cast<float*>(dch),
         S, H, P, N, Q, S / Q, (Q + TQ - 1) / TQ,
         sxb, sxs, sbb, sbs, scb, scs, 0, 0, 0, 0, 0, 0,
         static_cast<unsigned char*>(work)};
  return (int)dispatch_p(a, Bsz, dtype == 1, route, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
