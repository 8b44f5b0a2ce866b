// Mamba2 SSD intra-chunk terms, backward (K2b), for Hopper (sm_90a).
//
// The VJP of K2 (csrc/ssd_chunk.cu) with respect to x, dt, A, B and C.  The
// reference writes this backward only in jnp: the custom VJP
// src/repro/kernels/ops.py::_ssd_bwd, which differentiates
// ssd_reference.  Per (batch b, chunk c, head h) of length Q, with
// cum = inclusive cumsum(dt * A) over the chunk (summed in f64, as K2 sums
// it), e_ij = exp(cum_i - cum_j) for j <= i only, CB_ij = C_i . B_j,
// M_ij = CB_ij e_ij dt_j and w_j = exp(cum_{Q-1} - cum_j) dt_j, the forward
// is y = M x, state = sum_j w_j x_j (outer) B_j, decay_all = exp(cum),
// decay_chunk = exp(cum_{Q-1}).  From the cotangents dy, dS (the state's),
// ddall and ddch:
//   G_ij = dy_i . x_j (j <= i)           dx_j = sum_i M_ij dy_i + w_j dS B_j
//   dCB_ij = G_ij e_ij dt_j              dC_i = sum_h sum_j dCB_ij B_j
//   dB_j = sum_h (sum_i dCB_ij C_i + w_j dS^T x_j)
//   dw_j = x_j . dS B_j                  ddt_j = sum_i G_ij CB_ij e_ij
//                                              + dw_j exp(cum_{Q-1} - cum_j)
//                                              + A dla_j
//   dcum_i = sum_j G_ij M_ij - sum_k G_ki M_ki - dw_i w_i + ddall_i exp(cum_i)
//            (+ sum_j dw_j w_j + ddch exp(cum_{Q-1}) at i = Q-1)
//   dla_u = sum_{i >= u} dcum_i,  dA = sum_{b, c, u} dt_u dla_u.
// Like K2, it forms exp(cum_i - cum_j) only where j <= i, so it cannot
// overflow (above the diagonal that exp passes f32's range once a chunk's
// decay passes ~88, and the reference's VJP then gives NaN for dt and A).
//
// Three routes, chosen by the input type and, for bf16, by shape and layout
// alone (`route`, from kernels/ssd.py::ssd_route, K2's rule; the library
// checks it, wgmma_shape, and refuses a route the inputs do not fit); none
// falls back to another.  bf16 at P = 64 or 128, N a multiple of 16 up to
// 256, Q a multiple of 64 up to 256, x, B and C 16-byte aligned with
// strides of 8 elements: kernels 1 and 2 on wgmma fed by TMA (below, "bf16,
// wgmma + TMA"); every other bf16 shape: the mma.sync kernels; f32: the
// CUDA cores.  Each route launches its kernels in order on one stream from
// one call and uses no atomics, so the result is the same bit for bit from
// run to run.  All take their scratch from one workspace the caller
// allocates (ssd_chunk_bwd_workspace gives its size).
//
// bf16, on the tensor cores (the mma.sync route: m16n8k16, bf16 in, f32
// accumulate; the wgmma route the same arithmetic, its products on wgmma).
// x, B and C are exact in bf16; every f32 operand (dy, dS, M, dCB) is split
// into three bf16 parts, hi + mid + lo (about 2^-27 relative, as K2 splits
// its M), so each product keeps f32 accuracy: one product where both sides
// are exact (C B^T), three where one side is split, and for M^T dy, which
// feeds only dx (rounded to bf16), the three leading cross terms of the two
// splits, hi hi + hi mid + mid hi (about 2^-17).  Five kernels:
//  0. ssd_bwd_cb_mma_kernel, a block per (b, c) and 64 x 64 tile pair
//     (J, I), I >= J: CB^T_JI = B_J C_I^T, shared by every head, into a
//     scratch (B, nc, Q, Q) laid out [j][i].
//  1. ssd_bwd_chunk_mma_kernel, a block per (b, c, h), 4 warps, each warp
//     16 rows j of a 64-row tile J: cum by a block-wide scan in f64; per
//     tile J, U_J = B_J dS^T (dS split, 64 columns at a time), dw_J = x_J .
//     U_J and dx_J = w_J U_J; then per tile I >= J, dy_I split into shared
//     memory (the next dy tile arriving by cp.async meanwhile), G^T_JI =
//     x_J dy_I^T, M^T = CB^T e dt (CB^T read from L2; e by one exp on the
//     diagonal tile and a product of a row and a column factor below it)
//     and the f64 row and column sums of G o M and G o CB o e (over the
//     same f32 values for both); M^T, split, times dy_I adds to dx_J in
//     registers.  dx_J is written once, rounded to bf16.  Then dcum, its
//     reverse cumsum (a block-wide f64 scan), ddt and this (b, c, h)'s share
//     of dA; cum and w go to a scratch (B, H, S) for kernel 2.
//  2. ssd_bwd_heads_kernel, 8 warps, a block per (b, c), group of heads
//     (HG of them) and either a tile pair (J, I), I >= J: dCB^T_JI = sum_h
//     G^T e dt over the group's heads in order, into a scratch per group;
//     or a tile J and 64 columns of N: dB's share from the chunk state,
//     sum_h w_J (x_J dS), the same way.  The tiles of the next two heads
//     arrive by cp.async while one is multiplied.  G is formed a second
//     time here: that keeps the sum over heads out of kernel 1, whose
//     blocks are per head.
//  3. ssd_bwd_bc_mma_kernel, a block per (b, c), 64-row tile and 64
//     columns of N: dC = dCB B, or dB = the chunk state's share + dCB^T C,
//     dCB and the share summed over the head groups in order (dCB split).
//  4. ssd_bwd_reduce_kernel: dA summed over batch and chunks (f64).
// Scratch: CB^T (B, nc, Q, Q); per head group dCB^T (B, nc, Q, Q) and the
// chunk state's share of dB (B, S, N); cum (f64) and w (B, H, S); dA's
// shares (B, nc, H) f64: about 40 MB at the mamba2 shape.
//
// f32: six kernels, products in f32 FMA on the CUDA cores, as the f32
// tolerance needs:
//  0. ssd_bwd_cb_kernel, a block per (b, c) and 32 x 32 tile (I, J) with
//     I >= J: CB, which all heads share, once, into a scratch (B, nc, Q, Q).
//  1. ssd_bwd_state_kernel, a block per (b, c, h): the chunk state's share.
//     dS (P x N) is staged in shared memory once; per 32-row tile j of the
//     chunk U = B_j dS^T and V = x_j dS, then dx's share w_j U_j (f32, to
//     a scratch), dw_j = x_j . U_j, and the head's share of dB, w_j V_j,
//     into a partial per head.
//  2. ssd_bwd_chunk_kernel, a block per (b, c, h): the pairs within the
//     chunk, in 32 x 32 tiles (J, I) with I >= J, J in the outer loop.  Per
//     tile pair it reads CB and forms G, then M, the two products whose row
//     and column sums feed dcum and ddt, and dCB, which it writes to a
//     scratch per head (B, nc, H, Q, Q); M^T dy accumulates over I in
//     registers, and dx_J, that sum plus kernel 1's share, is written
//     once, rounded to x's type.  At the end one thread runs the chunk's
//     dcum and its reverse cumsum in f64 and writes this (b, c, h)'s share
//     of dA; then the block writes ddt.
//  3. ssd_bwd_head_sum_kernel: dCB summed over heads, in order.
//  4. ssd_bwd_bc_kernel, a block per (b, c) and 32-row tile: dC = dCB B,
//     and dB's share dCB^T C, each product once for all heads.
//  5. ssd_bwd_reduce_kernel: dB gains the chunk state's share summed over
//     heads; dA summed over batch and chunks (f64); each in a fixed order.
//
// Both paths sum dx in f32 and round it once to x's type as they write it.
//
// Layout.  x (B,S,H,P) is read in place through its batch and sequence
// strides (heads packed at stride P, elements at stride 1), and B, C (B,S,N)
// through theirs, as K2 reads the split views of the model's xBC.  dt
// (B,S,H), A (H,) and the cotangents dy (B,S,H,P), dS (B,H,nc,P,N), ddall
// (B,H,nc,Q), ddch (B,H,nc) are contiguous f32.  Outputs: dx (B,S,H,P) in
// x's type; ddt (B,S,H), dA (H,), dB, dC (B,S,N) f32.  The f32 path's
// scratch, f32 but for dA_part: dxs (B,S,H,P), dB_part (H,B,S,N), dcb
// (B,nc,H,Q,Q), dA_part (B,nc,H) f64, dw (B,H,S), cb and dcbs (B,nc,Q,Q).
//
// Bound on this card.  At mamba2-1.3b's training shape (B=8, S=1024, H=64,
// P=64, N=128, Q=256, bf16 in) the function needs about 35 GFLOP (CB and
// dCB's two products once per (b, c), summed over heads) against about
// 0.35 GB moved: bound by bytes, about 0.11 ms.  The bf16 path runs about
// 150 GFLOP of products (the splits, and G twice); on the wgmma route its
// two main kernels are bound by their elementwise work and latency (kernel
// 1: the f64 sums, dy's split, one warpgroup a block at 224 registers) and
// by L2 traffic (kernel 2), not by the products (PERF.md).  Fusing the
// recurrence between chunks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_helpers.cuh"
#include "mma_helpers.cuh"

namespace {

constexpr int TQ = 32;          // chunk rows per tile
constexpr int THREADS = 256;    // 8 warps
constexpr int LT = TQ + 1;      // padded row stride of a 32 x 32 tile

struct BwdArgs {
  const void* x; const float* dt; const float* A; const void* Bm; const void* Cm;
  const float* dy; const float* dst; const float* ddall; const float* ddch;
  void* dx; float* ddt; float* dA; float* dB; float* dC;
  float* dxs; float* dB_part; float* dcb; double* dA_part; float* dw; float* cb;
  float* dcbs;
  int Bsz, S, H, P, N, Q, nc, nt, bf16;
  long long sxb, sxs, sbb, sbs, scb, scs;   // strides in elements
  // bf16 path only: scratch CB^T and dCB^T (B, nc, Q, Q), cum and w (B, H,
  // S); N padded to 16, 64-row tiles and 64-column slabs of N per chunk,
  // whether x and B, C allow 16-byte copies
  float* cbt; float* dcbt; double* cumg; float* wg; float* dBv;
  int n_pad, nqt, nnt, vx, vbc;
  float* dtT;   // wgmma route: dt (B, H, S)
  float* gcol;  // wgmma route: exp(cr - cum_j) dt_j (B, H, S), cr at j's 64-row tile's end
};

__device__ __forceinline__ float load_in(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// rounds to nearest even for bf16, as torch's .to(torch.bfloat16) does
__device__ __forceinline__ void store_out(void* p, long long i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// (b, c, h) of this block, heads fastest
struct Chunk {
  int b, c, h;
  long long s0;     // first position of the chunk
  long long bhc;    // index of (b, h, c) in the (B, H, nc) layouts
};

__device__ __forceinline__ Chunk chunk_of(const BwdArgs& a) {
  int bid = blockIdx.x;
  Chunk k;
  k.h = bid % a.H;
  bid /= a.H;
  k.c = bid % a.nc;
  k.b = bid / a.nc;
  k.s0 = (long long)k.c * a.Q;
  k.bhc = ((long long)k.b * a.H + k.h) * a.nc + k.c;
  return k;
}

// cum[t] = sum_{u<=t} (double)(dt_u * A_h), by one thread (Q <= a few
// hundred: negligible beside the products), then the block synchronises.
__device__ void chunk_cum(const BwdArgs& a, const Chunk& k, double* cum) {
  if (threadIdx.x == 0) {
    const float* dtg = a.dt + ((long long)k.b * a.S + k.s0) * a.H + k.h;
    const float Ah = a.A[k.h];
    double run = 0.0;
    for (int t = 0; t < a.Q; ++t) {
      run += (double)(dtg[(long long)t * a.H] * Ah);   // the log-decay rounds in f32
      cum[t] = run;
    }
  }
  __syncthreads();
}

size_t cb_smem_bytes(int N) { return sizeof(float) * (size_t)2 * TQ * (N + 1); }

// f32 kernel 0.  Thread (ty2, tx2) = (tid / 16, tid % 16) forms rows ty2,
// ty2 + 16 and columns tx2, tx2 + 16 of the tile.
__global__ void __launch_bounds__(THREADS) ssd_bwd_cb_kernel(BwdArgs a) {
  const int Q = a.Q, N = a.N, LN = N + 1;
  const bool bf16 = a.bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Cs = reinterpret_cast<float*>(smem_raw);         // TQ x LN: C_I
  float* Bs = Cs + TQ * LN;                               // TQ x LN: B_J
  const int tid = threadIdx.x, tx2 = tid & 15, ty2 = tid >> 4;
  int bid = blockIdx.x;
  const int n_pairs = a.nt * (a.nt + 1) / 2;
  int pair = bid % n_pairs;
  bid /= n_pairs;
  const int c = bid % a.nc, b = bid / a.nc;
  int it = 0;
  while (pair > it) pair -= ++it;          // pair = it (it + 1) / 2 + jt
  const int jt = pair;
  const int i0 = it * TQ, j0 = jt * TQ;
  const int ni = min(TQ, Q - i0), nj = min(TQ, Q - j0);
  const long long s0 = (long long)c * Q;
  for (int e = tid; e < TQ * N; e += THREADS) {
    const int r = e / N, n = e - r * N;
    Cs[r * LN + n] = r < ni ? load_in(a.Cm, b * a.scb + (s0 + i0 + r) * a.scs + n, bf16)
                            : 0.f;
    Bs[r * LN + n] = r < nj ? load_in(a.Bm, b * a.sbb + (s0 + j0 + r) * a.sbs + n, bf16)
                            : 0.f;
  }
  __syncthreads();
  float cb[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int n = 0; n < N; ++n) {
    const float c0 = Cs[ty2 * LN + n], c1 = Cs[(ty2 + 16) * LN + n];
    const float b0 = Bs[tx2 * LN + n], b1 = Bs[(tx2 + 16) * LN + n];
    cb[0][0] = fmaf(c0, b0, cb[0][0]);
    cb[0][1] = fmaf(c0, b1, cb[0][1]);
    cb[1][0] = fmaf(c1, b0, cb[1][0]);
    cb[1][1] = fmaf(c1, b1, cb[1][1]);
  }
  float* cbg = a.cb + ((long long)b * a.nc + c) * Q * Q;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri)
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int i = ty2 + 16 * ri, j = tx2 + 16 * ci;
      if (i < ni && j < nj) cbg[(long long)(i0 + i) * Q + j0 + j] = cb[ri][ci];
    }
}

size_t state_smem_bytes(int Q, int P, int N) {
  return sizeof(double) * Q +
         sizeof(float) * ((size_t)Q + (size_t)P * (N + 1) + (size_t)2 * TQ * (P + 1) +
                          (size_t)TQ * (N + 1));
}

// f32 kernel 1.  Thread (ty, tx) = (tid / 32, tid % 32) owns rows ty + 8r of a
// 32-row tile and columns tx + 32m.  PM = ceil(P / 32), NM = ceil(N / 32).
template <int PM, int NM>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state_kernel(BwdArgs a) {
  const int Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int LP = P + 1, LN = N + 1;
  const bool bf16 = a.bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);      // Q
  float* ws = reinterpret_cast<float*>(cum + Q);          // Q: w_j
  float* dS = ws + Q;                                     // P x LN
  float* xs = dS + P * LN;                                // TQ x LP
  float* Ut = xs + TQ * LP;                               // TQ x LP: x_j * U_j
  float* Bs = Ut + TQ * LP;                               // TQ x LN

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const Chunk k = chunk_of(a);
  chunk_cum(a, k, cum);
  const float* dtg = a.dt + ((long long)k.b * a.S + k.s0) * H + k.h;
  for (int t = tid; t < Q; t += THREADS)
    ws[t] = expf((float)(cum[Q - 1] - cum[t])) * dtg[(long long)t * H];
  const float* dsg = a.dst + k.bhc * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    dS[p * LN + n] = dsg[e];
  }

  for (int j0 = 0; j0 < Q; j0 += TQ) {
    const int nj = min(TQ, Q - j0);
    __syncthreads();          // ws, dS written; the previous tile's Ut read
    for (int e = tid; e < TQ * P; e += THREADS) {
      const int r = e / P, p = e - r * P;
      xs[r * LP + p] = r < nj ? load_in(a.x, k.b * a.sxb + (k.s0 + j0 + r) * a.sxs +
                                                 (long long)k.h * P + p, bf16)
                              : 0.f;
    }
    for (int e = tid; e < TQ * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      Bs[r * LN + n] = r < nj ? load_in(a.Bm, k.b * a.sbb + (k.s0 + j0 + r) * a.sbs + n,
                                        bf16)
                              : 0.f;
    }
    __syncthreads();

    // U = B_j dS^T (rows j, columns p), V = x_j dS (rows j, columns n)
    float u[4][PM], v[4][NM];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int m = 0; m < PM; ++m) u[r][m] = 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) v[r][m] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      float bv[4], dv[PM];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bs[(ty + 8 * r) * LN + n];
#pragma unroll
      for (int m = 0; m < PM; ++m) {
        const int p = tx + 32 * m;
        dv[m] = p < P ? dS[p * LN + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < PM; ++m) u[r][m] = fmaf(bv[r], dv[m], u[r][m]);
    }
    for (int p = 0; p < P; ++p) {
      float xv[4], dv[NM];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[(ty + 8 * r) * LP + p];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int n = tx + 32 * m;
        dv[m] = n < N ? dS[p * LN + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < NM; ++m) v[r][m] = fmaf(xv[r], dv[m], v[r][m]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 8 * r;
      if (j >= nj) continue;
      const long long s = k.s0 + j0 + j;
      const float wj = ws[j0 + j];
      float* dxr = a.dxs + (((long long)k.b * a.S + s) * H + k.h) * P;
#pragma unroll
      for (int m = 0; m < PM; ++m) {
        const int p = tx + 32 * m;
        if (p < P) {
          dxr[p] = wj * u[r][m];
          Ut[j * LP + p] = xs[j * LP + p] * u[r][m];
        }
      }
      float* dbr = a.dB_part + (((long long)k.h * a.Bsz + k.b) * a.S + s) * N;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int n = tx + 32 * m;
        if (n < N) dbr[n] = wj * v[r][m];
      }
    }
    __syncthreads();
    if (tid < nj) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc += Ut[tid * LP + p];
      a.dw[((long long)k.b * H + k.h) * a.S + k.s0 + j0 + tid] = acc;
    }
  }
}

size_t chunk_smem_bytes(int Q, int P) {
  return sizeof(double) * 4 * (size_t)Q +
         sizeof(float) * ((size_t)3 * Q + (size_t)2 * TQ * (P + 1) + (size_t)3 * TQ * LT);
}

// f32 kernel 2.  Tiles (32 x 32): thread (ty2, tx2) = (tid / 16, tid % 16) forms
// rows ty2, ty2 + 16 and columns tx2, tx2 + 16 of G, reads the same entries
// of CB (kernel 0) and writes the same entries of this head's dCB.  The
// product dx_J += M^T dy_I: thread (ty, tx) owns rows ty + 8r, columns
// tx + 32m.
template <int PM>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_kernel(BwdArgs a) {
  const int Q = a.Q, P = a.P, H = a.H;
  const int LP = P + 1;
  const bool bf16 = a.bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);      // Q
  double* rs = cum + Q;       // Q: sum_j G_ij M_ij (rows), then dla
  double* cs = rs + Q;        // Q: sum_i G_ij M_ij (columns)
  double* ts = cs + Q;        // Q: sum_i G_ij CB_ij e_ij (columns)
  float* dts = reinterpret_cast<float*>(ts + Q);          // Q: dt
  float* ws = dts + Q;                                    // Q: w
  float* dws = ws + Q;                                    // Q: dw
  float* xs = dws + Q;                                    // TQ x LP: x_J
  float* dys = xs + TQ * LP;                              // TQ x LP: dy_I
  float* Tm = dys + TQ * LP;                              // M
  float* Tgm = Tm + TQ * LT;                              // G M
  float* Tgt = Tgm + TQ * LT;                             // G CB e

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int tx2 = tid & 15, ty2 = tid >> 4;
  const Chunk k = chunk_of(a);
  chunk_cum(a, k, cum);
  const float* dtg = a.dt + ((long long)k.b * a.S + k.s0) * H + k.h;
  const float* dwg = a.dw + ((long long)k.b * H + k.h) * a.S + k.s0;
  for (int t = tid; t < Q; t += THREADS) {
    dts[t] = dtg[(long long)t * H];
    ws[t] = expf((float)(cum[Q - 1] - cum[t])) * dts[t];
    dws[t] = dwg[t];
    rs[t] = 0.0;
    cs[t] = 0.0;
    ts[t] = 0.0;
  }
  const long long bc = (long long)k.b * a.nc + k.c;
  const float* cbg = a.cb + bc * Q * Q;
  float* dcbg = a.dcb + (bc * H + k.h) * Q * Q;

  for (int jt = 0; jt < a.nt; ++jt) {
    const int j0 = jt * TQ, nj = min(TQ, Q - j0);
    __syncthreads();          // the previous J's tiles are read
    for (int e = tid; e < TQ * P; e += THREADS) {
      const int r = e / P, p = e - r * P;
      xs[r * LP + p] = r < nj ? load_in(a.x, k.b * a.sxb + (k.s0 + j0 + r) * a.sxs +
                                                 (long long)k.h * P + p, bf16)
                              : 0.f;
    }
    float ax[4][PM];                // M^T dy (rows j, columns p)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < PM; ++m) ax[r][m] = 0.f;

    for (int it = jt; it < a.nt; ++it) {
      const int i0 = it * TQ, ni = min(TQ, Q - i0);
      __syncthreads();        // the previous I's tiles are read
      for (int e = tid; e < TQ * P; e += THREADS) {
        const int r = e / P, p = e - r * P;
        dys[r * LP + p] =
            r < ni ? a.dy[(((long long)k.b * a.S + k.s0 + i0 + r) * H + k.h) * P + p] : 0.f;
      }
      __syncthreads();

      // G_ij = dy_i . x_j for this thread's 2 x 2, and CB_ij from kernel 0
      float cb[2][2], g[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          const int i = ty2 + 16 * ri, j = tx2 + 16 * ci;
          cb[ri][ci] = (i < ni && j < nj) ? cbg[(long long)(i0 + i) * Q + j0 + j] : 0.f;
        }
      for (int p = 0; p < P; ++p) {
        const float d0 = dys[ty2 * LP + p], d1 = dys[(ty2 + 16) * LP + p];
        const float x0 = xs[tx2 * LP + p], x1 = xs[(tx2 + 16) * LP + p];
        g[0][0] = fmaf(d0, x0, g[0][0]);
        g[0][1] = fmaf(d0, x1, g[0][1]);
        g[1][0] = fmaf(d1, x0, g[1][0]);
        g[1][1] = fmaf(d1, x1, g[1][1]);
      }
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          const int i = ty2 + 16 * ri, j = tx2 + 16 * ci;
          const int gi = i0 + i, gj = j0 + j;
          float m = 0.f, d = 0.f, gm = 0.f, gt = 0.f;
          if (i < ni && j < nj && gj <= gi) {     // the select: e only below
            const float e = expf((float)(cum[gi] - cum[gj]));
            const float ce = cb[ri][ci] * e;
            m = ce * dts[gj];
            d = g[ri][ci] * e * dts[gj];
            gm = g[ri][ci] * m;
            gt = g[ri][ci] * ce;
          }
          Tm[i * LT + j] = m;
          Tgm[i * LT + j] = gm;
          Tgt[i * LT + j] = gt;
          if (i < ni && j < nj) dcbg[(long long)gi * Q + gj] = d;
        }
      }
      __syncthreads();

      // row sums (one thread per row i), column sums (one per column j),
      // in f64: over a chunk the row and column sums of G M cancel exactly,
      // and f32 sums grouped by row and by column would leave their
      // rounding in dcum
      if (tid < TQ) {
        if (tid < ni) {
          double acc = 0.0;
          for (int j = 0; j < TQ; ++j) acc += (double)Tgm[tid * LT + j];
          rs[i0 + tid] += acc;
        }
      } else if (tid < 2 * TQ) {
        const int j = tid - TQ;
        if (j < nj) {
          double acc = 0.0, acc2 = 0.0;
          for (int i = 0; i < TQ; ++i) {
            acc += (double)Tgm[i * LT + j];
            acc2 += (double)Tgt[i * LT + j];
          }
          cs[j0 + j] += acc;
          ts[j0 + j] += acc2;
        }
      }

      // dx_J += M^T dy_I
      for (int i = 0; i < ni; ++i) {
        float mv[4], yv[PM];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = Tm[i * LT + ty + 8 * r];
#pragma unroll
        for (int m = 0; m < PM; ++m) {
          const int p = tx + 32 * m;
          yv[m] = p < P ? dys[i * LP + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int m = 0; m < PM; ++m) ax[r][m] = fmaf(mv[r], yv[m], ax[r][m]);
      }
    }

    // dx_J = the chunk state's share (kernel 1) + M^T dy, rounded once
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 8 * r;
      if (j >= nj) continue;
      const long long row = (((long long)k.b * a.S + k.s0 + j0 + j) * H + k.h) * P;
#pragma unroll
      for (int m = 0; m < PM; ++m) {
        const int p = tx + 32 * m;
        if (p < P) store_out(a.dx, row + p, a.dxs[row + p] + ax[r][m], bf16);
      }
    }
  }
  __syncthreads();

  // dcum, its reverse cumsum dla (into rs) and this (b, c, h)'s share of
  // dA, by one thread in f64
  if (tid == 0) {
    const float* dda = a.ddall + k.bhc * Q;
    double last = (double)a.ddch[k.bhc] * (double)expf((float)cum[Q - 1]);
    for (int j = 0; j < Q; ++j) last += (double)dws[j] * (double)ws[j];
    double run = 0.0, dA = 0.0;
    for (int u = Q - 1; u >= 0; --u) {
      double dcum = rs[u] - cs[u] - (double)dws[u] * (double)ws[u] +
                    (double)dda[u] * (double)expf((float)cum[u]);
      if (u == Q - 1) dcum += last;
      run += dcum;
      rs[u] = run;
      dA += (double)dts[u] * run;
    }
    a.dA_part[bc * H + k.h] = dA;
  }
  __syncthreads();
  const double Ah = (double)a.A[k.h];
  for (int t = tid; t < Q; t += THREADS) {
    const double d = ts[t] + (double)dws[t] * (double)expf((float)(cum[Q - 1] - cum[t])) +
                     Ah * rs[t];
    a.ddt[((long long)k.b * a.S + k.s0 + t) * H + k.h] = (float)d;
  }
}

// f32 kernel 3: dCB summed over heads, in order, where j <= i (0 above).
__global__ void __launch_bounds__(THREADS) ssd_bwd_head_sum_kernel(BwdArgs a) {
  const long long QQ = (long long)a.Q * a.Q, total = (long long)a.Bsz * a.nc * QQ;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long bc = e / QQ, ij = e - bc * QQ;
    const long long i = ij / a.Q, j = ij - i * a.Q;
    float s = 0.f;
    if (j <= i) {
      const float* d = a.dcb + bc * a.H * QQ + ij;
      for (int h = 0; h < a.H; ++h) s += d[h * QQ];
    }
    a.dcbs[e] = s;
  }
}

// f32 kernel 4, a block per (b, c, u), u < nt or nt <= u < 2 nt: rows I = u of
// dC = sum_{J <= I} dCB_IJ B_J, or rows J = u - nt of dB's share
// sum_{I >= J} dCB_IJ^T C_I (the first write of dB), dCB summed over heads
// (kernel 3).  Thread (ty, tx) owns rows ty + 8r, columns tx + 32m.
template <int NM>
__global__ void __launch_bounds__(THREADS) ssd_bwd_bc_kernel(BwdArgs a) {
  const int Q = a.Q, N = a.N, LN = N + 1, nt = a.nt;
  const bool bf16 = a.bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ts = reinterpret_cast<float*>(smem_raw);         // TQ x LT: dCB_IJ
  float* Os = Ts + TQ * LT;                               // TQ x LN: B_J or C_I
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  int bid = blockIdx.x;
  const int t = bid % (2 * nt);
  bid /= 2 * nt;
  const int c = bid % a.nc, b = bid / a.nc;
  const bool dc = t < nt;                  // dC rows I = u, else dB rows J = u
  const int u = dc ? t : t - nt, u0 = u * TQ, nu = min(TQ, Q - u0);
  const long long s0 = (long long)c * Q;
  const float* dcbs = a.dcbs + ((long long)b * a.nc + c) * Q * Q;
  const void* opnd = dc ? a.Bm : a.Cm;
  const long long sob = dc ? a.sbb : a.scb, sos = dc ? a.sbs : a.scs;
  float acc[4][NM];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < NM; ++m) acc[r][m] = 0.f;
  for (int v = dc ? 0 : u; dc ? v <= u : v < nt; ++v) {
    const int v0 = v * TQ, nv = min(TQ, Q - v0);
    __syncthreads();          // the previous tiles are read
    for (int e = tid; e < TQ * TQ; e += THREADS) {
      const int r = e / TQ, q = e - r * TQ;
      Ts[r * LT + q] = dc ? (r < nu && q < nv ? dcbs[(long long)(u0 + r) * Q + v0 + q] : 0.f)
                          : (r < nv && q < nu ? dcbs[(long long)(v0 + r) * Q + u0 + q] : 0.f);
    }
    for (int e = tid; e < TQ * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      Os[r * LN + n] = r < nv ? load_in(opnd, b * sob + (s0 + v0 + r) * sos + n, bf16) : 0.f;
    }
    __syncthreads();
    for (int q = 0; q < nv; ++q) {
      float tv[4], ov[NM];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        tv[r] = dc ? Ts[(ty + 8 * r) * LT + q] : Ts[q * LT + ty + 8 * r];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int n = tx + 32 * m;
        ov[m] = n < N ? Os[q * LN + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[r][m] = fmaf(tv[r], ov[m], acc[r][m]);
    }
  }
  float* out = (dc ? a.dC : a.dB) + ((long long)b * a.S + s0 + u0) * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 8 * r;
    if (i >= nu) continue;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int n = tx + 32 * m;
      if (n < N) out[(long long)i * N + n] = acc[r][m];
    }
  }
}

// f32 kernel 5: dB += the chunk state's share summed over heads (f32, h in
// order); dA summed over (b, c) (f64).  bf16 kernel 4 (no dB_part): dA.
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(BwdArgs a) {
  const long long bsn = a.dB_part ? (long long)a.Bsz * a.S * a.N : 0;
  const long long total = bsn + a.H;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    if (e < bsn) {
      float sb = 0.f;
      for (int h = 0; h < a.H; ++h) sb += a.dB_part[h * bsn + e];
      a.dB[e] += sb;
    } else {
      const int h = (int)(e - bsn);
      double s = 0.0;
      for (int bc = 0; bc < a.Bsz * a.nc; ++bc) s += a.dA_part[(long long)bc * a.H + h];
      a.dA[h] = (float)s;
    }
  }
}

// ---------------------------------------------------------------- bf16 ---

constexpr int TB = 64;              // chunk rows per tile
constexpr int MT = 128;             // 4 warps, 16 rows of a tile each
constexpr int NC = 64;              // columns of N per slab
constexpr int LC = NC + mma::PAD;   // bf16 row stride of a 64-column tile
constexpr int LF = TB + 8;          // f32 row stride of a 64-column tile

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Rows [0, rows) x columns [0, cols) of an f32 matrix (row r at src + r *
// ld) split into three bf16 tiles, hi, mid and lo, `part` elements apart, of
// row stride lds; rows >= nrows and columns >= ncols are zero.  cols, lds
// and part are even.  Each thread issues all its loads before it stores
// any: the stores go through a generic pointer, so loads behind them would
// wait for each other.
constexpr int SPLIT_BATCH = 16;
__device__ __forceinline__ void split_tile(__nv_bfloat16* dst, int part, int lds,
                                           const float* src, long long ld, int rows,
                                           int nrows, int cols, int ncols) {
  const int cp = cols / 2, total = rows * cp;
  for (int e0 = threadIdx.x; e0 < total; e0 += MT * SPLIT_BATCH) {
    float v[SPLIT_BATCH][2];
#pragma unroll
    for (int k = 0; k < SPLIT_BATCH; ++k) {
      const int e = e0 + k * MT, r = e / cp, c = (e - r * cp) * 2;
      const bool ok = e < total && r < nrows;
      v[k][0] = ok && c < ncols ? src[r * ld + c] : 0.f;
      v[k][1] = ok && c + 1 < ncols ? src[r * ld + c + 1] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < SPLIT_BATCH; ++k) {
      const int e = e0 + k * MT, r = e / cp, c = (e - r * cp) * 2;
      if (e >= total) break;
      uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * lds + c);
      mma::split3_bf16(v[k][0], v[k][1], d[0], d[part / 2], d[part]);
    }
  }
}

// Rows [0, rows) x columns [0, cols) of an f32 matrix (row r at src + r *
// lds) into a shared tile of row stride ldd by cp.async, by `nt` threads
// (the caller commits and waits); rows >= nrows and columns >= ncols are
// zero.  vec: src, lds and ldd allow 16-byte copies and cols and ncols
// are multiples of 4.
__device__ __forceinline__ void load_f32(float* dst, int ldd, const float* src, long long lds,
                                         int rows, int nrows, int cols, int ncols, bool vec,
                                         int nt) {
  if (vec) {
    const int cq = cols / 4;
    for (int e = threadIdx.x; e < rows * cq; e += nt) {
      const int r = e / cq, c = (e - r * cq) * 4;
      const bool ok = r < nrows && c < ncols;
      mma::cp_async16(dst + r * ldd + c, ok ? src + r * lds + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += nt) {
      const int r = e / cols, c = e - r * cols;
      if (r < nrows && c < ncols)
        mma::cp_async4(dst + r * ldd + c, src + r * lds + c);
      else
        dst[r * ldd + c] = 0.f;
    }
  }
}

// The same tile, already in shared memory (row stride lds), split into
// three bf16 tiles `part` elements apart, of row stride ldd; cols even.
__device__ __forceinline__ void split_smem(__nv_bfloat16* dst, int part, int ldd,
                                           const float* src, int lds, int rows, int cols,
                                           int nt) {
  const int cp = cols / 2;
  for (int e = threadIdx.x; e < rows * cp; e += nt) {
    const int r = e / cp, c = (e - r * cp) * 2;
    const float2 v = *reinterpret_cast<const float2*>(src + r * lds + c);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + r * ldd + c);
    mma::split3_bf16(v.x, v.y, d[0], d[part / 2], d[part]);
  }
}

// cum[t] = sum_{u<=t} (double)(dts[t] * Ah) for t < n, by all MT threads: a
// sequential run per thread, then a scan of the runs.  The caller has
// synchronised (dts is written); returns synchronised.
__device__ void block_cum(const float* dts, float Ah, int n, double* cum, double* wtot) {
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

// v[t] = sum_{u >= t} v[u] for t < n, in place, by all MT threads, in the
// same fixed order as block_cum; returns synchronised.
__device__ void block_suffix_sum(double* v, int n, double* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + MT - 1) / MT;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  double run = 0.0;
  for (int t = hi - 1; t >= lo; --t) {
    run += v[t];
    v[t] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += o;
  }
  if (lane == 0) wtot[warp] = incl;
  __syncthreads();
  double after = incl - run;
  for (int w = warp + 1; w < MT / 32; ++w) after += wtot[w];
  for (int t = lo; t < hi; ++t) v[t] += after;
  __syncthreads();
}

// The sum of every thread's v, the same bits in every thread; the caller's
// last use of wtot is behind a barrier.
__device__ double block_sum(double v, double* wtot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) wtot[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < MT / 32; ++w) s += wtot[w];
  __syncthreads();
  return s;
}

// bf16 kernel 0.  Warp w forms rows j0 + 16w .. +15 of CB^T_JI, 64 columns
// i, one product over N (both sides exact in bf16).
__global__ void __launch_bounds__(MT) ssd_bwd_cb_mma_kernel(BwdArgs a) {
  const int Q = a.Q, N = a.N, n_pad = a.n_pad, LN = n_pad + mma::PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);     // TB x LN: B_J
  __nv_bfloat16* Cs = Bs + TB * LN;                                     // TB x LN: C_I
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_pairs = a.nqt * (a.nqt + 1) / 2;
  int pair = blockIdx.x % n_pairs;
  const long long bc = blockIdx.x / n_pairs;
  const int c = (int)(bc % a.nc), b = (int)(bc / a.nc);
  int it = 0;
  while (pair > it) pair -= ++it;          // pair = it (it + 1) / 2 + jt
  const int i0 = it * TB, j0 = pair * TB;
  const long long s0 = (long long)c * Q;
  const __nv_bfloat16* Bg = static_cast<const __nv_bfloat16*>(a.Bm) + b * a.sbb + s0 * a.sbs;
  const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(a.Cm) + b * a.scb + s0 * a.scs;
  mma::load_tile(Bs, LN, Bg + (long long)j0 * a.sbs, a.sbs, TB, Q - j0, N, n_pad, a.vbc, tid, MT);
  mma::load_tile(Cs, LN, Cg + (long long)i0 * a.scs, a.scs, TB, Q - i0, N, n_pad, a.vbc, tid, MT);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  float cb[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
  for (int ks = 0; ks < n_pad / 16; ++ks) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, Bs + (warp * 16 + (lane & 15)) * LN + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bf[4];
      mma::ldmatrix_x4(bf, Cs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LN + ks * 16 +
                               ((lane >> 3) & 1) * 8);
      mma::mma_bf16(cb[2 * np], af, bf[0], bf[1]);
      mma::mma_bf16(cb[2 * np + 1], af, bf[2], bf[3]);
    }
  }
  float* out = a.cbt + bc * Q * Q;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + warp * 16 + g + 8 * (e >> 1), i = i0 + n * 8 + 2 * t4 + (e & 1);
      if (j < Q && i < Q) out[(long long)j * Q + i] = cb[n][e];
    }
}

// Shared memory of bf16 kernel 1: the head's vectors (cum, rs, cs, ts in
// f64, the scan's warp totals, the warps' column sums; dt, w, dw in f32,
// the column factors of a tile I), x_J, and a region that holds B_J and a
// split 64-column slab of dS while U is formed, then dy_I split in three
// beside the next dy tile as it arrives (f32).
struct ChunkLayout {
  int LX, LN, LY;
  size_t xs, reg, total;   // byte offsets of x_J and the region; the size
  __host__ __device__ ChunkLayout(int Q, int PP, int n_pad) {
    LX = PP + mma::PAD;
    LN = n_pad + mma::PAD;
    LY = PP + 4;
    xs = align16((size_t)Q * 4 * 8 + 4 * 8 + (size_t)4 * TB * 8 + (size_t)Q * 3 * 4 + TB * 4);
    reg = xs + align16((size_t)TB * LX * 2);
    const size_t u = (size_t)TB * LN * 2 + (size_t)3 * PP * LC * 2;
    const size_t p = (size_t)3 * TB * LX * 2 + (size_t)TB * LY * 4;
    total = reg + align16(u > p ? u : p);
  }
};

// bf16 kernel 1; PT = P padded to 16, over 16.  Warp w owns rows j0 + 16w
// .. +15 of each tile J (in the mma layouts: lane (g, t4) rows g and g + 8,
// columns 2 t4 and 2 t4 + 1 of each 8-column n-tile).
template <int PT>
__global__ void __launch_bounds__(MT) ssd_bwd_chunk_mma_kernel(BwdArgs a) {
  constexpr int PP = PT * 16;
  const int Q = a.Q, P = a.P, N = a.N, H = a.H, n_pad = a.n_pad;
  const ChunkLayout L(Q, PP, n_pad);
  const int LX = L.LX, LN = L.LN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  double* rs = cum + Q;       // sum_j G_ij M_ij (rows i), then dcum and dla
  double* cs = rs + Q;        // sum_i G_ij M_ij (columns j)
  double* ts = cs + Q;        // sum_i G_ij CB_ij e_ij (columns j)
  double* wtot = ts + Q;      // 4
  double* rsw = wtot + 4;     // 4 x TB: each warp's share of rs for tile I
  float* dts = reinterpret_cast<float*>(rsw + 4 * TB);
  float* ws = dts + Q;
  float* dws = ws + Q;
  float* fcs = dws + Q;       // TB: exp(cum_i - cr) over tile I, cr below
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.xs);     // TB x LX
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.reg);    // TB x LN
  __nv_bfloat16* Ds = Bs + TB * LN;                                          // 3 x PP x LC
  __nv_bfloat16* Ys = Bs;                                                    // 3 x TB x LX
  float* raw = reinterpret_cast<float*>(smem_raw + L.reg + (size_t)3 * TB * LX * 2);  // TB x LY

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Chunk k = chunk_of(a);
  const long long bc = (long long)k.b * a.nc + k.c;
  const float* dtg = a.dt + ((long long)k.b * a.S + k.s0) * H + k.h;
  for (int t = tid; t < Q; t += MT) dts[t] = dtg[(long long)t * H];
  __syncthreads();
  block_cum(dts, a.A[k.h], Q, cum, wtot);
  const double c_last = cum[Q - 1];
  const long long bhs = ((long long)k.b * H + k.h) * a.S + k.s0;
  for (int t = tid; t < Q; t += MT) {
    ws[t] = expf((float)(c_last - cum[t])) * dts[t];
    rs[t] = 0.0;
    a.cumg[bhs + t] = cum[t];
    a.wg[bhs + t] = ws[t];
  }
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) + k.b * a.sxb +
                            k.s0 * a.sxs + (long long)k.h * P;
  const __nv_bfloat16* Bg = static_cast<const __nv_bfloat16*>(a.Bm) + k.b * a.sbb + k.s0 * a.sbs;
  const long long dyr = (long long)H * P;                    // dy's row stride
  const float* dyg = a.dy + (((long long)k.b * a.S + k.s0) * H + k.h) * P;
  const float* dsg = a.dst + k.bhc * P * N;
  const float* cbg = a.cbt + bc * Q * Q;
  const bool vdy = P % 4 == 0;

  for (int jt = 0; jt < a.nqt; ++jt) {
    const int j0 = jt * TB, wj = j0 + warp * 16;    // wj: this warp's first row
    __syncthreads();          // Xs and the region are free; ws, rs written
    mma::load_tile(Xs, LX, xg + (long long)j0 * a.sxs, a.sxs, TB, Q - j0, P, PP, a.vx, tid, MT);
    mma::load_tile(Bs, LN, Bg + (long long)j0 * a.sbs, a.sbs, TB, Q - j0, N, n_pad, a.vbc,
                   tid, MT);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    uint32_t xa[PT][4];       // x_J, A layout (rows j, k = p), for the whole pass
#pragma unroll
    for (int ks = 0; ks < PT; ++ks)
      mma::ldmatrix_x4(xa[ks], Xs + (warp * 16 + (lane & 15)) * LX + ks * 16 + (lane >> 4) * 8);

    // U_J = B_J dS^T (rows j, columns p), dS split in three, 64 columns of
    // N a pass
    float acc[2 * PT][4];
#pragma unroll
    for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int n0 = 0; n0 < n_pad; n0 += NC) {
      if (n0 > 0) __syncthreads();          // the last slab is read
      split_tile(Ds, PP * LC, LC, dsg + n0, N, PP, P, NC, N - n0);
      __syncthreads();
      const int kn = min(NC, n_pad - n0) / 16;
      for (int kk = 0; kk < kn; ++kk) {
        uint32_t af[4];
        mma::ldmatrix_x4(af, Bs + (warp * 16 + (lane & 15)) * LN + n0 + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < PT; ++np)
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            uint32_t bf[4];
            mma::ldmatrix_x4(bf, Ds + u * PP * LC + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LC +
                                     kk * 16 + ((lane >> 3) & 1) * 8);
            mma::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
          }
      }
    }
    // dw_j = x_j . U_j; dx_j starts as w_j U_j
    float dwp[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dwp[e >> 1] += __bfloat162float(Xs[(warp * 16 + g + 8 * (e >> 1)) * LX + n * 8 +
                                           2 * t4 + (e & 1)]) * acc[n][e];
    double cj[2];
    float dj[2], wr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dwp[r] += __shfl_xor_sync(0xffffffffu, dwp[r], 1);
      dwp[r] += __shfl_xor_sync(0xffffffffu, dwp[r], 2);
      const int j = min(wj + g + 8 * r, Q - 1);
      if (t4 == 0 && wj + g + 8 * r < Q) dws[j] = dwp[r];
      cj[r] = cum[j];
      dj[r] = dts[j];
      wr[r] = ws[j];
    }
#pragma unroll
    for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= wr[e >> 1];
    // below the tile J, exp(cum_i - cum_j) = exp(cum_i - cr) exp(cr - cum_j)
    // with cr = cum at J's last row: both factors at most 1 (cum falls)
    const double cr = cum[min(j0 + TB - 1, Q - 1)];
    float fr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) fr[r] = expf((float)(cr - cj[r]));

    double csl[2] = {0.0, 0.0}, tsl[2] = {0.0, 0.0};
    __syncthreads();          // U's operands are read: the region takes dy_J
    load_f32(raw, L.LY, dyg + (long long)j0 * dyr, dyr, TB, Q - j0, PP, P, vdy, MT);
    mma::cp_async_commit();
    for (int it = jt; it < a.nqt; ++it) {
      const int i0 = it * TB;
      mma::cp_async_wait<0>();
      __syncthreads();        // dy_I landed; Ys and rsw are free
      if (it > jt && tid < TB && i0 - TB + tid < Q)   // the last tile's rs
        rs[i0 - TB + tid] += ((rsw[tid] + rsw[TB + tid]) + rsw[2 * TB + tid]) + rsw[3 * TB + tid];
      split_smem(Ys, TB * LX, LX, raw, L.LY, TB, PP, MT);
      const bool diag = it == jt;
      if (!diag && tid < TB) fcs[tid] = i0 + tid < Q ? expf((float)(cum[i0 + tid] - cr)) : 0.f;
      __syncthreads();        // Ys and fcs ready; the next dy tile may land
      if (it + 1 < a.nqt)
        load_f32(raw, L.LY, dyg + (long long)(i0 + TB) * dyr, dyr, TB, Q - i0 - TB, PP, P, vdy, MT);
      mma::cp_async_commit();
#pragma unroll 1
      for (int s = 0; s < TB / 16; ++s) {
        const int ib = i0 + s * 16;
        double colp[2][2] = {{0.0, 0.0}, {0.0, 0.0}};   // column sums of G o M, for rs
        if (ib < Q && wj < Q && ib + 15 >= wj) {        // some j <= i in this 16 x 16
          // CB^T_ji from the scratch (L2), in flight while G forms
          float cbv[2][2][2];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int c2 = 0; c2 < 2; ++c2) {
                const int j = wj + g + 8 * r, i = ib + q * 8 + 2 * t4 + c2;
                cbv[q][r][c2] = j < Q && i < Q ? cbg[(long long)j * Q + i] : 0.f;
              }
          // G^T (rows j, columns i) = x_J dy_I^T, dy in three parts
          float gacc[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) gacc[q][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < PT; ++ks)
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              uint32_t bf[4];
              mma::ldmatrix_x4(bf, Ys + u * TB * LX + (s * 16 + (lane & 7) + (lane >> 4) * 8) * LX +
                                       ks * 16 + ((lane >> 3) & 1) * 8);
              mma::mma_bf16(gacc[0], xa[ks], bf[0], bf[1]);
              mma::mma_bf16(gacc[1], xa[ks], bf[2], bf[3]);
            }
          // e = exp(cum_i - cum_j) where j <= i, 0 elsewhere: on the diagonal
          // tile a select (above the diagonal the exp is inf), below it the
          // product of the two factors; no branch per element
          float ev[2][4];
          if (diag) {
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int c2 = 0; c2 < 2; ++c2) {
                const int gi = i0 + s * 16 + q * 8 + 2 * t4 + c2;
                const double ci = cum[min(gi, Q - 1)];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                  const float ex = expf((float)(ci - cj[r]));
                  ev[q][2 * r + c2] = wj + g + 8 * r <= gi && gi < Q ? ex : 0.f;
                }
              }
          } else {
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int c2 = 0; c2 < 2; ++c2) {
                const float fc = fcs[s * 16 + q * 8 + 2 * t4 + c2];
#pragma unroll
                for (int r = 0; r < 2; ++r) ev[q][2 * r + c2] = fc * fr[r];
              }
          }
          // M^T = CB^T e dt_j, the sums (over the same f32 values), and M^T
          // in the A layout (rows j, k = i)
          float mv[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int c2 = 0; c2 < 2; ++c2) {
                const float gv = gacc[q][2 * r + c2];
                const float ce = cbv[q][r][c2] * ev[q][2 * r + c2];
                const float m = ce * dj[r], gm = gv * m, gt = gv * ce;
                mv[q][2 * r + c2] = m;
                csl[r] += (double)gm;
                tsl[r] += (double)gt;
                colp[q][c2] += (double)gm;
              }
            }
          }
          uint32_t ma[2][4];      // M^T as hi + mid
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            uint32_t lo;
            mma::split3_bf16(mv[qq >> 1][(qq & 1) * 2], mv[qq >> 1][(qq & 1) * 2 + 1],
                             ma[0][qq], ma[1][qq], lo);
          }
          // dx_J += M^T dy_I: the three leading products of the two splits,
          // hi hi + hi mid + mid hi (about 2^-17: dx is rounded to bf16)
#pragma unroll
          for (int np = 0; np < PT; ++np) {
            uint32_t yf[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
              mma::ldmatrix_x4_trans(yf[u], Ys + u * TB * LX +
                                                (s * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LX +
                                                np * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int tt = 0; tt < 3; ++tt) {
              mma::mma_bf16(acc[2 * np], ma[tt == 2], yf[tt == 1][0], yf[tt == 1][1]);
              mma::mma_bf16(acc[2 * np + 1], ma[tt == 2], yf[tt == 1][2], yf[tt == 1][3]);
            }
          }
        }
        // the warp's 16 rows summed per column (over g), in f64
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              colp[q][c2] += __shfl_xor_sync(0xffffffffu, colp[q][c2], off);
            if (g == 0) rsw[warp * TB + s * 16 + q * 8 + 2 * t4 + c2] = colp[q][c2];
          }
      }
    }
    __syncthreads();          // the last tile's rs
    const int il0 = (a.nqt - 1) * TB;
    if (tid < TB && il0 + tid < Q)
      rs[il0 + tid] += ((rsw[tid] + rsw[TB + tid]) + rsw[2 * TB + tid]) + rsw[3 * TB + tid];
    // cs, ts for this warp's rows (over t4); dx_J, rounded once to bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        csl[r] += __shfl_xor_sync(0xffffffffu, csl[r], off);
        tsl[r] += __shfl_xor_sync(0xffffffffu, tsl[r], off);
      }
      const int j = wj + g + 8 * r;
      if (j >= Q) continue;
      if (t4 == 0) {
        cs[j] = csl[r];
        ts[j] = tsl[r];
      }
      __nv_bfloat16* dxr = static_cast<__nv_bfloat16*>(a.dx) +
                           (((long long)k.b * a.S + k.s0 + j) * H + k.h) * P;
#pragma unroll
      for (int n = 0; n < 2 * PT; ++n)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int p = n * 8 + 2 * t4 + c2;
          if (p < P) dxr[p] = __float2bfloat16(acc[n][2 * r + c2]);
        }
    }
  }
  __syncthreads();            // rs, cs, ts, dws complete

  // dcum (into rs), its reverse cumsum dla, this (b, c, h)'s share of dA,
  // ddt; block-wide in f64, each sum in a fixed order
  const float* dda = a.ddall + k.bhc * Q;
  double sdw = 0.0;
  for (int t = tid; t < Q; t += MT) sdw += (double)dws[t] * (double)ws[t];
  const double last = (double)a.ddch[k.bhc] * (double)expf((float)c_last) + block_sum(sdw, wtot);
  for (int t = tid; t < Q; t += MT) {
    double d = rs[t] - cs[t] - (double)dws[t] * (double)ws[t] +
               (double)dda[t] * (double)expf((float)cum[t]);
    if (t == Q - 1) d += last;
    rs[t] = d;
  }
  __syncthreads();
  block_suffix_sum(rs, Q, wtot);
  double sda = 0.0;
  for (int t = tid; t < Q; t += MT) sda += (double)dts[t] * rs[t];
  const double dA = block_sum(sda, wtot);
  if (tid == 0) a.dA_part[bc * H + k.h] = dA;
  const double Ah = (double)a.A[k.h];
  for (int t = tid; t < Q; t += MT)
    a.ddt[((long long)k.b * a.S + k.s0 + t) * H + k.h] =
        (float)(ts[t] + (double)dws[t] * (double)expf((float)(c_last - cum[t])) + Ah * rs[t]);
}

constexpr int HT = 256;    // bf16 kernel 2: 8 warps
constexpr int HSTAGES = 3;  // bf16 kernel 2: heads in flight
constexpr int HG = 2;       // bf16 kernel 2: groups of heads, each summed by its own blocks

// Shared memory of bf16 kernel 2: three stages, each x_J, the f32 operand as
// it arrives (dy_I, or a 64-column slab of dS) and cum over J and I (f64)
// with dt or w over J; then the operand split in three, and the factors of
// e dt over I and J.
struct HeadsLayout {
  int LX, LY, LS;          // row strides: x_J (bf16), dy_I and dS (f32)
  size_t raw, vec, stage, ops, fac, total;   // offsets: within a stage; in all
  __host__ __device__ explicit HeadsLayout(int PP) {
    LX = PP + mma::PAD;
    LY = PP + 4;
    LS = NC + 4;
    raw = align16((size_t)TB * LX * 2);
    const size_t rawf = (size_t)TB * LY > (size_t)PP * LS ? (size_t)TB * LY : (size_t)PP * LS;
    vec = raw + align16(rawf * 4);
    stage = vec + align16((size_t)TB * 8 * 2 + (size_t)TB * 4);
    ops = HSTAGES * stage;
    const size_t op = (size_t)TB * LX > (size_t)PP * LC ? (size_t)TB * LX : (size_t)PP * LC;
    fac = ops + align16(3 * op * 2);
    total = fac + 2 * TB * 4;
  }
};

// One role of bf16 kernel 2 over the heads of group grp, DCB: the tile
// pair (J, I), I >= J, else (J, the 64 columns of N from n0).  Warp w owns
// rows j0 + 16 (w % 4) .. +15 and columns 32 (w / 4) .. +31 of a 64 x 64
// accumulator summed over the group's heads in order.  Heads h + 1 and h + 2's tiles load (cp.async)
// while head h is split and multiplied.  A role per instantiation keeps
// the loop's code short.
template <int PT, bool DCB>
__device__ __forceinline__ void heads_role(const BwdArgs& a, unsigned char* smem_raw, int b,
                                           int c, int grp, int j0, int i0, int n0) {
  constexpr int PP = PT * 16;
  const HeadsLayout L(PP);
  const int LX = L.LX;
  const int Q = a.Q, P = a.P, N = a.N, H = a.H;
  const int hn = (H + HG - 1) / HG, hb = grp * hn, nh = max(0, min(hn, H - hb));   // the group's heads
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.ops);
  float* fI = reinterpret_cast<float*>(smem_raw + L.fac);     // TB: exp(cum_i - cr)
  float* gJ = fI + TB;                                        // TB: exp(cr - cum_j) dt_j
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  const int wj = j0 + wr;
  const long long s0 = (long long)c * Q, bc = (long long)b * a.nc + c;
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x) + b * a.sxb + s0 * a.sxs +
                            (long long)j0 * a.sxs;
  // the f32 operand of head 0 and its step per head: dy_I, or dS's slab
  const float* og = DCB ? a.dy + (((long long)b * a.S + s0 + i0) * H) * P
                        : a.dst + ((long long)b * H * a.nc + c) * P * N + n0;
  const long long ostep = DCB ? P : (long long)a.nc * P * N;
  const bool vo = DCB ? P % 4 == 0 : N % 4 == 0;

  // stage kl: x_J, the f32 operand and the vectors of head k = hb + kl
  auto issue = [&](int kl) {
    const int k = hb + kl;
    unsigned char* st = smem_raw + (kl % HSTAGES) * L.stage;
    mma::load_tile(reinterpret_cast<__nv_bfloat16*>(st), LX, xg + (long long)k * P, a.sxs, TB,
                   Q - j0, P, PP, a.vx, tid, HT);
    float* raw = reinterpret_cast<float*>(st + L.raw);
    if (DCB)
      load_f32(raw, L.LY, og + k * ostep, (long long)H * P, TB, Q - i0, PP, P, vo, HT);
    else
      load_f32(raw, L.LS, og + k * ostep, N, PP, P, NC, N - n0, vo, HT);
    double* cJ = reinterpret_cast<double*>(st + L.vec);
    float* vJ = reinterpret_cast<float*>(cJ + 2 * TB);
    const long long bhs = ((long long)b * H + k) * a.S + s0;
    if (tid < TB) {           // dt or w over J
      const float* src = DCB ? a.dt + ((long long)b * a.S + s0 + j0 + tid) * H + k
                             : a.wg + bhs + j0 + tid;
      if (j0 + tid < Q)
        mma::cp_async4(vJ + tid, src);
      else
        vJ[tid] = 0.f;
    } else if (DCB && tid < 3 * TB) {   // cum over J, then over I, as 32-bit words
      const int t = tid - TB, half = t / TB, u = t - half * TB, row = (half ? i0 : j0) + u;
      uint32_t* d = reinterpret_cast<uint32_t*>(cJ + half * TB + u);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(a.cumg + bhs + row);
      if (row < Q) {
        mma::cp_async4(d, src);
        mma::cp_async4(d + 1, src + 1);
      } else {
        d[0] = d[1] = 0u;
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int k = 0; k < HSTAGES - 1; ++k) {
    if (k < nh) issue(k);
    mma::cp_async_commit();
  }
  for (int h = 0; h < nh; ++h) {
    mma::cp_async_wait<HSTAGES - 2>();
    __syncthreads();          // stage h landed; head h - 1's Os and stage are free
    if (h + HSTAGES - 1 < nh) issue(h + HSTAGES - 1);
    mma::cp_async_commit();
    const unsigned char* st = smem_raw + (h % HSTAGES) * L.stage;
    const float* raw = reinterpret_cast<const float*>(st + L.raw);
    const double* cJ = reinterpret_cast<const double*>(st + L.vec);
    const double* cI = cJ + TB;
    const float* vJ = reinterpret_cast<const float*>(cJ + 2 * TB);
    if (DCB) {
      split_smem(Os, TB * LX, LX, raw, L.LY, TB, PP, HT);
      if (i0 > j0) {
        // below the diagonal tile, e dt = exp(cum_i - cr) exp(cr - cum_j)
        // dt_j with cr = cum at J's last row: both factors at most 1 (cum
        // falls)
        const double cr = cJ[TB - 1];
        if (tid < TB)
          fI[tid] = i0 + tid < Q ? expf((float)(cI[tid] - cr)) : 0.f;
        else if (tid < 2 * TB)
          gJ[tid - TB] = expf((float)(cr - cJ[tid - TB])) * vJ[tid - TB];
      }
    } else {
      split_smem(Os, PP * LC, LC, raw, L.LS, PP, NC, HT);
    }
    __syncthreads();
    if (wj >= Q) continue;
    const __nv_bfloat16* Xs = reinterpret_cast<const __nv_bfloat16*>(st);
    uint32_t xa[PT][4];
#pragma unroll
    for (int ks = 0; ks < PT; ++ks)
      mma::ldmatrix_x4(xa[ks], Xs + (wr + (lane & 15)) * LX + ks * 16 + (lane >> 4) * 8);
    float pr[4][4];           // this head's 16 x 32 product
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[n][e] = 0.f;
    // G^T = x_J dy_I^T, or V = x_J dS; the f32 side in three parts
#pragma unroll
    for (int ks = 0; ks < PT; ++ks)
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          if (DCB)
            mma::ldmatrix_x4(bf, Os + u * TB * LX + (wc + np * 16 + (lane & 7) + (lane >> 4) * 8) * LX +
                                     ks * 16 + ((lane >> 3) & 1) * 8);
          else
            mma::ldmatrix_x4_trans(bf, Os + u * PP * LC +
                                           (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LC +
                                           wc + np * 16 + (lane >> 4) * 8);
          mma::mma_bf16(pr[2 * np], xa[ks], bf[0], bf[1]);
          mma::mma_bf16(pr[2 * np + 1], xa[ks], bf[2], bf[3]);
        }
    if (!DCB) {               // dB_J += w_J V
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += vJ[wr + g + 8 * (e >> 1)] * pr[n][e];
    } else if (i0 > j0) {     // dCB^T += G^T e dt_j: the two factors
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(pr[n][e], fI[wc + n * 8 + 2 * t4 + (e & 1)] * gJ[wr + g + 8 * (e >> 1)],
                           acc[n][e]);
    } else {                  // on the diagonal tile a select: above it the exp is inf
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = wr + g + 8 * (e >> 1), il = wc + n * 8 + 2 * t4 + (e & 1);
          const float ex = pr[n][e] * expf((float)(cI[il] - cJ[jl])) * vJ[jl];
          acc[n][e] += j0 + jl <= i0 + il && i0 + il < Q ? ex : 0.f;
        }
    }
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = wj + g + 8 * (e >> 1), col = wc + n * 8 + 2 * t4 + (e & 1);
      if (j >= Q) continue;
      if (DCB) {
        if (i0 + col < Q)
          a.dcbt[(bc * HG + grp) * Q * Q + (long long)j * Q + i0 + col] = acc[n][e];
      } else if (n0 + col < N) {
        a.dBv[(((long long)grp * a.Bsz + b) * a.S + s0 + j) * N + n0 + col] = acc[n][e];
      }
    }
}

// bf16 kernel 2.  Roles, per (b, c) and group of heads: the tile pairs (J,
// I), I >= J, then (J, 64 columns of N).
template <int PT>
__global__ void __launch_bounds__(HT) ssd_bwd_heads_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_pairs = a.nqt * (a.nqt + 1) / 2, n_roles = n_pairs + a.nqt * a.nnt;
  int role = blockIdx.x % n_roles;
  const int grp = (blockIdx.x / n_roles) % HG;
  const long long bc = blockIdx.x / n_roles / HG;
  const int c = (int)(bc % a.nc), b = (int)(bc / a.nc);
  if (role < n_pairs) {
    int it = 0;
    while (role > it) role -= ++it;
    heads_role<PT, true>(a, smem_raw, b, c, grp, role * TB, it * TB, 0);
  } else {
    role -= n_pairs;
    const int jt = role / a.nnt;
    heads_role<PT, false>(a, smem_raw, b, c, grp, jt * TB, 0, (role - jt * a.nnt) * NC);
  }
}

// bf16 kernel 3.  Roles, per (b, c): (tile I, 64 columns of N) for dC_I =
// sum_{J <= I} dCB_IJ B_J, then (tile J, 64 columns) for dB_J = the chunk
// state's share + sum_{I >= J} dCB_IJ^T C_I; dCB and that share summed over
// the head groups in order.  dCB (f32) split in three, B and C exact.
__global__ void __launch_bounds__(MT) ssd_bwd_bc_mma_kernel(BwdArgs a) {
  const int Q = a.Q, N = a.N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ts = reinterpret_cast<float*>(smem_raw);           // HG x TB x LF: dCB^T, per group
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(Ts + HG * TB * LF);    // TB x LC: B or C
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int per = a.nqt * a.nnt;
  int role = blockIdx.x % (2 * per);
  const long long bc = blockIdx.x / (2 * per);
  const int c = (int)(bc % a.nc), b = (int)(bc / a.nc);
  const bool dc = role < per;
  if (!dc) role -= per;
  const int u = role / a.nnt, n0 = (role - u * a.nnt) * NC, u0 = u * TB;
  const long long s0 = (long long)c * Q;
  const float* dcb = a.dcbt + bc * HG * Q * Q;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(dc ? a.Bm : a.Cm) +
                            b * (dc ? a.sbb : a.scb) + s0 * (dc ? a.sbs : a.scs) + n0;
  const long long os = dc ? a.sbs : a.scs;
  const bool vcb = Q % 4 == 0;
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int v_lo = dc ? 0 : u, v_hi = dc ? u : a.nqt - 1;
  for (int v = v_lo; v <= v_hi; ++v) {
    const int v0 = v * TB;
    __syncthreads();          // the last tiles are read
    for (int gr = 0; gr < HG; ++gr) {
      if (dc)                 // dCB^T_JI with J = v, I = u
        load_f32(Ts + gr * TB * LF, LF, dcb + gr * Q * Q + (long long)v0 * Q + u0, Q, TB, Q - v0,
                 TB, Q - u0, vcb, MT);
      else                    // J = u, I = v
        load_f32(Ts + gr * TB * LF, LF, dcb + gr * Q * Q + (long long)u0 * Q + v0, Q, TB, Q - u0,
                 TB, Q - v0, vcb, MT);
    }
    mma::load_tile(Os, LC, og + (long long)v0 * os, os, TB, Q - v0, min(NC, N - n0), NC, a.vbc,
                   tid, MT);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int ks = 0; ks < TB / 16; ++ks) {
      // A (rows: this warp's 16 of u, k: 16 of v): dCB_IJ for dC, dCB^T_JI for dB
      float av[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = warp * 16 + g + 8 * (q & 1), kk = ks * 16 + 2 * t4 + 8 * (q >> 1);
        av[q][0] = av[q][1] = 0.f;
#pragma unroll
        for (int gr = 0; gr < HG; ++gr) {     // dCB summed over the groups, in order
          const float* T = Ts + gr * TB * LF;
          if (dc) {
            av[q][0] += T[kk * LF + row];
            av[q][1] += T[(kk + 1) * LF + row];
          } else {
            const float2 t = *reinterpret_cast<const float2*>(T + row * LF + kk);
            av[q][0] += t.x;
            av[q][1] += t.y;
          }
        }
      }
      uint32_t ap[3][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) mma::split3_bf16(av[q][0], av[q][1], ap[0][q], ap[1][q], ap[2][q]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, Os + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LC +
                                       np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          mma::mma_bf16(acc[2 * np], ap[p], bf[0], bf[1]);
          mma::mma_bf16(acc[2 * np + 1], ap[p], bf[2], bf[3]);
        }
      }
    }
  }
  float* out = (dc ? a.dC : a.dB) + ((long long)b * a.S + s0) * N;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = u0 + warp * 16 + g + 8 * (e >> 1), col = n0 + n * 8 + 2 * t4 + (e & 1);
      if (row >= Q || col >= N) continue;
      float sv = 0.f;         // dB: the chunk state's share, summed over the groups
      if (!dc)
        for (int gr = 0; gr < HG; ++gr)
          sv += a.dBv[(((long long)gr * a.Bsz + b) * a.S + s0 + row) * N + col];
      out[(long long)row * N + col] = dc ? acc[n][e] : sv + acc[n][e];
    }
}

// --------------------------------------------------- bf16, wgmma + TMA ---
//
// The wgmma route (see the top): kernels 1 and 2 of the bf16 path on
// Hopper's wgmma, one warpgroup a block, their tiles by TMA.  Kernels 0, 3
// and 4 are the mma.sync route's.

namespace wgb {

constexpr int T = 128;                          // one warpgroup
constexpr int PANEL = hopper::PANEL_BYTES;      // 64 rows x 64 bf16, swizzled
constexpr int BOX = 64 * 64 * 4;                // a 64 x 64 f32 box, row-major
constexpr int STAGES = 2;                       // kernel 2: heads in flight

// kernel 2's DCB roles: (I, the J tiles 2m, 2m + 1) for 2m <= I
__host__ __device__ inline int heads_dcb_roles(int nqt) {
  int n = 0;
  for (int it = 0; it < nqt; ++it) n += it / 2 + 1;
  return n;
}

__host__ __device__ inline size_t up1024(size_t n) { return (n + 1023) & ~(size_t)1023; }

// Rows [0, rows) of a row-major f32 tile of 64 floats a row (`src`) split
// into three bf16 parts, each a 128-byte-swizzled panel of `rows` rows,
// `part` bytes apart.
__device__ __forceinline__ void split_box(unsigned char* dst, int part, const float* src,
                                          int rows) {
  for (int e = threadIdx.x; e < rows * 32; e += T) {
    const int r = e >> 5, c = (e & 31) * 2;
    const float2 v = *reinterpret_cast<const float2*>(src + r * 64 + c);
    const int off = hopper::sw128(r, c >> 3) + (c & 7) * 2;
    uint32_t hi, mid, lo;
    mma::split3_bf16(v.x, v.y, hi, mid, lo);
    *reinterpret_cast<uint32_t*>(dst + off) = hi;
    *reinterpret_cast<uint32_t*>(dst + part + off) = mid;
    *reinterpret_cast<uint32_t*>(dst + 2 * part + off) = lo;
  }
}

// Shared memory of kernel 1 at head dim P (offsets from a 1024-byte aligned
// base): x_J and x_{J+1}, B_J (TMA brings J + 1's tiles once U_J is
// formed); a region that holds a split 64-column slab of dS while U forms,
// then dy_I split in three; the next dy tile (f32), which TMA brings while
// the current one is multiplied; the head's vectors; the mbarriers.
struct ChunkWgLayout {
  int npn;
  size_t bs, reg, raw, vec, bars, total;
  __host__ __device__ ChunkWgLayout(int Q, int n_pad, int P) {
    const int NP = P / 64;
    npn = (n_pad + 63) / 64;
    bs = (size_t)2 * NP * PANEL;
    reg = bs + (size_t)npn * PANEL;
    raw = reg + (size_t)3 * NP * PANEL;   // 3 parts of P x 64 or of 64 x P
    vec = raw + (size_t)NP * BOX;
    bars = vec + align16((size_t)Q * 8 * 4 + 4 * 8 + 4 * 64 * 8 + (size_t)Q * 4 * 3 + 64 * 4);
    total = bars + 3 * 8 + 1024;
  }
};

// bf16 kernel 1 on wgmma, a block per (b, c, h).  Warp w owns rows j0 + 16w
// .. +15 of each tile J in the wgmma accumulator layouts.  Per tile J:
// U_J = B_J dS^T (B_J exact from TMA as A, dS split in three, a 64-column
// slab at a time, as B); dw_J and dx_J = w_J U_J; then per tile I >= J
// (dy_I by TMA, a tile ahead, split in three): G^T = x_J dy_I^T, M^T = CB^T
// e dt and the f64 sums as the mma.sync kernel forms them, and dx_J += M^T
// dy_I with M^T (hi, mid) as the register A operand and dy_I's parts read
// MN-major from the same tiles.  Then dcum, dla, ddt and dA's share.
template <int P>
__global__ void __launch_bounds__(T)
ssd_bwd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap b_map,
                           const __grid_constant__ CUtensorMap dy_map, BwdArgs a) {
  constexpr int NP = P / 64, YP = NP * PANEL;   // one part of dy_I
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = hopper::align1024(smem_wg);
  const int Q = a.Q, N = a.N, H = a.H, nqt = a.nqt;
  const ChunkWgLayout L(Q, a.n_pad, P);
  unsigned char* Bs = smem + L.bs;
  unsigned char* Ds = smem + L.reg;             // 3 parts of P x 64
  unsigned char* Ys = smem + L.reg;             // 3 parts of 64 x P
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  double* cum = reinterpret_cast<double*>(smem + L.vec);
  double* rs = cum + Q;       // sum_j G_ij M_ij (rows i), then dcum and dla
  double* cs = rs + Q;        // sum_i G_ij M_ij (columns j)
  double* ts = cs + Q;        // sum_i G_ij CB_ij e_ij (columns j)
  double* wtot = ts + Q;      // 4
  double* rsw = wtot + 4;     // 4 x 64: each warp's share of rs for tile I
  float* dts = reinterpret_cast<float*>(rsw + 4 * 64);
  float* ws = dts + Q;
  float* dws = ws + Q;
  float* fcs = dws + Q;       // 64: exp(cum_i - cr) over tile I
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bars);   // 2: J's parity
  uint64_t* dybar = xbar + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Chunk k = chunk_of(a);
  const long long bc = (long long)k.b * a.nc + k.c;
  const int s0 = (int)k.s0;
  if (tid == 0) {
    hopper::mbar_init(&xbar[0], 1);
    hopper::mbar_init(&xbar[1], 1);
    hopper::mbar_init(dybar, 1);
    hopper::mbar_fence_init();
  }
  // x_J into the buffer of J's parity and B_J, on that parity's barrier
  auto issue_xb = [&](int jt) {
    uint64_t* bar = &xbar[jt & 1];
    hopper::mbar_expect_tx(bar, (NP + L.npn) * PANEL);
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_4d(smem + ((jt & 1) * NP + p) * PANEL, &x_map, bar, 64 * p, k.h,
                          (int)k.s0 + jt * 64, k.b);
    for (int p = 0; p < L.npn; ++p)
      hopper::tma_load_3d(Bs + p * PANEL, &b_map, bar, 64 * p, (int)k.s0 + jt * 64, k.b);
  };
  // dy tiles in the order they are used: (J, I) for J = 0 .. and I = J ..
  int n_jt = 0, n_it = 0;                       // thread 0's next tile
  auto issue_dy = [&]() {
    if (n_jt >= nqt) return;
    hopper::mbar_expect_tx(dybar, NP * BOX);
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_4d(raw + p * 64 * 64, &dy_map, dybar, 64 * p, k.h, s0 + n_it * 64, k.b);
    if (++n_it == nqt) n_it = ++n_jt;
  };
  const float* dtg = a.dt + ((long long)k.b * a.S + k.s0) * H + k.h;
  for (int t = tid; t < Q; t += T) dts[t] = dtg[(long long)t * H];
  __syncthreads();
  if (tid == 0) {
    issue_xb(0);
    issue_dy();
  }
  block_cum(dts, a.A[k.h], Q, cum, wtot);
  const double c_last = cum[Q - 1];
  const long long bhs = ((long long)k.b * H + k.h) * a.S + k.s0;
  for (int t = tid; t < Q; t += T) {
    ws[t] = expf((float)(c_last - cum[t])) * dts[t];
    rs[t] = 0.0;
    a.cumg[bhs + t] = cum[t];
    a.wg[bhs + t] = ws[t];
    a.dtT[bhs + t] = dts[t];
    // kernel 2's column factor below the diagonal tile: exp(cr - cum_j)
    // dt_j, cr = cum at the last row of j's tile
    a.gcol[bhs + t] = expf((float)(cum[t | 63] - cum[t])) * dts[t];
  }
  const float* dsg = a.dst + k.bhc * P * N;
  const float* cbg = a.cbt + bc * Q * Q;

  // dS's 64-column slab sl, this thread's float pairs (rows e / 32 of the
  // pairs e = tid, tid + T, ...), loaded a slab ahead of its split at P =
  // 64 (at P = 128, where dx takes 64 registers, just before it); N is a
  // multiple of 16, so a pair is in range or not as a whole
  constexpr int DSV = P * 32 / T;
  constexpr bool DS_AHEAD = P == 64;
  float2 dsv[DSV];
  auto load_ds = [&](int sl) {
#pragma unroll
    for (int v = 0; v < DSV; ++v) {
      const int e = tid + v * T, n = 64 * sl + (e & 31) * 2;
      dsv[v] = n < N ? *reinterpret_cast<const float2*>(dsg + (long long)(e >> 5) * N + n)
                     : make_float2(0.f, 0.f);
    }
  };

  int q = 0;                                    // the next dy tile to use
  for (int jt = 0; jt < nqt; ++jt) {
    const int j0 = jt * 64, wj = j0 + 16 * warp;   // wj: this warp's first row
    const unsigned char* Xs = smem + (jt & 1) * NP * PANEL;
    if (DS_AHEAD) load_ds(0);
    __syncthreads();          // the region is free; ws, rs written
    // U_J = B_J dS^T, dS split in three, 64 columns of N a pass
    float dx[P / 2];
#pragma unroll
    for (int e = 0; e < P / 2; ++e) dx[e] = 0.f;
    for (int sl = 0; sl < L.npn; ++sl) {
      if (sl > 0) __syncthreads();              // the last slab's parts are read
      if (!DS_AHEAD) load_ds(sl);
#pragma unroll
      for (int v = 0; v < DSV; ++v) {
        const int e = tid + v * T, r = e >> 5, cl = (e & 31) * 2;
        const int off = hopper::sw128(r, cl >> 3) + (cl & 7) * 2;
        uint32_t hi, mid, lo;
        mma::split3_bf16(dsv[v].x, dsv[v].y, hi, mid, lo);
        *reinterpret_cast<uint32_t*>(Ds + off) = hi;
        *reinterpret_cast<uint32_t*>(Ds + P * 128 + off) = mid;
        *reinterpret_cast<uint32_t*>(Ds + 2 * P * 128 + off) = lo;
      }
      if (DS_AHEAD && sl + 1 < L.npn) load_ds(sl + 1);   // under this slab's products
      hopper::fence_proxy_async();
      __syncthreads();
      if (sl == 0) hopper::mbar_wait(&xbar[jt & 1], (jt >> 1) & 1);
      hopper::fence_regs(dx);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int u = 0; u < 3; ++u)
          hopper::wgmma_ss<P, 0>(dx, hopper::desc_kmajor(Bs, 4 * sl + kk),
                                 hopper::desc_kmajor(Ds + u * P * 128, kk, P * 128), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dx);
    }
    // B_J is read (and x_{J-1}'s buffer too): TMA brings J + 1's tiles
    __syncthreads();
    if (tid == 0 && jt + 1 < nqt) issue_xb(jt + 1);
    // dw_j = x_j . U_j; dx_j starts as w_j U_j
    float dwp[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 8 * n + 2 * t4;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            Xs + (p >> 6) * PANEL + hopper::sw128(16 * warp + g + 8 * r, (p & 63) >> 3) + (p & 7) * 2));
        dwp[r] += xv.x * dx[4 * n + 2 * r] + xv.y * dx[4 * n + 2 * r + 1];
      }
    double cj[2];
    float dj[2], wr[2], fr[2];
    const double cr = cum[j0 + 63];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dwp[r] += __shfl_xor_sync(0xffffffffu, dwp[r], 1);
      dwp[r] += __shfl_xor_sync(0xffffffffu, dwp[r], 2);
      const int j = wj + g + 8 * r;
      if (t4 == 0) dws[j] = dwp[r];
      cj[r] = cum[j];
      dj[r] = dts[j];
      wr[r] = ws[j];
      // below the tile J, exp(cum_i - cum_j) = exp(cum_i - cr) exp(cr - cum_j)
      // with cr = cum at J's last row: both factors at most 1 (cum falls)
      fr[r] = expf((float)(cr - cj[r]));
    }
#pragma unroll
    for (int e = 0; e < P / 2; ++e) dx[e] *= wr[(e >> 1) & 1];

    double csl[2] = {0.0, 0.0}, tsl[2] = {0.0, 0.0};
    for (int it = jt; it < nqt; ++it, ++q) {
      const int i0 = it * 64;
      const bool diag = it == jt;
      if (it > jt && tid < 64)                  // the last tile's rs, in order
        rs[i0 - 64 + tid] += ((rsw[tid] + rsw[64 + tid]) + rsw[128 + tid]) + rsw[192 + tid];
      // CB^T_ji from the scratch (L2), in flight while dy_I is split
      float ce[32];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              cbg + (long long)(wj + g + 8 * r) * Q + i0 + 8 * n + 2 * t4);
          ce[4 * n + 2 * r] = v.x;
          ce[4 * n + 2 * r + 1] = v.y;
        }
      hopper::mbar_wait(dybar, q & 1);
      for (int p = 0; p < NP; ++p) split_box(Ys + p * PANEL, YP, raw + p * 64 * 64, 64);
      if (!diag && tid < 64) fcs[tid] = expf((float)(cum[i0 + tid] - cr));
      hopper::fence_proxy_async();
      __syncthreads();        // dy_I's parts, fcs and rs ready; the f32 slot is free
      if (tid == 0) issue_dy();
      // G^T (rows j, columns i) = x_J dy_I^T, dy in three parts
      float ga[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) ga[e] = 0.f;
      hopper::fence_regs(ga);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
        for (int u = 0; u < 3; ++u)
          hopper::wgmma_ss<64, 0>(ga, hopper::desc_kmajor(Xs, ks),
                                  hopper::desc_kmajor(Ys + u * YP, ks), 1);
      hopper::wgmma_commit();
      // while G forms: M^T = CB^T e dt, which G does not enter, and dx_J +=
      // M^T dy_I.  Entries 8 kk + e8: row j = wj + g + 8 ((e8 >> 1) & 1),
      // column i = i0 + 16 kk + 8 (e8 >> 2) + 2 t4 + (e8 & 1); ce holds CB^T
      // e, and M^T is ce dt_j, formed again where the sums need it
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float mv[8];
#pragma unroll
        for (int e8 = 0; e8 < 8; ++e8) {
          const int e = 8 * kk + e8, r = (e8 >> 1) & 1;
          const int il = 16 * kk + 8 * (e8 >> 2) + 2 * t4 + (e8 & 1);
          // e = exp(cum_i - cum_j) where j <= i, 0 elsewhere: on the diagonal
          // tile a select (above the diagonal the exp is inf), below it the
          // product of the two factors
          float ev;
          if (diag) {
            const float ex = expf((float)(cum[i0 + il] - cj[r]));
            ev = wj + g + 8 * r <= i0 + il ? ex : 0.f;
          } else {
            ev = fcs[il] * fr[r];
          }
          ce[e] *= ev;
          mv[e8] = ce[e] * dj[r];
        }
        uint32_t ma[2][4];    // M^T as hi + mid, A layout
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          uint32_t lo;
          mma::split3_bf16(mv[2 * f], mv[2 * f + 1], ma[0][f], ma[1][f], lo);
        }
        hopper::fence_regs(ma[0]);
        hopper::fence_regs(ma[1]);
        hopper::fence_regs(dx);
        hopper::wgmma_fence();
        // dx_J += M^T dy_I: hi hi + hi mid + mid hi (about 2^-17: dx is
        // rounded to bf16)
        hopper::wgmma_rs<P, 1>(dx, ma[0], hopper::desc_mnmajor(Ys, kk), 1);
        hopper::wgmma_rs<P, 1>(dx, ma[0], hopper::desc_mnmajor(Ys + YP, kk), 1);
        hopper::wgmma_rs<P, 1>(dx, ma[1], hopper::desc_mnmajor(Ys, kk), 1);
        if constexpr (P > 64) {
          // at P = 128 (dx 64 registers a thread) one k-step's A operand
          // at a time: the products are waited for before the next is formed
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dx);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();                  // G has landed; dx runs on
      hopper::fence_regs(ga);
      // the sums over the same f32 values, in f64, while dx forms
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        double colp[4] = {0.0, 0.0, 0.0, 0.0};   // column sums of G o M, for rs
#pragma unroll
        for (int e8 = 0; e8 < 8; ++e8) {
          const int e = 8 * kk + e8, r = (e8 >> 1) & 1;
          const float gm = ga[e] * (ce[e] * dj[r]), gt = ga[e] * ce[e];
          csl[r] += (double)gm;
          tsl[r] += (double)gt;
          colp[2 * (e8 >> 2) + (e8 & 1)] += (double)gm;
        }
        // the warp's 16 rows summed per column (over g), in f64
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            colp[x] += __shfl_xor_sync(0xffffffffu, colp[x], off);
          if (g == 0) rsw[warp * 64 + 16 * kk + 8 * (x >> 1) + 2 * t4 + (x & 1)] = colp[x];
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dx);
      __syncthreads();        // dy_I's parts are read; rsw written
    }
    if (tid < 64)             // the last tile's rs
      rs[(nqt - 1) * 64 + tid] += ((rsw[tid] + rsw[64 + tid]) + rsw[128 + tid]) + rsw[192 + tid];
    // cs, ts for this warp's rows (over t4); dx_J, rounded once to bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        csl[r] += __shfl_xor_sync(0xffffffffu, csl[r], off);
        tsl[r] += __shfl_xor_sync(0xffffffffu, tsl[r], off);
      }
      const int j = wj + g + 8 * r;
      if (t4 == 0) {
        cs[j] = csl[r];
        ts[j] = tsl[r];
      }
      __nv_bfloat16* dxr = static_cast<__nv_bfloat16*>(a.dx) +
                           (((long long)k.b * a.S + k.s0 + j) * H + k.h) * P + 2 * t4;
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dxr + 8 * n) =
            __floats2bfloat162_rn(dx[4 * n + 2 * r], dx[4 * n + 2 * r + 1]);
    }
  }
  __syncthreads();            // rs, cs, ts, dws complete

  // dcum (into rs), its reverse cumsum dla, this (b, c, h)'s share of dA,
  // ddt; block-wide in f64, each sum in a fixed order
  const float* dda = a.ddall + k.bhc * Q;
  double sdw = 0.0;
  for (int t = tid; t < Q; t += T) sdw += (double)dws[t] * (double)ws[t];
  const double last = (double)a.ddch[k.bhc] * (double)expf((float)c_last) + block_sum(sdw, wtot);
  for (int t = tid; t < Q; t += T) {
    double d = rs[t] - cs[t] - (double)dws[t] * (double)ws[t] +
               (double)dda[t] * (double)expf((float)cum[t]);
    if (t == Q - 1) d += last;
    rs[t] = d;
  }
  __syncthreads();
  block_suffix_sum(rs, Q, wtot);
  double sda = 0.0;
  for (int t = tid; t < Q; t += T) sda += (double)dts[t] * rs[t];
  const double dA = block_sum(sda, wtot);
  if (tid == 0) a.dA_part[bc * H + k.h] = dA;
  const double Ah = (double)a.A[k.h];
  for (int t = tid; t < Q; t += T)
    a.ddt[((long long)k.b * a.S + k.s0 + t) * H + k.h] =
        (float)(ts[t] + (double)dws[t] * (double)expf((float)(c_last - cum[t])) + Ah * rs[t]);
}

// Shared memory of kernel 2 at head dim P: STAGES stages, each x_J of two
// J tiles, the f32 operand by TMA in 128-byte-swizzled boxes of 32 floats
// a row (dy_I: P / 32 boxes of 64 rows; dS's slab: 2 boxes of P rows) and
// the vectors (cum over I and over the J tiles in f64, dt and the column
// factors over the J tiles; or w over them); then the stages' mbarriers
// and counts.
struct HeadsWgLayout {
  size_t raw, vec, stage, bars, cnt, total;
  __host__ __device__ explicit HeadsWgLayout(int P) {
    const int NP = P / 64;
    raw = (size_t)2 * NP * PANEL;
    vec = raw + (size_t)NP * BOX;
    stage = up1024(vec + VEC_BYTES);
    bars = STAGES * stage;
    cnt = bars + STAGES * 8;
    total = cnt + STAGES * 4 + 1024;
  }
  // vectors of a stage (bytes from vec): cum over I, then over J0 and J1
  // (f64); dt over J0, J1; the column factors over J0, J1 (f32).  The
  // V roles: w over J0, J1 (f32) from the start
  static constexpr int VEC_BYTES = 3 * 64 * 8 + 4 * 64 * 4;
};

// One role of bf16 kernel 2 on wgmma over the heads of group grp, for two
// J tiles j0 and j0 + 64 (the second out of the chunk, or above the
// diagonal, adds nothing).  DCB: the tile pairs (J, I), summing dCB^T_JI =
// sum_h G^T e dt; else (J, the 64 columns of N from n0), summing dB's
// share sum_h w_J (x_J dS).  Per head the f32 operand is split in three
// once, in the registers, as wgmma's A operand, and multiplied with both
// x_J^T (exact, TMA) as its B operand: G = dy_I x_J^T (rows i, columns j),
// or V^T = dS^T x_J^T (rows n, columns j); the sums over the group's heads
// in order in the registers, stored transposed.  A stage is refilled by
// the last warp done with it; no barrier per head.
template <int P, bool DCB>
__device__ __forceinline__ void heads_wg_role(const BwdArgs& a, const CUtensorMap* xm,
                                              const CUtensorMap* om, unsigned char* smem, int b,
                                              int c, int grp, int j0, int i0, int n0) {
  constexpr int NP = P / 64;
  const HeadsWgLayout L(P);
  const int Q = a.Q, N = a.N, H = a.H;
  const int hn = (H + HG - 1) / HG, hb = grp * hn, nh = max(0, min(hn, H - hb));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint32_t* done = reinterpret_cast<uint32_t*>(smem + L.cnt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = c * Q;
  const long long bc = (long long)b * a.nc + c;
  // the J tiles' rows, the second clamped into the chunk for its loads
  const int jr[2] = {j0, min(j0 + 64, Q - 64)};
  const uint32_t vbytes = DCB ? 3 * 64 * 8 + 4 * 64 * 4 : 2 * 64 * 4;

  auto issue = [&](int kl) {
    const int h = hb + kl;
    unsigned char* st = smem + (kl % STAGES) * L.stage;
    uint64_t* bar = &full[kl % STAGES];
    hopper::mbar_expect_tx(bar, 2 * NP * PANEL + NP * BOX + vbytes);
    for (int t = 0; t < 2; ++t)
      for (int p = 0; p < NP; ++p)
        hopper::tma_load_4d(st + (t * NP + p) * PANEL, xm, bar, 64 * p, h, s0 + jr[t], b);
    unsigned char* raw = st + L.raw;
    unsigned char* vec = st + L.vec;
    const long long bhs = ((long long)b * H + h) * a.S + s0;
    if (DCB) {
      for (int q = 0; q < P / 32; ++q)
        hopper::tma_load_4d(raw + q * 64 * 128, om, bar, 32 * q, h, s0 + i0, b);
      hopper::bulk_load(vec, a.cumg + bhs + i0, 64 * 8, bar);
      for (int t = 0; t < 2; ++t) {
        hopper::bulk_load(vec + (1 + t) * 64 * 8, a.cumg + bhs + jr[t], 64 * 8, bar);
        hopper::bulk_load(vec + 3 * 64 * 8 + t * 64 * 4, a.dtT + bhs + jr[t], 64 * 4, bar);
        hopper::bulk_load(vec + 3 * 64 * 8 + (2 + t) * 64 * 4, a.gcol + bhs + jr[t], 64 * 4,
                          bar);
      }
    } else {
      for (int q = 0; q < 2; ++q)
        hopper::tma_load_3d(raw + q * P * 128, om, bar, n0 + 32 * q, 0,
                            (int)(((long long)b * H + h) * a.nc + c));
      for (int t = 0; t < 2; ++t)
        hopper::bulk_load(vec + t * 64 * 4, a.wg + bhs + jr[t], 64 * 4, bar);
    }
  };
  if (tid == 0)
    for (int kl = 0; kl < nh && kl < STAGES; ++kl) issue(kl);

  float acc[2][32];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;
  for (int kl = 0; kl < nh; ++kl) {
    const unsigned char* st = smem + (kl % STAGES) * L.stage;
    hopper::mbar_wait(&full[kl % STAGES], (kl / STAGES) & 1);
    const unsigned char* raw = st + L.raw;
    const unsigned char* vec = st + L.vec;
    // the f32 operand's A fragments (rows 16 warp + g (+ 8), columns p of
    // k-step ks), split in three
    uint32_t pa[P / 16][3][4];
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = 16 * warp + g + 8 * (f & 1), p = 16 * ks + 2 * t4 + 8 * (f >> 1);
        float v0, v1;
        if (DCB) {            // dy_I[row][p .. p+1], box p / 32
          const int cc = p & 31;
          const float2 v = *reinterpret_cast<const float2*>(
              raw + (p >> 5) * 64 * 128 + row * 128 + (((cc >> 2) ^ (row & 7)) << 4) + (cc & 3) * 4);
          v0 = v.x;
          v1 = v.y;
        } else {              // dS[p .. p+1][row], box row / 32
          const int cc = row & 31;
          const unsigned char* bx = raw + (row >> 5) * P * 128 + (cc & 3) * 4;
          v0 = *reinterpret_cast<const float*>(bx + p * 128 + (((cc >> 2) ^ (p & 7)) << 4));
          v1 = *reinterpret_cast<const float*>(bx + (p + 1) * 128 + (((cc >> 2) ^ ((p + 1) & 7)) << 4));
        }
        mma::split3_bf16(v0, v1, pa[ks][0][f], pa[ks][1][f], pa[ks][2][f]);
      }
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
      for (int u = 0; u < 3; ++u) hopper::fence_regs(pa[ks][u]);
    const double* cI = reinterpret_cast<const double*>(vec);
    // tile t's product into pr, committed as a group of its own
    auto product = [&](float (&pr)[32], int t) {
      const unsigned char* Xt = st + t * NP * PANEL;
#pragma unroll
      for (int e = 0; e < 32; ++e) pr[e] = 0.f;
      hopper::fence_regs(pr);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
        for (int u = 0; u < 3; ++u)
          hopper::wgmma_rs<64, 0>(pr, pa[ks][u], hopper::desc_kmajor(Xt, ks), 1);
      hopper::wgmma_commit();
    };
    // tile t's product, landed in pr, into its sum over the heads
    auto sums = [&](float (&pr)[32], float (&ac)[32], int t) {
      hopper::fence_regs(pr);
      const int jt0 = j0 + 64 * t;              // the tile's first row, unclamped
      if (DCB) {
        const double* cJ = cI + 64 * (1 + t);
        const float* dJ = reinterpret_cast<const float*>(cI + 3 * 64) + 64 * t;
        const float* gJ = dJ + 128;
        if (i0 > jt0) {       // dCB^T += G e dt_j: the two factors below the diagonal
          // e dt = exp(cum_i - cr) exp(cr - cum_j) dt_j with cr = cum at
          // J's last row: both factors at most 1
          float fr[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) fr[r] = expf((float)(cI[16 * warp + g + 8 * r] - cJ[63]));
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = 8 * (e >> 2) + 2 * t4 + (e & 1);
            ac[e] = fmaf(pr[e], fr[(e >> 1) & 1] * gJ[col], ac[e]);
          }
        } else {              // on the diagonal tile a select (above it the exp is
                              // inf); above the diagonal nothing
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int il = 16 * warp + g + 8 * ((e >> 1) & 1), jl = 8 * (e >> 2) + 2 * t4 + (e & 1);
            const float ex = pr[e] * expf((float)(cI[il] - cJ[jl])) * dJ[jl];
            ac[e] += jt0 + jl <= i0 + il ? ex : 0.f;
          }
        }
      } else {                // dB_J^T += w_J V^T
        const float* wJ = reinterpret_cast<const float*>(vec) + 64 * t;
#pragma unroll
        for (int e = 0; e < 32; ++e) ac[e] += wJ[8 * (e >> 2) + 2 * t4 + (e & 1)] * pr[e];
      }
    };
    float pr0[32], pr1[32];
    if constexpr (P == 64) {  // tile 1's product runs under tile 0's sums
      product(pr0, 0);
      product(pr1, 1);
      hopper::wgmma_wait<1>();
      sums(pr0, acc[0], 0);
      hopper::wgmma_wait<0>();
      sums(pr1, acc[1], 1);
    } else {                  // at P = 128 (A operand 96 registers) in turn
      product(pr0, 0);
      hopper::wgmma_wait<0>();
      sums(pr0, acc[0], 0);
      product(pr1, 1);
      hopper::wgmma_wait<0>();
      sums(pr1, acc[1], 1);
    }
    if (lane == 0 && hopper::count_out(&done[kl % STAGES], 4 * (kl / STAGES + 1)) &&
        kl + STAGES < nh)
      issue(kl + STAGES);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int jt0 = j0 + 64 * t;
    if (jt0 >= Q || (DCB && jt0 > i0)) continue;    // out of the chunk; above the diagonal
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int row = 16 * warp + g + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * t4 + (e & 1);
      if (DCB)
        a.dcbt[(bc * HG + grp) * Q * Q + (long long)(jt0 + col) * Q + i0 + row] = acc[t][e];
      else if (n0 + row < N)
        a.dBv[(((long long)grp * a.Bsz + b) * a.S + s0 + jt0 + col) * N + n0 + row] = acc[t][e];
    }
  }
}

// bf16 kernel 2 on wgmma.  Roles, per (b, c) and group of heads: (I, the J
// tiles 2m and 2m + 1) for 2m <= I, then (the J tiles 2m and 2m + 1, 64
// columns of N).
template <int P>
__global__ void __launch_bounds__(T, P == 64 ? 2 : 1)
ssd_bwd_heads_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap dy_map,
                           const __grid_constant__ CUtensorMap ds_map, BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = hopper::align1024(smem_wg);
  const HeadsWgLayout L(P);
  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint32_t* done = reinterpret_cast<uint32_t*>(smem + L.cnt);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bars[s], 1);
      done[s] = 0;
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int nq2 = (a.nqt + 1) / 2;                  // J tile pairs
  const int n_dcb = heads_dcb_roles(a.nqt), n_roles = n_dcb + nq2 * a.nnt;
  int role = blockIdx.x % n_roles;
  const int grp = (blockIdx.x / n_roles) % HG;
  const long long bc = blockIdx.x / n_roles / HG;
  const int c = (int)(bc % a.nc), b = (int)(bc / a.nc);
  if (role < n_dcb) {
    int it = 0;
    while (role >= it / 2 + 1) role -= it++ / 2 + 1;
    heads_wg_role<P, true>(a, &x_map, &dy_map, smem, b, c, grp, 128 * role, 64 * it, 0);
  } else {
    role -= n_dcb;
    const int m = role / a.nnt;
    heads_wg_role<P, false>(a, &x_map, &ds_map, smem, b, c, grp, 128 * m, 0,
                            (role - m * a.nnt) * NC);
  }
}

}  // namespace wgb

// grid of a grid-stride kernel over `work` items
unsigned stride_grid(long long work) {
  const long long grid = (work + THREADS - 1) / THREADS;
  return (unsigned)(grid < 4096 ? grid : 4096);
}

template <int PM, int NM>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)a.Bsz * a.nc * a.H;
  const long long blocks0 = (long long)a.Bsz * a.nc * (a.nt * (a.nt + 1) / 2);
  const long long blocks4 = (long long)a.Bsz * a.nc * 2 * a.nt;
  const size_t smem0 = cb_smem_bytes(a.N);
  const size_t smem4 = sizeof(float) * (size_t)TQ * (LT + a.N + 1);
  const size_t smem1 = state_smem_bytes(a.Q, a.P, a.N);
  const size_t smem2 = chunk_smem_bytes(a.Q, a.P);
  if (smem1 > 232448 || smem2 > 232448 || blocks > 0x7fffffffLL ||
      blocks0 > 0x7fffffffLL || blocks4 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto k1 = ssd_bwd_state_kernel<PM, NM>;
  auto k2 = ssd_bwd_chunk_kernel<PM>;
  auto k4 = ssd_bwd_bc_kernel<NM>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem0);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem4);
  if (err != cudaSuccess) return err;
  ssd_bwd_cb_kernel<<<(unsigned)blocks0, THREADS, smem0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k1<<<(unsigned)blocks, THREADS, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k2<<<(unsigned)blocks, THREADS, smem2, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned grid3 = stride_grid((long long)a.Bsz * a.nc * a.Q * a.Q);
  ssd_bwd_head_sum_kernel<<<grid3, THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k4<<<(unsigned)blocks4, THREADS, smem4, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned grid5 = stride_grid((long long)a.Bsz * a.S * a.N + a.H);
  ssd_bwd_reduce_kernel<<<grid5, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int PM>
cudaError_t dispatch_n(const BwdArgs& a, cudaStream_t stream) {
  switch ((a.N + 31) / 32) {
    case 1: return launch<PM, 1>(a, stream);
    case 2: return launch<PM, 2>(a, stream);
    case 3:
    case 4: return launch<PM, 4>(a, stream);
    case 5: case 6: case 7:
    case 8: return launch<PM, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int PT>
cudaError_t launch_mma(const BwdArgs& a, cudaStream_t stream) {
  const long long bcs = (long long)a.Bsz * a.nc;
  const long long n_pairs = a.nqt * (a.nqt + 1) / 2;
  const long long blocks0 = bcs * n_pairs, blocks1 = bcs * a.H;
  const long long blocks2 = bcs * HG * (n_pairs + (long long)a.nqt * a.nnt);
  const long long blocks3 = bcs * 2 * a.nqt * a.nnt;
  const size_t smem0 = (size_t)2 * TB * (a.n_pad + mma::PAD) * 2;
  const size_t smem1 = ChunkLayout(a.Q, PT * 16, a.n_pad).total;
  const size_t smem2 = HeadsLayout(PT * 16).total;
  const size_t smem3 = (size_t)HG * TB * LF * 4 + (size_t)TB * LC * 2;
  if (smem0 > 232448 || smem1 > 232448 || smem2 > 232448 || blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL ||
      blocks3 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto k1 = ssd_bwd_chunk_mma_kernel<PT>;
  auto k2 = ssd_bwd_heads_kernel<PT>;
  cudaError_t err;
  if ((err = set_smem((const void*)ssd_bwd_cb_mma_kernel, smem0)) != cudaSuccess) return err;
  if ((err = set_smem((const void*)k1, smem1)) != cudaSuccess) return err;
  if ((err = set_smem((const void*)k2, smem2)) != cudaSuccess) return err;
  if ((err = set_smem((const void*)ssd_bwd_bc_mma_kernel, smem3)) != cudaSuccess) return err;
  ssd_bwd_cb_mma_kernel<<<(unsigned)blocks0, MT, smem0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k1<<<(unsigned)blocks1, MT, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k2<<<(unsigned)blocks2, HT, smem2, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_bc_mma_kernel<<<(unsigned)blocks3, MT, smem3, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<<<stride_grid(a.H), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// the wgmma route at head dim P: kernels 0, 3 and 4 as the mma.sync
// route's, kernels 1 and 2 on wgmma with their TMA maps
template <int P>
cudaError_t launch_wgmma(const BwdArgs& a, cudaStream_t stream) {
  const long long bcs = (long long)a.Bsz * a.nc;
  const long long n_pairs = a.nqt * (a.nqt + 1) / 2;
  const long long blocks0 = bcs * n_pairs, blocks1 = bcs * a.H;
  const long long blocks2 =
      bcs * HG * (wgb::heads_dcb_roles(a.nqt) + (long long)(a.nqt + 1) / 2 * a.nnt);
  const long long blocks3 = bcs * 2 * a.nqt * a.nnt;
  const size_t smem0 = (size_t)2 * TB * (a.n_pad + mma::PAD) * 2;
  const size_t smem1 = wgb::ChunkWgLayout(a.Q, a.n_pad, P).total;
  const size_t smem2 = wgb::HeadsWgLayout(P).total;
  const size_t smem3 = (size_t)HG * TB * LF * 4 + (size_t)TB * LC * 2;
  if (smem0 > 232448 || smem1 > 232448 || smem2 > 232448 || blocks1 > 0x7fffffffLL ||
      blocks2 > 0x7fffffffLL || blocks3 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  CUtensorMap xm, bm, dym, dsm;
  const cuuint64_t dy_dims[4] = {(cuuint64_t)P, (cuuint64_t)a.H, (cuuint64_t)a.S,
                                 (cuuint64_t)a.Bsz};
  const cuuint64_t dy_strides[3] = {(cuuint64_t)P * 4, (cuuint64_t)a.H * P * 4,
                                    (cuuint64_t)a.S * a.H * P * 4};
  const cuuint32_t dy_box[4] = {64, 1, 64, 1};
  const cuuint64_t ds_dims[3] = {(cuuint64_t)a.N, (cuuint64_t)P,
                                 (cuuint64_t)a.Bsz * a.H * a.nc};
  const cuuint64_t ds_strides[2] = {(cuuint64_t)a.N * 4, (cuuint64_t)P * a.N * 4};
  const cuuint32_t ds_box[3] = {32, (cuuint32_t)P, 1};
  const cuuint32_t dy_box32[4] = {32, 1, 64, 1};
  CUtensorMap dym32;
  if (hopper::strided_bshd_map(&xm, a.x, a.Bsz, a.S, a.H, P, a.sxb, a.sxs) != CUDA_SUCCESS ||
      hopper::bsn_map(&bm, a.Bm, a.Bsz, a.S, a.N, a.sbb, a.sbs) != CUDA_SUCCESS ||
      hopper::f32_map(&dym, a.dy, 4, dy_dims, dy_strides, dy_box) != CUDA_SUCCESS ||
      hopper::f32_map(&dym32, a.dy, 4, dy_dims, dy_strides, dy_box32,
                      CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS ||
      hopper::f32_map(&dsm, a.dst, 3, ds_dims, ds_strides, ds_box,
                      CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto k1 = wgb::ssd_bwd_chunk_wgmma_kernel<P>;
  auto k2 = wgb::ssd_bwd_heads_wgmma_kernel<P>;
  cudaError_t err;
  if ((err = set_smem((const void*)ssd_bwd_cb_mma_kernel, smem0)) != cudaSuccess) return err;
  if ((err = set_smem((const void*)k1, smem1)) != cudaSuccess) return err;
  if ((err = set_smem((const void*)k2, smem2)) != cudaSuccess) return err;
  if ((err = set_smem((const void*)ssd_bwd_bc_mma_kernel, smem3)) != cudaSuccess) return err;
  ssd_bwd_cb_mma_kernel<<<(unsigned)blocks0, MT, smem0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k1<<<(unsigned)blocks1, wgb::T, smem1, stream>>>(xm, bm, dym, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  k2<<<(unsigned)blocks2, wgb::T, smem2, stream>>>(xm, dym32, dsm, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_bc_mma_kernel<<<(unsigned)blocks3, MT, smem3, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_kernel<<<stride_grid(a.H), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Carve the workspace at `base` into a's scratch (each piece 256-byte
// aligned); returns its size in bytes.  base may be null (sizes only).
size_t carve(BwdArgs& a, unsigned char* base) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  const size_t B = a.Bsz, S = a.S, H = a.H, P = a.P, N = a.N, Q = a.Q, nc = a.nc;
  a.dA_part = reinterpret_cast<double*>(take(B * nc * H * 8));
  if (a.bf16) {
    a.cbt = reinterpret_cast<float*>(take(B * nc * Q * Q * 4));
    a.dcbt = reinterpret_cast<float*>(take(B * nc * HG * Q * Q * 4));
    a.dBv = reinterpret_cast<float*>(take(HG * B * S * N * 4));
    a.cumg = reinterpret_cast<double*>(take(B * H * S * 8));
    a.wg = reinterpret_cast<float*>(take(B * H * S * 4));
    a.dtT = reinterpret_cast<float*>(take(B * H * S * 4));
    a.gcol = reinterpret_cast<float*>(take(B * H * S * 4));
  } else {
    a.dxs = reinterpret_cast<float*>(take(B * S * H * P * 4));
    a.dB_part = reinterpret_cast<float*>(take(H * B * S * N * 4));
    a.dcb = reinterpret_cast<float*>(take(B * nc * H * Q * Q * 4));
    a.dw = reinterpret_cast<float*>(take(B * H * S * 4));
    a.cb = reinterpret_cast<float*>(take(B * nc * Q * Q * 4));
    a.dcbs = reinterpret_cast<float*>(take(B * nc * Q * Q * 4));
  }
  return off;
}

bool valid(int Bsz, int S, int H, int P, int N, int Q, int dtype) {
  return Bsz > 0 && S > 0 && H > 0 && P > 0 && P <= 128 && N > 0 && N <= 256 && Q > 0 &&
         S % Q == 0 && (dtype == 0 || dtype == 1);
}

BwdArgs make_args(int Bsz, int S, int H, int P, int N, int Q, int dtype) {
  BwdArgs a{};
  a.Bsz = Bsz; a.S = S; a.H = H; a.P = P; a.N = N; a.Q = Q;
  a.nc = S / Q;
  a.nt = (Q + TQ - 1) / TQ;
  a.bf16 = dtype;
  a.n_pad = (N + 15) / 16 * 16;
  a.nqt = (Q + TB - 1) / TB;
  a.nnt = (N + NC - 1) / NC;
  return a;
}

}  // namespace

// Bytes of workspace ssd_chunk_bwd needs for these shapes (0 for shapes it
// does not take).
extern "C" long long ssd_chunk_bwd_workspace(int Bsz, int S, int H, int P, int N, int Q,
                                             int dtype) {
  if (!valid(Bsz, S, H, P, N, Q, dtype)) return 0;
  BwdArgs a = make_args(Bsz, S, H, P, N, Q, dtype);
  return (long long)carve(a, nullptr);
}

// The wgmma route takes bf16 at P = 64 or 128, N a multiple of 16 up to
// 256, Q a multiple of 64 up to 256, with x, B and C as TMA reads them
// (16-byte aligned bases, strides multiples of 8 elements); the wrapper
// (kernels/ssd.py::ssd_route) chooses it by the same rule, as for K2.
bool wgmma_shape(const BwdArgs& a) {
  return a.bf16 && (a.P == 64 || a.P == 128) && a.N % 16 == 0 && a.N <= 256 &&
         a.Q % 64 == 0 && a.Q <= 256 && aligned16(a.x) && aligned16(a.Bm) &&
         aligned16(a.Cm) && a.sxb % 8 == 0 && a.sxs % 8 == 0 && a.sbb % 8 == 0 &&
         a.sbs % 8 == 0 && a.scb % 8 == 0 && a.scs % 8 == 0;
}

// C entry bound with ctypes.  dtype of x, B and C: 0 = float32 (CUDA-core
// kernels), 1 = bfloat16 (tensor-core kernels); route (bf16 only): 0 =
// mma.sync, 1 = kernels 1 and 2 on wgmma + TMA.  Strides are in elements;
// `work` holds ssd_chunk_bwd_workspace bytes.  Launches the path's kernels
// (six for f32, five for bf16) on `stream` without synchronising and
// returns cudaGetLastError() (cudaErrorInvalidValue for shapes it does not
// take, before any launch).
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             const void* dst, const void* ddall, const void* ddch,
                             void* dx, void* ddt, void* dA, void* dB, void* dC, void* work,
                             int Bsz, int S, int H, int P, int N, int Q, int dtype, int route,
                             long long sxb, long long sxs, long long sbb,
                             long long sbs, long long scb, long long scs,
                             void* stream) {
  if (!valid(Bsz, S, H, P, N, Q, dtype) || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = make_args(Bsz, S, H, P, N, Q, dtype);
  a.x = x; a.dt = static_cast<const float*>(dt); a.A = static_cast<const float*>(A);
  a.Bm = B; a.Cm = C;
  a.dy = static_cast<const float*>(dy); a.dst = static_cast<const float*>(dst);
  a.ddall = static_cast<const float*>(ddall); a.ddch = static_cast<const float*>(ddch);
  a.dx = dx; a.ddt = static_cast<float*>(ddt); a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB); a.dC = static_cast<float*>(dC);
  a.sxb = sxb; a.sxs = sxs; a.sbb = sbb; a.sbs = sbs; a.scb = scb; a.scs = scs;
  carve(a, static_cast<unsigned char*>(work));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pt = (P + 15) / 16;
  if (dtype == 1) {
    a.vx = aligned16(x) && P % 8 == 0 && sxb % 8 == 0 && sxs % 8 == 0;
    a.vbc = aligned16(B) && aligned16(C) && N % 8 == 0 && sbb % 8 == 0 && sbs % 8 == 0 &&
            scb % 8 == 0 && scs % 8 == 0;
    if (route == 1) {
      if (!wgmma_shape(a)) return (int)cudaErrorInvalidValue;
      return (int)(P == 64 ? launch_wgmma<64>(a, s) : launch_wgmma<128>(a, s));
    }
    switch (pt) {
      case 1: return (int)launch_mma<1>(a, s);
      case 2: return (int)launch_mma<2>(a, s);
      case 3:
      case 4: return (int)launch_mma<4>(a, s);
      case 5: case 6: case 7:
      case 8: return (int)launch_mma<8>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch ((P + 31) / 32) {
    case 1: return (int)dispatch_n<1>(a, s);
    case 2: return (int)dispatch_n<2>(a, s);
    case 3:
    case 4: return (int)dispatch_n<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
