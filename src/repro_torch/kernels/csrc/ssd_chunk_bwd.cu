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
// Six kernels, launched in order on one stream by one call; no atomics,
// so the result is the same bit for bit from run to run:
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
// Products run in f32 FMA on the CUDA cores for both input types: x, B, C
// (f32 or bf16) are read as f32, and the cotangents are f32, so each
// product has an f32 operand that bf16 tensor cores would round (a
// three-part split on both sides, as K2 splits one, is later work).  dx is
// summed in f32 and rounded once to x's type as it is written.
//
// Layout.  x (B,S,H,P) is read in place through its batch and sequence
// strides (heads packed at stride P, elements at stride 1), and B, C (B,S,N)
// through theirs, as K2 reads the split views of the model's xBC.  dt
// (B,S,H), A (H,) and the cotangents dy (B,S,H,P), dS (B,H,nc,P,N), ddall
// (B,H,nc,Q), ddch (B,H,nc) are contiguous f32.  Outputs: dx (B,S,H,P) in
// x's type; ddt (B,S,H), dA (H,), dB, dC (B,S,N) f32.  Scratch from the
// caller, f32 but for dA_part: dxs (B,S,H,P), dB_part (H,B,S,N), dcb
// (B,nc,H,Q,Q), dA_part (B,nc,H) f64, dw (B,H,S), cb and dcbs (B,nc,Q,Q).
//
// Bound on this card.  At mamba2-1.3b's training shape (B=8, S=1024, H=64,
// P=64, N=128, Q=256, bf16 in) the function needs about 35 GFLOP (CB and
// dCB's two products once per (b, c), summed over heads) against about
// 0.35 GB moved: bound by bytes, about 0.11 ms.  These kernels write and
// read each head's dCB, its share of dB and the chunk state's share of dx
// (about 0.9 GB more), and run on the CUDA cores: the tensor cores, fusing
// the head sums and wgmma/TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Kernel 0.  Thread (ty2, tx2) = (tid / 16, tid % 16) forms rows ty2,
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

// Kernel 1.  Thread (ty, tx) = (tid / 32, tid % 32) owns rows ty + 8r of a
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

// Kernel 2.  Tiles (32 x 32): thread (ty2, tx2) = (tid / 16, tid % 16) forms
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

// Kernel 3: dCB summed over heads, in order, where j <= i (0 above).
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

// Kernel 4, a block per (b, c, u), u < nt or nt <= u < 2 nt: rows I = u of
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

// Kernel 5: dB += the chunk state's share summed over heads (f32, h in
// order); dA summed over (b, c) (f64).
__global__ void __launch_bounds__(THREADS) ssd_bwd_reduce_kernel(BwdArgs a) {
  const long long bsn = (long long)a.Bsz * a.S * a.N;
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

}  // namespace

// C entry bound with ctypes.  dtype of x, B and C: 0 = float32, 1 =
// bfloat16.  Strides are in elements.  Launches its six kernels on
// `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take, before any launch).
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             const void* dst, const void* ddall, const void* ddch,
                             void* dx, void* ddt, void* dA, void* dB, void* dC,
                             void* dxs, void* dB_part, void* dcb, void* dA_part, void* dw,
                             void* cb, void* dcbs, int Bsz, int S, int H, int P, int N, int Q, int dtype,
                             long long sxb, long long sxs, long long sbb,
                             long long sbs, long long scb, long long scs,
                             void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 128 || N <= 0 || N > 256 ||
      Q <= 0 || S % Q != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
            static_cast<const float*>(dy), static_cast<const float*>(dst),
            static_cast<const float*>(ddall), static_cast<const float*>(ddch),
            dx, static_cast<float*>(ddt), static_cast<float*>(dA),
            static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dxs),
            static_cast<float*>(dB_part), static_cast<float*>(dcb),
            static_cast<double*>(dA_part), static_cast<float*>(dw),
            static_cast<float*>(cb), static_cast<float*>(dcbs), Bsz, S, H, P, N, Q, S / Q, (Q + TQ - 1) / TQ, dtype,
            sxb, sxs, sbb, sbs, scb, scs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
