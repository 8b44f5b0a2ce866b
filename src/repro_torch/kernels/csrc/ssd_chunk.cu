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
// Design.  A chunk (Q = 256 at mamba2-1.3b) does not fit shared memory in
// one piece (one f32 B or C tile of 256 x 128 is 128 KB), so the chunk is
// cut into 64-row tiles.  One block of 256 threads per (row tile or state,
// head, chunk, batch): blocks 0 .. n_it-1 of a (b, h, c) each own 64 rows
// i of y_intra and loop over the 64-row tiles of j at or below the
// diagonal (loop bounds, not a predicate); block n_it computes the P x N
// state and the decays.  Every block first computes cum for its chunk with
// one warp (a sequential prefix per lane, then a shuffle scan of the lane
// totals), in f64.  Consecutive blocks share (b, c), so the B and C rows they all
// read stay in L2.  The products run on the CUDA cores in f32 FMA: the
// pairwise weights exp(cum_i - cum_j) * dt_j must stay f32 to meet the
// reference's 5e-4 tolerance.
//
// Bound on this card.  At the mamba2-1.3b prefill shape (B=8, S=1024, H=64,
// P=64, N=128, Q=256, bf16 in) one call reads about 73 MB and writes about
// 204 MB of f32 outputs, against about 17.5 GFLOP of products (lower
// triangle only, C B^T once per (b, c)), so it is bound by bytes, mostly
// its f32 outputs.  This first version recomputes C B^T for every head,
// works the full 64 x 64 diagonal tiles and uses neither the tensor cores
// nor TMA: that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;          // chunk rows per tile
constexpr int THREADS = 256;    // 16 row groups x 16 column lanes
constexpr int NSLAB = 128;      // state columns per pass: 16 lanes x 8
constexpr int LM = TQ + 1;      // padded row stride of the M tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Args {
  const void* x; const float* dt; const float* A; const void* Bm; const void* Cm;
  float* y; float* st; float* dall; float* dch;
  int S, H, P, N, Q, nc, n_it;
  long long sxb, sxs, sbb, sbs, scb, scs;   // strides in elements
};

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(double) * (size_t)Q +
         sizeof(float) * ((size_t)Q + (size_t)2 * TQ * (N + 1) +
                          (size_t)TQ * (P + 1) + (size_t)TQ * LM);
}

// PC = ceil(P / 16): columns of y (rows of the state) per thread.
template <typename T, int PC>
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

  const T* xg = static_cast<const T*>(a.x) + b * a.sxb + s0 * a.sxs + (long long)h * P;
  const T* Bg = static_cast<const T*>(a.Bm) + b * a.sbb + s0 * a.sbs;
  const T* Cg = static_cast<const T*>(a.Cm) + b * a.scb + s0 * a.scs;
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
      Cs[r * LN + n] = i < Q ? to_f32(Cg[(long long)i * a.scs + n]) : 0.f;
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
        Bs[r * LN + n] = j < Q ? to_f32(Bg[(long long)j * a.sbs + n]) : 0.f;
      }
      for (int e = tid; e < TQ * P; e += THREADS) {
        const int r = e / P, p = e - r * P, j = j0 + r;
        Xs[r * LX + p] = j < Q ? to_f32(xg[(long long)j * a.sxs + p]) : 0.f;
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
        Bs[r * LN + n] = j < Q ? to_f32(Bg[(long long)j * a.sbs + n0 + n]) *
                                     (expf((float)(c_last - cum[j])) * dts[j])
                               : 0.f;
      }
      for (int e = tid; e < TQ * P; e += THREADS) {
        const int r = e / P, p = e - r * P, j = j0 + r;
        Xs[r * LX + p] = j < Q ? to_f32(xg[(long long)j * a.sxs + p]) : 0.f;
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

template <typename T, int PC>
cudaError_t launch(const Args& a, int Bsz, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.Q, a.P, a.N);
  auto kernel = ssd_chunk_kernel<T, PC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)(a.n_it + 1) * a.H * a.nc * Bsz;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const Args& a, int Bsz, cudaStream_t stream) {
  switch ((a.P + 15) / 16) {
    case 1: return launch<T, 1>(a, Bsz, stream);
    case 2: return launch<T, 2>(a, Bsz, stream);
    case 3:
    case 4: return launch<T, 4>(a, Bsz, stream);
    case 5: case 6: case 7:
    case 8: return launch<T, 8>(a, Bsz, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry bound with ctypes.  dtype of x, B and C: 0 = float32,
// 1 = bfloat16.  Strides are in elements.  Launches on `stream` without
// synchronising and returns cudaGetLastError() (cudaErrorInvalidValue for
// shapes it does not take, before any launch).
extern "C" int ssd_chunk(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* st,
                         void* dall, void* dch, int Bsz, int S, int H, int P,
                         int N, int Q, int dtype, long long sxb, long long sxs,
                         long long sbb, long long sbs, long long scb,
                         long long scs, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 128 || N <= 0 || Q <= 0 ||
      S % Q != 0 || smem_bytes(Q, P, N) > 232448)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
         static_cast<float*>(y), static_cast<float*>(st),
         static_cast<float*>(dall), static_cast<float*>(dch),
         S, H, P, N, Q, S / Q, (Q + TQ - 1) / TQ,
         sxb, sxs, sbb, sbs, scb, scs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_p<float>(a, Bsz, s);
  if (dtype == 1) return (int)dispatch_p<__nv_bfloat16>(a, Bsz, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
