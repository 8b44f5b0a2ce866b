// Mamba2 SSD: the recurrence between chunks, forward (K3) and backward
// (K3b), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as a lax.scan
// over chunks after its chunk kernel (src/repro/kernels/ssd.py, the loop of
// ssd_reference in src/repro/kernels/ref.py), and the port ran it as a
// Python loop of PyTorch ops differentiated by autograd (about 15 launches
// a chunk, three times a layer in training, and a zeros fill the size of all
// the states for each chunk's select in the backward).  Per (batch b, head
// h), with K2's outputs y_intra, states, decay_all, decay_chunk, C the bf16
// or f32 view of the model's xBC, and h_{-1} = h0 (zeros if none):
//   h_prev[c] = h_{c-1},   h_c = h_{c-1} * decay_chunk_c + states_c
//   y_c = y_intra_c + decay_all_c (.) (C_c h_prev[c]^T), in x's type
//   hT = h_{nc-1}
// The backward, with g_c = dy_c (.) decay_all_c and a carry starting at dhT
// (or 0), for c from nc-1 down to 0:
//   d y_intra = dy in f32,  d decay_all_c[q] = sum_p dy[q,p] (C_c h_prev[c]^T)[q,p]
//   dC_c = sum_h g_c h_prev[c],   X_c = g_c^T C_c
//   d states_c = carry,  d decay_chunk_c = sum carry (.) h_prev[c],
//   carry <- carry (.) decay_chunk_c + X_c;   dh0 = carry.
//
// Layout.  C (B,S,N) is read in place through its batch and sequence
// strides (unit stride along N), as K2 reads the split view of xBC.
// y_intra and y, dy and d y_intra (B,S,H,P); states, h_prev and d states
// (B,H,nc,P,N); decay_all (B,H,nc,Q); decay_chunk (B,H,nc); h0, hT, dhT,
// dh0 (B,H,P,N): contiguous, f32 except y and dy (x's type).
//
// Kernels.  The forward is two launches: ssd_pass_state_kernel walks the
// chunks of one (b, h) in order, elementwise on (P,N) with the state in
// registers, and writes h_prev for every chunk and hT; then a chunk-output
// kernel, one block per (b, c, h), forms C_c h_prev[c]^T and writes y with
// y_inter never in device memory.  The backward is three: a grad kernel per
// (b, c, h) (d decay_all, d y_intra, and X_c into a scratch buffer the size
// of the states), a dC kernel per (b, c, 64 rows of the chunk, 64 state
// columns) that sums over the heads in order, and ssd_pass_carry_kernel,
// the reverse walk per (b, h), which turns X into d states and sums d
// decay_chunk per chunk.  (X written over d states in place ran the walk
// five to six times slower: each address's load and store interleave.)  No
// atomics: every sum runs in a fixed order, so a call is deterministic.
// h_prev is saved by the forward (the wrapper returns it) rather than
// recomputed: under remat only the layer being differentiated holds it (134
// MB at B=4, S=4096), and the backward then needs no states and no second
// walk.
//
// Two routes, chosen from the inputs alone (kernels/ssd_pass.py::pass_route
// states the same rule, and the library refuses a route the inputs do not
// fit):
//  - "mma": bf16 at P = 64 or 128 and N a multiple of 8 up to 128 (the
//    models' widths: mamba2 P=64, jamba P=128, N=128): the products on the
//    tensor cores (mma.sync m16n8k16, f32 accumulate).  C and dy are exact
//    in bf16; every f32 operand (h_prev, g) is split into three bf16 parts,
//    hi + mid + lo (about 2^-27 relative, as K2 and K2b split theirs), and
//    each product runs once per part into one f32 accumulator: the accuracy
//    of the f32 products it replaces, with no TF32 and no f32 operand
//    rounded to bf16.  N is zero-padded to 128 in shared memory.
//  - "f32": every other shape or type, f32 FMA on the CUDA cores.
// The state walks are elementwise f32 and shared by both routes.
//
// Bound on this card.  At mamba2-1.3b's train shape (B=4, S=4096, H=64,
// P=64, N=128, Q=256) the forward moves about 0.68 GB (y_intra, states and
// h_prev in f32 dominate) against 17 GFLOP, the backward about 0.68 GB
// against 52 GFLOP: both are bound by bytes (kernels/cost.py).  The mma.sync
// route runs the split products (3x the FLOPs) well under the byte time,
// so the kernels are written for bytes: each input is read once where the
// design allows (h_prev twice in the forward, once per 64 rows of a chunk in
// the dC kernel, mostly from L2), the state walks keep the state in
// registers, and y leaves the card once, in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_helpers.cuh"

namespace {

constexpr int SCAN_T = 512;         // state walks: threads a block
constexpr int SCAN_EMAX = 64;       // state walks: most elements a thread
constexpr int TQ = 64;              // mma route: chunk rows a tile
constexpr int NT = 128;             // mma route: N padded to this
constexpr int LH = NT + mma::PAD;   // row stride of h's split and C's tile
constexpr int NW = 64;              // dC kernel: state columns a block
constexpr int LW = NW + mma::PAD;   // its row stride of h's split
constexpr int MT = 128;             // mma route: threads of a 4-warp block
constexpr int FT = 256;             // f32 route: threads a block

struct PassArgs {
  // forward
  const float* yi; const float* st; const float* dall; const float* dch;
  const void* C; const float* h0;
  void* y; float* hT; float* hp;
  // backward
  const void* dy; const float* dhT;
  float* dyi; float* ds; float* ddall; float* ddch; float* dC; float* dh0;
  float* xw;            // X_c, the grad kernel's output and the walk's input
  int H, P, N, Q, nc, S;
  long long scb, scs;   // C's batch and sequence strides, elements
  int vc;               // C's rows load by 16-byte cp.async
  int vy;               // dy's rows load by 16-byte cp.async
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- state walks ---

// One block per (b, h); thread e of the block holds elements e + k SCAN_T,
// k < E, of the (P,N) state in registers across the chunks.
template <int E>
__global__ void __launch_bounds__(SCAN_T) ssd_pass_state_kernel(PassArgs a) {
  const long long bh = blockIdx.x, PN = (long long)a.P * a.N;
  const float* st_ = a.st + bh * a.nc * PN;
  float* hp = a.hp + bh * a.nc * PN;
  const float* dch = a.dch + bh * a.nc;
  float h[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = threadIdx.x + (long long)e * SCAN_T;
    h[e] = (a.h0 != nullptr && i < PN) ? a.h0[bh * PN + i] : 0.f;
  }
  for (int c = 0; c < a.nc; ++c) {
    const float d = dch[c];
    float s[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = threadIdx.x + (long long)e * SCAN_T;
      s[e] = i < PN ? st_[c * PN + i] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = threadIdx.x + (long long)e * SCAN_T;
      if (i < PN) {
        hp[c * PN + i] = h[e];
        h[e] = h[e] * d + s[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = threadIdx.x + (long long)e * SCAN_T;
    if (i < PN) a.hT[bh * PN + i] = h[e];
  }
}

// The reverse walk: X_c (xw) in, d states_c out.  d decay_chunk_c is the
// block's sum: each warp's sum per chunk
// goes to shared memory, and the block adds them, warps in order, every
// RED chunks, so the walk itself waits on no barrier.
constexpr int RED = 64;

template <int E>
__global__ void __launch_bounds__(SCAN_T) ssd_pass_carry_kernel(PassArgs a) {
  constexpr int NWARP = SCAN_T / 32;
  __shared__ float red[RED][NWARP];
  const long long bh = blockIdx.x, PN = (long long)a.P * a.N;
  float* ds = a.ds + bh * a.nc * PN;
  const float* xw = a.xw + bh * a.nc * PN;
  const float* hp = a.hp + bh * a.nc * PN;
  const float* dch = a.dch + bh * a.nc;
  float g[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const long long i = threadIdx.x + (long long)e * SCAN_T;
    g[e] = (a.dhT != nullptr && i < PN) ? a.dhT[bh * PN + i] : 0.f;
  }
  for (int c = a.nc - 1; c >= 0; --c) {
    const float d = dch[c];
    float part = 0.f, x[E], hv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = threadIdx.x + (long long)e * SCAN_T;
      x[e] = i < PN ? xw[c * PN + i] : 0.f;
      hv[e] = i < PN ? hp[c * PN + i] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = threadIdx.x + (long long)e * SCAN_T;
      if (i < PN) ds[c * PN + i] = g[e];
      part += g[e] * hv[e];
      g[e] = g[e] * d + x[e];
    }
    part = warp_sum(part);
    const int slot = (a.nc - 1 - c) % RED;
    if ((threadIdx.x & 31) == 0) red[slot][threadIdx.x >> 5] = part;
    if (slot == RED - 1 || c == 0) {      // the block's sums of these chunks
      __syncthreads();
      for (int k = threadIdx.x; k <= slot; k += SCAN_T) {
        float s = 0.f;
        for (int w = 0; w < NWARP; ++w) s += red[k][w];
        a.ddch[bh * a.nc + c + slot - k] = s;
      }
      __syncthreads();
    }
  }
  if (a.dh0 != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = threadIdx.x + (long long)e * SCAN_T;
      if (i < PN) a.dh0[bh * PN + i] = g[e];
    }
  }
}

// ------------------------------------------------------ mma.sync route ---

// h_prev of one (b, h, c), rows [0, P) and columns [n0, n0 + W) of its
// (P, N) f32 matrix, split into three bf16 tiles `part` elements apart (row
// stride ld); columns at or past N are zero.  N is even, so pairs load as
// float2, U of them in flight a thread before any is stored.
template <int W>
__device__ __forceinline__ void split_h(__nv_bfloat16* __restrict__ dst, int part, int ld,
                                        const float* __restrict__ src, int P, int N, int n0) {
  constexpr int half = W / 2, U = 8;
  const int n_pairs = P * half;
  for (int e0 = threadIdx.x; e0 < n_pairs; e0 += U * blockDim.x) {
    float2 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x, p = e / half, n = (e - p * half) * 2;
      v[u] = make_float2(0.f, 0.f);
      if (e < n_pairs && n0 + n < N)
        v[u] = *reinterpret_cast<const float2*>(src + (long long)p * N + n0 + n);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x, p = e / half, n = (e - p * half) * 2;
      if (e >= n_pairs) break;
      uint32_t r[3];
      mma::split3_bf16(v[u].x, v[u].y, r[0], r[1], r[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint32_t*>(dst + k * part + p * ld + n) = r[k];
    }
  }
}

// Z = C_t h^T for the 16 rows at r0 of the C tile `cs` and the 64 columns
// (heads' P) at p0: z[j] is n-tile j's accumulator; h split in three.
template <int P>
__device__ __forceinline__ void c_times_h(float (&z)[8][4], const __nv_bfloat16* cs,
                                          const __nv_bfloat16* hs, int r0, int p0,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < NT; k0 += 16) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, cs + (r0 + (lane & 15)) * LH + k0 + 8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t bf[4];
        mma::ldmatrix_x4(bf, hs + k * P * LH + (p0 + 8 * j + 8 * (lane >> 4) + (lane & 7)) * LH +
                                 k0 + 8 * ((lane >> 3) & 1));
        mma::mma_bf16(z[j], af, bf[0], bf[1]);
        mma::mma_bf16(z[j + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// K3's chunk output, one block of 4 warps per (b, c, h), heads fastest (the
// blocks of one chunk share its C in L2).  h_prev[c] split into shared
// memory once; then per 64-row tile of the chunk, C's rows by cp.async,
// each warp 16 rows by P columns, and y = y_intra + decay_all * acc
// rounded to bf16 as it is written.
template <int P>
__global__ void __launch_bounds__(MT) ssd_pass_out_kernel(PassArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);   // [3][P][LH]
  __nv_bfloat16* cs = hs + 3 * P * LH;                            // [TQ][LH]
  const int h = blockIdx.x % a.H, bc = blockIdx.x / a.H, c = bc % a.nc, b = bc / a.nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  split_h<NT>(hs, P * LH, LH, a.hp + bhc * P * a.N, P, a.N, 0);
  const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(a.C) + b * a.scb +
                            (long long)c * a.Q * a.scs;
  const float* dl = a.dall + bhc * a.Q;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  for (int q0 = 0; q0 < a.Q; q0 += TQ) {
    __syncthreads();                       // the last tile's reads of cs are done
    mma::load_tile(cs, LH, Cg + (long long)q0 * a.scs, a.scs, TQ, a.Q - q0, a.N, NT, a.vc,
                   tid, MT);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int p0 = 0; p0 < P; p0 += 64) {
      // y_intra's values and decay_all in flight under the products
      float2 yv[2][8];
      float d[2];
      long long row[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = q0 + warp * 16 + g + 8 * half;
        row[half] = (((long long)b * a.S + (long long)c * a.Q + q) * a.H + h) * P;
        d[half] = q < a.Q ? dl[q] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          yv[half][j] = q < a.Q ? *reinterpret_cast<const float2*>(a.yi + row[half] + p0 +
                                                                   8 * j + 2 * t)
                                : make_float2(0.f, 0.f);
      }
      float z[8][4];
      c_times_h<P>(z, cs, hs, warp * 16, p0, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (q0 + warp * 16 + g + 8 * half >= a.Q) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(y + row[half] + p0 + 8 * j + 2 * t) =
              mma::pack_bf16(yv[half][j].x + d[half] * z[j][2 * half],
                             yv[half][j].y + d[half] * z[j][2 * half + 1]);
      }
    }
  }
}

// K3b's grad kernel, one block of P/16 warps per (b, c, h).  Per 64-row
// tile of the chunk: Z = C h^T (warp w: 16 rows at 16 (w % 4), 64 columns
// at 64 (w / 4)); from Z's registers, dy read once: d y_intra = dy in f32,
// d decay_all's partial sums, and g = dy * decay_all split in three into
// shared memory; then X += g^T C (warp w: X's rows 16 w, all N columns),
// held in registers across the tiles and written to xw.
template <int P>
__global__ void __launch_bounds__(P * 2) ssd_pass_grad_kernel(PassArgs a) {
  constexpr int T = P * 2, LG = P + mma::PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);   // [3][P][LH]
  __nv_bfloat16* cs = hs + 3 * P * LH;                            // [TQ][LH]
  __nv_bfloat16* gs = cs + TQ * LH;                               // [3][TQ][LG]
  float* red = reinterpret_cast<float*>(gs + 3 * TQ * LG);        // [P / 64][TQ]
  const int h = blockIdx.x % a.H, bc = blockIdx.x / a.H, c = bc % a.nc, b = bc / a.nc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  split_h<NT>(hs, P * LH, LH, a.hp + bhc * P * a.N, P, a.N, 0);
  const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(a.C) + b * a.scb +
                            (long long)c * a.Q * a.scs;
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy);
  const float* dl = a.dall + bhc * a.Q;
  const int zr = (warp & 3) * 16, zc = (warp >> 2) * 64;
  float x[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
  for (int q0 = 0; q0 < a.Q; q0 += TQ) {
    __syncthreads();                       // the last tile's reads of cs, gs are done
    mma::load_tile(cs, LH, Cg + (long long)q0 * a.scs, a.scs, TQ, a.Q - q0, a.N, NT, a.vc,
                   tid, T);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    // dy's values and decay_all in flight under the products
    uint32_t dv[2][8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + zr + g + 8 * half;
      const long long row = (((long long)b * a.S + (long long)c * a.Q + q) * a.H + h) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dv[half][j] = q < a.Q ? *reinterpret_cast<const uint32_t*>(dy + row + zc + 8 * j + 2 * t)
                              : 0u;
    }
    float z[8][4];
    c_times_h<P>(z, cs, hs, zr, zc, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = zr + g + 8 * half, q = q0 + r;
      const bool in = q < a.Q;
      const float d = in ? dl[q] : 0.f;
      const long long row = (((long long)b * a.S + (long long)c * a.Q + q) * a.H + h) * P;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = zc + 8 * j + 2 * t;
        const float2 v = mma::unpack_bf16(dv[half][j]);
        if (in) *reinterpret_cast<float2*>(a.dyi + row + p) = v;
        part += v.x * z[j][2 * half] + v.y * z[j][2 * half + 1];
        uint32_t s[3];
        mma::split3_bf16(v.x * d, v.y * d, s[0], s[1], s[2]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint32_t*>(gs + k * TQ * LG + r * LG + p) = s[k];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (t == 0) red[(warp >> 2) * TQ + r] = part;
    }
    __syncthreads();
    if (tid < TQ && q0 + tid < a.Q) {
      float s = red[tid];
      if (P == 128) s += red[TQ + tid];
      a.ddall[bhc * a.Q + q0 + tid] = s;
    }
    // X += g^T C over the tile's 64 rows: A = g^T (split, ldmatrix.trans
    // of gs), B = C (exact, ldmatrix.trans of cs)
#pragma unroll
    for (int k0 = 0; k0 < TQ; k0 += 16) {
      const int i = lane >> 3, rr = lane & 7;
      uint32_t af[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        mma::ldmatrix_x4_trans(af[k], gs + k * TQ * LG + (k0 + 8 * (i >> 1) + rr) * LG +
                                          warp * 16 + 8 * (i & 1));
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, cs + (k0 + 8 * (i & 1) + rr) * LH + 8 * j + 8 * (i >> 1));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma::mma_bf16(x[j], af[k], bf[0], bf[1]);
          mma::mma_bf16(x[j + 1], af[k], bf[2], bf[3]);
        }
      }
    }
  }
  float* xs = a.xw + bhc * P * a.N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = warp * 16 + g + 8 * half;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * t;
      if (n < a.N)
        *reinterpret_cast<float2*>(xs + (long long)p * a.N + n) =
            make_float2(x[j][2 * half], x[j][2 * half + 1]);
    }
  }
}

// K3b's dC, one block of 4 warps per (b, c, 64 rows of the chunk, 64 state
// columns), the column blocks fastest.  It walks the heads in order: dy's
// rows of head h (exact) by cp.async, h_prev[c]'s 64 columns split in
// three; W = dy h (warp w: 16 rows, 64 columns) and dC += decay_all_h * W
// in registers.  The next head's dy (cp.async, a second buffer) and h_prev
// (registers) load under the current head's products.
template <int P>
__global__ void __launch_bounds__(MT) ssd_pass_dc_kernel(PassArgs a) {
  constexpr int LG = P + mma::PAD, HALF = NW / 2, U = P * HALF / MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);   // [3][P][LW]
  __nv_bfloat16* ys = hs + 3 * P * LW;                            // [2][TQ][LG]
  float* dls = reinterpret_cast<float*>(ys + 2 * TQ * LG);        // [TQ]
  const int n_nb = (a.N + NW - 1) / NW, n_qt = (a.Q + TQ - 1) / TQ;
  int rest = blockIdx.x;
  const int nb = rest % n_nb; rest /= n_nb;
  const int qt = rest % n_qt; rest /= n_qt;
  const int c = rest % a.nc, b = rest / a.nc;
  const int n0 = nb * NW, q0 = qt * TQ, rows = a.Q - q0 < TQ ? a.Q - q0 : TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int i = lane >> 3, rr = lane & 7;
  const long long s0 = (long long)c * a.Q + q0;
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(a.dy) +
                            ((long long)b * a.S + s0) * a.H * P;
  // thread tid holds pairs tid + u MT of h_prev's (P, 64) column block
  auto load_h = [&](float2 (&v)[U], int h) {
    const float* src = a.hp + (((long long)b * a.H + h) * a.nc + c) * P * a.N + n0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = tid + u * MT, p = e / HALF, n = (e - p * HALF) * 2;
      v[u] = n0 + n < a.N ? *reinterpret_cast<const float2*>(src + (long long)p * a.N + n)
                          : make_float2(0.f, 0.f);
    }
  };
  auto load_dy = [&](int h) {
    mma::load_tile(ys + (h & 1) * TQ * LG, LG, dy + (long long)h * P, (long long)a.H * P, TQ,
                   rows, P, P, a.vy, tid, MT);
    mma::cp_async_commit();
  };
  float2 hv[U];
  load_dy(0);
  load_h(hv, 0);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int h = 0; h < a.H; ++h) {
    __syncthreads();                       // the last head's reads of hs, dls are done
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = tid + u * MT, p = e / HALF, n = (e - p * HALF) * 2;
      uint32_t r[3];
      mma::split3_bf16(hv[u].x, hv[u].y, r[0], r[1], r[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint32_t*>(hs + k * P * LW + p * LW + n) = r[k];
    }
    if (tid < TQ)
      dls[tid] = tid < rows ? a.dall[(((long long)b * a.H + h) * a.nc + c) * a.Q + q0 + tid] : 0.f;
    if (h + 1 < a.H) {
      load_dy(h + 1);
      load_h(hv, h + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* yt = ys + (h & 1) * TQ * LG;
    float w[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < P; k0 += 16) {
      uint32_t af[4];
      mma::ldmatrix_x4(af, yt + (warp * 16 + (lane & 15)) * LG + k0 + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          uint32_t bf[4];
          mma::ldmatrix_x4_trans(bf, hs + k * P * LW + (k0 + 8 * (i & 1) + rr) * LW + 8 * j +
                                         8 * (i >> 1));
          mma::mma_bf16(w[j], af, bf[0], bf[1]);
          mma::mma_bf16(w[j + 1], af, bf[2], bf[3]);
        }
      }
    }
    const float d0 = dls[warp * 16 + g], d1 = dls[warp * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] += d0 * w[j][0];
      acc[j][1] += d0 * w[j][1];
      acc[j][2] += d1 * w[j][2];
      acc[j][3] += d1 * w[j][3];
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    if (r >= rows) continue;
    float* out = a.dC + ((long long)b * a.S + s0 + r) * a.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n < a.N)
        *reinterpret_cast<float2*>(out + n) = make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------- f32 route ---

// The chunk output on the CUDA cores, one block per (b, c, h): h_prev[c]
// in shared memory (row stride N + 1), a thread per output.
template <typename T>
__global__ void __launch_bounds__(FT) ssd_pass_out_f32_kernel(PassArgs a) {
  extern __shared__ float hsf[];
  const int h = blockIdx.x % a.H, bc = blockIdx.x / a.H, c = bc % a.nc, b = bc / a.nc;
  const int P = a.P, N = a.N, L = N + 1;
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const float* src = a.hp + bhc * P * N;
  for (int e = threadIdx.x; e < P * N; e += FT) hsf[(e / N) * L + e % N] = src[e];
  __syncthreads();
  const T* C = static_cast<const T*>(a.C) + b * a.scb + (long long)c * a.Q * a.scs;
  T* y = static_cast<T*>(a.y);
  for (int e = threadIdx.x; e < a.Q * P; e += FT) {
    const int q = e / P, p = e - q * P;
    const T* cr = C + (long long)q * a.scs;
    float z = 0.f;
    for (int n = 0; n < N; ++n) z += ld(cr + n) * hsf[p * L + n];
    const long long at = (((long long)b * a.S + (long long)c * a.Q + q) * a.H + h) * P + p;
    st(y + at, a.yi[at] + a.dall[bhc * a.Q + q] * z);
  }
}

// K3b's grad kernel on the CUDA cores, one block per (b, c, h): d y_intra,
// d decay_all (a thread per row) and X (a thread per state element).
template <typename T>
__global__ void __launch_bounds__(FT) ssd_pass_grad_f32_kernel(PassArgs a) {
  extern __shared__ float hsf[];
  const int h = blockIdx.x % a.H, bc = blockIdx.x / a.H, c = bc % a.nc, b = bc / a.nc;
  const int P = a.P, N = a.N, L = N + 1;
  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  const float* src = a.hp + bhc * P * N;
  for (int e = threadIdx.x; e < P * N; e += FT) hsf[(e / N) * L + e % N] = src[e];
  __syncthreads();
  const T* C = static_cast<const T*>(a.C) + b * a.scb + (long long)c * a.Q * a.scs;
  const T* dy = static_cast<const T*>(a.dy);
  const float* dl = a.dall + bhc * a.Q;
  const long long row0 = ((long long)b * a.S + (long long)c * a.Q) * a.H + h;   // of q = 0
  for (int e = threadIdx.x; e < a.Q * P; e += FT) {
    const int q = e / P, p = e - q * P;
    const long long at = (row0 + (long long)q * a.H) * P + p;
    a.dyi[at] = ld(dy + at);
  }
  for (int q = threadIdx.x; q < a.Q; q += FT) {
    const T* cr = C + (long long)q * a.scs;
    const T* dq = dy + (row0 + (long long)q * a.H) * P;
    float s = 0.f;
    for (int p = 0; p < P; ++p) {
      float z = 0.f;
      for (int n = 0; n < N; ++n) z += ld(cr + n) * hsf[p * L + n];
      s += ld(dq + p) * z;
    }
    a.ddall[bhc * a.Q + q] = s;
  }
  float* xs = a.xw + bhc * P * N;
  for (int e = threadIdx.x; e < P * N; e += FT) {
    const int p = e / N, n = e - p * N;
    float s = 0.f;
    for (int q = 0; q < a.Q; ++q)
      s += ld(dy + (row0 + (long long)q * a.H) * P + p) * dl[q] * ld(C + (long long)q * a.scs + n);
    xs[e] = s;
  }
}

// K3b's dC on the CUDA cores: a thread per (b, row, state column), the
// heads walked in order.
template <typename T>
__global__ void __launch_bounds__(FT) ssd_pass_dc_f32_kernel(PassArgs a) {
  const long long e = (long long)blockIdx.x * FT + threadIdx.x;
  const int bc = blockIdx.y, c = bc % a.nc, b = bc / a.nc;
  if (e >= (long long)a.Q * a.N) return;
  const int q = (int)(e / a.N), n = (int)(e - (long long)q * a.N);
  const int P = a.P;
  const long long s = (long long)c * a.Q + q;
  const T* dy = static_cast<const T*>(a.dy) + ((long long)b * a.S + s) * a.H * P;
  float acc = 0.f;
  for (int h = 0; h < a.H; ++h) {
    const long long bhc = ((long long)b * a.H + h) * a.nc + c;
    const float* hp = a.hp + bhc * P * a.N + n;
    float w = 0.f;
    for (int p = 0; p < P; ++p) w += ld(dy + (long long)h * P + p) * hp[(long long)p * a.N];
    acc += a.dall[bhc * a.Q + q] * w;
  }
  a.dC[((long long)b * a.S + s) * a.N + n] = acc;
}

// --------------------------------------------------------- launching ---

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The mma.sync route: bf16 at P = 64 or 128 and N a multiple of 8 up to
// 128 (kernels/ssd_pass.py::pass_route, the same rule).
bool mma_shape(const PassArgs& a, bool bf16) {
  return bf16 && (a.P == 64 || a.P == 128) && a.N % 8 == 0 && a.N <= NT;
}

template <typename K>
cudaError_t launch(K kernel, long long blocks, dim3 threads, size_t smem, cudaStream_t stream,
                   const PassArgs& a, unsigned grid_y = 1) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((unsigned)blocks, grid_y), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The state walks at E elements a thread, E the least power of two with
// E SCAN_T >= P N.
template <template <int> class W>
cudaError_t launch_walk(const PassArgs& a, long long bh, cudaStream_t stream) {
  const long long PN = (long long)a.P * a.N;
  if (PN <= SCAN_T * 1LL) return launch(W<1>::k, bh, SCAN_T, 0, stream, a);
  if (PN <= SCAN_T * 2LL) return launch(W<2>::k, bh, SCAN_T, 0, stream, a);
  if (PN <= SCAN_T * 4LL) return launch(W<4>::k, bh, SCAN_T, 0, stream, a);
  if (PN <= SCAN_T * 8LL) return launch(W<8>::k, bh, SCAN_T, 0, stream, a);
  if (PN <= SCAN_T * 16LL) return launch(W<16>::k, bh, SCAN_T, 0, stream, a);
  if (PN <= SCAN_T * 32LL) return launch(W<32>::k, bh, SCAN_T, 0, stream, a);
  if (PN <= SCAN_T * 64LL) return launch(W<64>::k, bh, SCAN_T, 0, stream, a);
  return cudaErrorInvalidValue;
}

template <int E> struct StateWalk { static constexpr auto k = ssd_pass_state_kernel<E>; };
template <int E> struct CarryWalk { static constexpr auto k = ssd_pass_carry_kernel<E>; };

size_t out_smem(int P) { return sizeof(__nv_bfloat16) * (size_t)(3 * P + TQ) * LH; }
size_t grad_smem(int P) {
  return sizeof(__nv_bfloat16) * ((size_t)(3 * P + TQ) * LH + (size_t)3 * TQ * (P + mma::PAD)) +
         sizeof(float) * (size_t)(P / 64) * TQ;
}
size_t dc_smem(int P) {
  return sizeof(__nv_bfloat16) * ((size_t)3 * P * LW + (size_t)2 * TQ * (P + mma::PAD)) +
         sizeof(float) * TQ;
}

bool checked_args(int Bsz, int S, int H, int P, int N, int Q, int dtype, int route) {
  return Bsz > 0 && S > 0 && H > 0 && P > 0 && N > 0 && Q > 0 && S % Q == 0 &&
         (long long)P * N <= (long long)SCAN_T * SCAN_EMAX && (dtype == 0 || dtype == 1) &&
         (route == 0 || route == 1);
}

PassArgs make_args(int S, int H, int P, int N, int Q, long long scb, long long scs) {
  PassArgs a{};
  a.H = H; a.P = P; a.N = N; a.Q = Q; a.nc = S / Q; a.S = S;
  a.scb = scb; a.scs = scs;
  return a;
}

}  // namespace

// C entries bound with ctypes.  dtype of y and C (forward) or of dy and C
// (backward): 0 = float32, 1 = bfloat16; route: 0 = the CUDA cores, 1 =
// mma.sync (bf16 only, mma_shape).  C's strides are in elements.  h0 and
// dhT may be null (zeros); dh0 may be null (not written); the backward's
// `work` holds X (the d states' shape, f32).  Each launches on
// `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take, before any launch).
extern "C" int ssd_pass_fwd(const void* yi, const void* st, const void* dall, const void* dch,
                            const void* C, const void* h0, void* y, void* hT, void* hp, int Bsz,
                            int S, int H, int P, int N, int Q, int dtype, int route, long long scb,
                            long long scs, void* stream) {
  if (!checked_args(Bsz, S, H, P, N, Q, dtype, route)) return (int)cudaErrorInvalidValue;
  PassArgs a = make_args(S, H, P, N, Q, scb, scs);
  a.yi = static_cast<const float*>(yi); a.st = static_cast<const float*>(st);
  a.dall = static_cast<const float*>(dall); a.dch = static_cast<const float*>(dch);
  a.C = C; a.h0 = static_cast<const float*>(h0);
  a.y = y; a.hT = static_cast<float*>(hT); a.hp = static_cast<float*>(hp);
  const bool bf16 = dtype == 1;
  if (route == 1 && !mma_shape(a, bf16)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_walk<StateWalk>(a, (long long)Bsz * H, s);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)Bsz * a.nc * H;
  if (route == 1) {
    a.vc = aligned16(C) && a.N % 8 == 0 && scb % 8 == 0 && scs % 8 == 0;
    return (int)(P == 64 ? launch(ssd_pass_out_kernel<64>, blocks, MT, out_smem(64), s, a)
                         : launch(ssd_pass_out_kernel<128>, blocks, MT, out_smem(128), s, a));
  }
  const size_t smem = sizeof(float) * (size_t)P * (N + 1);
  return (int)(bf16 ? launch(ssd_pass_out_f32_kernel<__nv_bfloat16>, blocks, FT, smem, s, a)
                    : launch(ssd_pass_out_f32_kernel<float>, blocks, FT, smem, s, a));
}

extern "C" int ssd_pass_bwd(const void* dy, const void* dhT, const void* hp, const void* dall,
                            const void* dch, const void* C, void* dyi, void* ds, void* ddall,
                            void* ddch, void* dC, void* dh0, void* work, int Bsz, int S, int H,
                            int P, int N, int Q, int dtype, int route, long long scb,
                            long long scs, void* stream) {
  if (!checked_args(Bsz, S, H, P, N, Q, dtype, route)) return (int)cudaErrorInvalidValue;
  PassArgs a = make_args(S, H, P, N, Q, scb, scs);
  a.dy = dy; a.dhT = static_cast<const float*>(dhT);
  a.hp = const_cast<float*>(static_cast<const float*>(hp));
  a.dall = static_cast<const float*>(dall); a.dch = static_cast<const float*>(dch); a.C = C;
  a.dyi = static_cast<float*>(dyi); a.ds = static_cast<float*>(ds);
  a.ddall = static_cast<float*>(ddall); a.ddch = static_cast<float*>(ddch);
  a.dC = static_cast<float*>(dC); a.dh0 = static_cast<float*>(dh0);
  a.xw = static_cast<float*>(work);
  const bool bf16 = dtype == 1;
  if (route == 1 && !mma_shape(a, bf16)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long long blocks = (long long)Bsz * a.nc * H;
  cudaError_t err;
  if (route == 1) {
    a.vc = aligned16(C) && a.N % 8 == 0 && scb % 8 == 0 && scs % 8 == 0;
    a.vy = aligned16(dy);
    err = P == 64 ? launch(ssd_pass_grad_kernel<64>, blocks, 128, grad_smem(64), s, a)
                  : launch(ssd_pass_grad_kernel<128>, blocks, 256, grad_smem(128), s, a);
    if (err != cudaSuccess) return (int)err;
    const long long dc_blocks = (long long)Bsz * a.nc * ((Q + TQ - 1) / TQ) * ((N + NW - 1) / NW);
    err = P == 64 ? launch(ssd_pass_dc_kernel<64>, dc_blocks, MT, dc_smem(64), s, a)
                  : launch(ssd_pass_dc_kernel<128>, dc_blocks, MT, dc_smem(128), s, a);
  } else {
    const size_t smem = sizeof(float) * (size_t)P * (N + 1);
    err = bf16 ? launch(ssd_pass_grad_f32_kernel<__nv_bfloat16>, blocks, FT, smem, s, a)
               : launch(ssd_pass_grad_f32_kernel<float>, blocks, FT, smem, s, a);
    if (err != cudaSuccess) return (int)err;
    const long long dc_blocks = ((long long)Q * N + FT - 1) / FT;
    if ((long long)Bsz * a.nc > 65535) return (int)cudaErrorInvalidValue;
    err = bf16 ? launch(ssd_pass_dc_f32_kernel<__nv_bfloat16>, dc_blocks, FT, 0, s, a,
                        (unsigned)(Bsz * a.nc))
               : launch(ssd_pass_dc_f32_kernel<float>, dc_blocks, FT, 0, s, a,
                        (unsigned)(Bsz * a.nc));
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_walk<CarryWalk>(a, (long long)Bsz * H, s);
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
