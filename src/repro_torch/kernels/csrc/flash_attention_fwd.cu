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
// q_offset: q's row i sits at position q_offset + i in the causal and
// window tests (a sequence-parallel rank's chunk of q against the whole of
// k and v).  It moves the loop bounds and the test for which tiles need
// masks, and nothing else: a chunk's tiles that lie wholly below its
// diagonal (with Sq < Skv, all but the last of them) run without masks.
// The q tiles with the most kv tiles still come first.
//
// Layout: q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D), o (B,Sq,Hq,D), all contiguous.
// The kernel reads them in place through their strides (no transposed or
// padded copies) and finds the kv head of q head h as h / (Hq/Hkv), so K/V
// are never broadcast in memory.  The TPU's sequential kv grid axis becomes
// a loop inside the block, and it runs only over the kv tiles that the
// causal/window range of the q tile needs (loop bounds, not a predicate).
//
// Three kernels, chosen by dtype and head dim inside the library (the
// wrapper's TMA_HEAD_DIMS agrees); none falls back to another.
//
// bf16, D = 64, 128 and 256: flash_fwd_wgmma_kernel<D>, on wgmma fed by
// TMA (hopper_helpers.cuh), FlashAttention-3's layout.  A block of two
// consumer warpgroups (8 warps, no producer warp) serves 128 q rows of one
// head, 64 rows a warpgroup; the q tiles with the most kv tiles are
// scheduled first (causal: the q tile index runs backwards over
// blockIdx.z, the slowest grid axis).  Q is loaded once by TMA.  K and V
// stream through rings of their own of two stages each, 128-byte
// swizzled, each stage completing on an mbarrier; no warp waits to refill
// a stage: the warp that is the last of the 8 done with it issues the
// load (a shared count, hopper::count_out), and a K stage is free once S
// is formed, before the softmax.  kv tiles and shared memory: D = 64,
// tiles of 64 rows, 49 KB (ptxas keeps to 128 registers a thread, so two
// blocks share an SM); D = 128, 128 rows, 161 KB; D = 256, 64 rows, 193
// KB (up to 255 registers, one block an SM).  A producer warp (a ninth
// warp caps a thread at 168 registers), 3 stages, 128-row tiles at D = 64
// and 64-row tiles at D = 128 each measured slower or no faster
// (tools/kernel_variants.py, PERF.md).  Each warpgroup runs S = Q K^T as
// wgmma with both operands in shared memory (N = the kv tile), the online
// softmax on the accumulator fragments in log2 units (the scale folded
// into one FFMA before ex2.approx; a row's max reduced over the 4 lanes of
// a quad, its sum kept per lane until the end), rounds P to bf16 in
// registers (as the plain version rounds p, ref.py) and runs O += P V
// with P as the register A operand and V read through an MN-major
// descriptor (N = D).  Tile i's S is issued before tile i-1's P V, so the
// softmax of tile i runs while the tensor cores form P V, and the two
// warpgroups issue their products in turns (FlashAttention-3's
// ping-pong), so one's softmax also runs under the other's products.  No
// wgmma sits under a branch that ptxas cannot prove uniform (it would
// serialize them): a warpgroup whose rows lie past Sq computes on the
// zeros TMA reads there.  The cap is a template parameter (no branch per
// score); masks are a separate pass taken only on tiles that the
// diagonal, the window or Skv cut; the block's loop bounds skip the tiles
// past the diagonal and the window.  TMA zero-fills rows past Sq and Skv.
// Under the cap, tanh is hopper::tanh_ex2 (absolute error under 1e-6), not
// tanhf, whose twenty-odd instructions a score made the kernel 12% slower
// at D = 256, nor tanh.approx, which would move p by up to ~2% (PERF.md).
// q, k and v must start 16-byte aligned (TMA); the wrapper refuses a view
// that does not.
//
// bf16, D = 16 and 32 (the sweep grid and the reduced configs):
// flash_fwd_mma_kernel, the FlashAttention-2 structure on mma.sync
// m16n8k16 (bf16 in, f32 accumulate).  A 64 x 16 or 64 x 32 operand is
// below what a wgmma tile of 128-byte rows holds.  One block of 4 warps
// per (64-row q tile, q head, batch); each warp owns 16 q rows.  Q is
// loaded once into registers with ldmatrix; K and V tiles of 64 rows stay
// bf16 in shared memory, rows padded by 16 bytes against bank conflicts,
// double-buffered with cp.async (scalar loads where a base is not 16-byte
// aligned).  The softmax is the wgmma kernel's (the cap through tanhf);
// P is the A operand of P V from registers (the C layout of m16n8k16 is
// its A layout), V is read with ldmatrix.trans.  Masks only on tiles
// that cross the diagonal, the window edge or Skv.
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
// operations, as at every main shape but musicgen's (Hq = Hkv = 32, D=64:
// 34 GFLOP against 134 MB, bytes by a little): the bf16 kernels put the
// operations on the tensor cores, at D >= 64 through wgmma, the only way
// to their full rate, with the softmax under the products.  At gemma2's
// global layers (B=1, S=8192, Hq=16, Hkv=8, D=256) it is 550 GFLOP
// against 201 MB, 0.556 ms at the H100's 989 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_helpers.cuh"
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

// ------------------------------------------- bf16, D = 16, 32, mma.sync ---

// OFFSET: q_off may be nonzero.  Without it the offset is the constant 0
// and the kernel compiles to the same code as one that never had it (a
// runtime offset cost the unsharded path 4-7% at D = 64 and 128, PERF.md)
template <int D, bool OFFSET>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                     int q_off, float cap, float scale, int vec) {
  static_assert(D <= 32, "head dims 64-256 run flash_fwd_wgmma_kernel");
  if (!OFFSET) q_off = 0;
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

  // kv positions this q tile can see: [kv_lo, kv_hi]; q row i sits at
  // position q_off + i
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_hi = causal ? min(q_last + q_off, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 + q_off - window + 1, 0) : 0;
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
  const int pw = qw + q_off;         // and its position
  // Q fragments of the warp's 16 rows, held in registers
  const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) mma::ldmatrix_x4(qf[ks], qrow + ks * 16);
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
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, Kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                 ks * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma::mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, cap and mask, in log2 units; masks only where the tile needs them
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > pw) ||
                      (window && k0 <= pw + 15 - window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c];
        if (cap != 0.f) x = cap * tanhf(x * scale / cap) * LOG2E;
        else x *= sl2;
        if (edge) {
          const int kj = k0 + n * 8 + 2 * t4 + (c & 1);
          const int qi = pw + g + (c >> 1) * 8;
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

// ------------------------------------------- bf16, D = 64-256, wgmma ---

// Tiles of flash_fwd_wgmma_kernel at head dim D.  NWG consumer warpgroups
// of 64 q rows a block and no producer warp: the warp that is the last of
// the block's warps done with a K or V stage refills it (a block of 9
// warps would cap a thread at 168 registers, where 8 get 255, and ran
// slower, PERF.md).  kv tiles of BN rows: 128 at D = 128; 64 at D = 64,
// where 128 rows ran slower, and at D = 256, where S (BN / 2) and O (128)
// accumulators share a thread's registers.  K and V stream through rings of their own of STAGES stages,
// each stage completing on an mbarrier: a K stage is free once S = Q K^T
// is formed, before the softmax, a V stage once O += P V is.  Shared
// memory: Q of the block, then the K and V stages (TILE bytes each), then
// the mbarriers and the stages' counts.
template <int D>
struct FwdWg {
  static constexpr int BN = D == 128 ? 128 : 64;    // kv rows of a tile
  static constexpr int NWG = 2;                     // warpgroups of 64 q rows
  static constexpr int WARPS = 4 * NWG;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NP = D / 64;                 // 64-column panels a row
  static constexpr int Q_TILE = NP * hopper::PANEL_BYTES;    // 64 q rows
  static constexpr int PANEL = BN * 128;            // a panel of a kv tile
  static constexpr int TILE = NP * PANEL;           // a K or V tile
  static constexpr int STAGES = 2;                  // of K, and of V
  static constexpr int BARS = (2 * STAGES + 1) * 8 + 2 * STAGES * 4;
  static constexpr int BYTES = NWG * Q_TILE + 2 * STAGES * TILE + BARS + 1024;
  static_assert(BYTES <= 232448, "over the shared memory of a block");
};

// kv tiles [t_lo, t_hi] of BN rows that q positions [qa, qb] can see
// (none: t_hi < t_lo)
template <int BN>
__device__ __forceinline__ void kv_tiles(int qa, int qb, int Skv, int causal,
                                         int window, int& t_lo, int& t_hi) {
  const int kv_hi = causal ? min(qb, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(qa - window + 1, 0) : 0;
  t_lo = kv_lo / BN;
  t_hi = kv_hi >= kv_lo ? kv_hi / BN : t_lo - 1;
}

// does the kv tile of BN rows from k0 need masks for the 64 q rows from
// position qw0?
template <int BN>
__device__ __forceinline__ bool edge_tile(int qw0, int k0, int Skv, int causal,
                                          int window) {
  return k0 + BN > Skv || (causal && k0 + BN - 1 > qw0) ||
         (window && k0 <= qw0 + 63 - window);
}

// the cap of a 64 x BN score tile on the accumulator fragments, in log2
// units: c2 tanh(s c1) with c1 = D^-0.5 / cap, c2 = cap log2 e.  Without
// the cap the scores stay raw, and the softmax folds their scale in.
template <int R>
__device__ __forceinline__ void fwd_cap(float (&s)[R], float c1, float c2) {
#pragma unroll
  for (int e = 0; e < R; ++e) s[e] = c2 * hopper::tanh_ex2(s[e] * c1);
}

// -inf on the entries of a score tile that the mask drops: rows at
// positions qw (+ 8), columns k0 + 8j + 2t4 + c.  p = 2^-inf = 0 there
// exactly, and a row's running max stays NEG_INF while it sees no key.
template <int R>
__device__ __forceinline__ void fwd_mask(float (&s)[R], int qw, int k0, int t4,
                                         int Skv, int causal, int window) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + 8 * j + 2 * t4 + c, qi = qw + 8 * r;
        bool keep = kj < Skv;
        if (causal) keep = keep && kj <= qi;
        if (window) keep = keep && kj > qi - window;
        if (!keep) s[4 * j + 2 * r + c] = -INFINITY;
      }
}

// the online softmax of one tile's scores for rows qw (r = 0) and qw + 8
// (r = 1), k times each score in log2 units (k = D^-0.5 log2 e on raw
// scores, 1 on capped ones): p = 2^(k s - m) in one FFMA and MUFU
// instruction, in place of the scores; the running max m (log2 units,
// NEG_INF until the row sees a key) and this lane's share of the row sum
// l updated, and the factor by which the accumulator of O is to be
// rescaled in corr
template <int R>
__device__ __forceinline__ void online_softmax(float (&sc)[R], float k,
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * k);
    corr[r] = exp2_ftz(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2_ftz(fmaf(sc[4 * j + 2 * r + c], k, -m_new));
        sc[4 * j + 2 * r + c] = p;
        sum += p;
      }
    l[r] = l[r] * corr[r] + sum;
    m[r] = m_new;
  }
}

// OFFSET: q_off may be nonzero (see flash_fwd_mma_kernel)
template <int D, bool CAP, bool OFFSET>
__global__ void __launch_bounds__(FwdWg<D>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, int q_off, float cap, float scale) {
  using L = FwdWg<D>;
  constexpr int BN = L::BN, NP = L::NP, ROWS = 64 * L::NWG;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = hopper::align1024(smem_wg);
  unsigned char* Qs = smem;          // warpgroup w's 64 rows at w * Q_TILE
  unsigned char* Ks = smem + L::NWG * L::Q_TILE;
  unsigned char* Vs = Ks + L::STAGES * L::TILE;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(Vs + L::STAGES * L::TILE);
  uint64_t* v_full = k_full + L::STAGES;
  uint64_t* q_bar = v_full + L::STAGES;
  uint32_t* k_done = reinterpret_cast<uint32_t*>(q_bar + 1);   // warps done, a stage
  uint32_t* v_done = k_done + L::STAGES;
  if (!OFFSET) q_off = 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // causal: the q tiles with the most kv tiles first
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * ROWS;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  int t_lo, t_hi;                    // the kv tiles of the block's rows
  kv_tiles<BN>(q0 + q_off, min(q0 + ROWS, Sq) - 1 + q_off, Skv, causal,
               window, t_lo, t_hi);

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      k_done[s] = v_done[s] = 0;
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the loads: Q and the first kv tiles from thread 0, then K (V) tile i
  // + STAGES into tile i's stage from the warp that is the last of the
  // block's done with it
  const int n = t_hi - t_lo + 1;     // kv tiles of the block
  auto issue = [&](const CUtensorMap* map, unsigned char* st, uint64_t* bar,
                   int i) {
    hopper::mbar_expect_tx(bar, L::TILE);
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_4d(st + p * L::PANEL, map, bar, p * 64, hk,
                          (t_lo + i) * BN, b);
  };
  auto issue_k = [&](int i) {
    issue(&k_map, Ks + (i % L::STAGES) * L::TILE, &k_full[i % L::STAGES], i);
  };
  auto issue_v = [&](int i) {
    issue(&v_map, Vs + (i % L::STAGES) * L::TILE, &v_full[i % L::STAGES], i);
  };
  if (tid == 0 && n > 0) {
    // Q of every warpgroup, rows past Sq read as zero: a warpgroup without
    // rows runs the same instructions as the others, because ptxas
    // serializes a wgmma under a branch it cannot prove uniform
    hopper::mbar_expect_tx(q_bar, L::NWG * L::Q_TILE);
    for (int w = 0; w < L::NWG; ++w)
      for (int p = 0; p < NP; ++p)
        hopper::tma_load_4d(Qs + w * L::Q_TILE + p * hopper::PANEL_BYTES,
                            &q_map, q_bar, p * 64, h, q0 + w * 64, b);
    for (int i = 0; i < n && i < L::STAGES; ++i) {
      issue_k(i);
      issue_v(i);
    }
  }
  // this warp is done with K (V) tile i: the last of the block's warps
  // refills the stage
  auto release_k = [&](int i) {
    if (lane == 0 &&
        hopper::count_out(&k_done[i % L::STAGES], L::WARPS * (i / L::STAGES + 1)) &&
        i + L::STAGES < n)
      issue_k(i + L::STAGES);
  };
  auto release_v = [&](int i) {
    if (lane == 0 &&
        hopper::count_out(&v_done[i % L::STAGES], L::WARPS * (i / L::STAGES + 1)) &&
        i + L::STAGES < n)
      issue_v(i + L::STAGES);
  };
  auto wait_k = [&](int i) {
    hopper::mbar_wait(&k_full[i % L::STAGES], (i / L::STAGES) & 1);
  };
  auto wait_v = [&](int i) {
    hopper::mbar_wait(&v_full[i % L::STAGES], (i / L::STAGES) & 1);
  };

  // consumer warpgroup wg: q rows qw0 .. qw0 + 63; this thread's qw (+ 8)
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + wg * 64;
  const int qw = qw0 + 16 * (warp & 3) + g;
  const unsigned char* Qw = Qs + wg * L::Q_TILE;
  const float c1 = CAP ? scale / cap : scale * LOG2E, c2 = cap * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // row max (log2 units) of rows qw, qw+8
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  float sc[BN / 2];                  // the scores, then p, of tile i
  uint32_t pa[BN / 16][4];           // p of tile i - 1, bf16, P V's A operand
  float corr[2];                     // the factor that rescales acc for tile i

  // the registers that the next wgmma reads, written before its fence
  auto fence_operands = [&] {
    hopper::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hopper::fence_regs(pa[kk]);
    hopper::wgmma_fence();
  };
  // S = Q K^T of tile i and O += P V of tile i (V through an MN-major
  // descriptor: the reduction runs down V's rows), each committed as a
  // group of its own
  auto qk = [&](int i) {
    const unsigned char* Kt = Ks + (i % L::STAGES) * L::TILE;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      hopper::wgmma_ss<BN, 0>(sc, hopper::desc_kmajor(Qw, ks),
                              hopper::desc_kmajor(Kt, ks, L::PANEL), ks);
    hopper::wgmma_commit();
  };
  auto pv = [&](int i) {
    const unsigned char* Vt = Vs + (i % L::STAGES) * L::TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::wgmma_rs<D, 1>(acc, pa[kk], hopper::desc_mnmajor(Vt, kk, L::PANEL), 1);
    hopper::wgmma_commit();
  };
  // tile i's scores, landed in sc, to p: capped, masked, the online
  // softmax with the scale folded into its exponent
  auto softmax = [&](int i) {
    const int k0 = (t_lo + i) * BN;
    if (CAP) fwd_cap(sc, c1, c2);
    if (edge_tile<BN>(qw0 + q_off, k0, Skv, causal, window))
      fwd_mask(sc, qw + q_off, k0, t4, Skv, causal, window);
    online_softmax(sc, CAP ? 1.f : c1, m, l, corr);
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hopper::pack_a(pa[kk], sc, kk);
  };
  // The two warpgroups issue their products in turns (FlashAttention-3's
  // ping-pong), so that one's softmax runs under the other's products:
  // warpgroup wg waits on named barrier 1 + wg before it issues and
  // arrives on the other's after.  Each issues n + 1 times; warpgroup 0
  // goes first, and warpgroup 1 does not hand on its last turn.
  static_assert(L::NWG == 2, "the ping-pong takes two warpgroups");
  auto my_turn = [&] { hopper::named_bar_sync(1 + wg, 256); };
  auto your_turn = [&](bool last) {
    if (!last || wg == 0) hopper::named_bar_arrive(2 - wg, 256);
  };

  // No wgmma sits under a branch: the first tile is peeled off the loop
  if (n > 0) {
    hopper::mbar_wait(q_bar, 0);
    wait_k(0);
    if (wg == 1) hopper::named_bar_arrive(1, 256);   // warpgroup 0 first
    my_turn();
    fence_operands();
    qk(0);
    your_turn(false);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    release_k(0);
    softmax(0);                      // acc is 0: nothing to rescale
    pack();
  }
  // Tile i's S is issued before tile i - 1's P V, so that the softmax of
  // tile i runs while the tensor cores form P V
  for (int i = 1; i < n; ++i) {
    wait_k(i);
    wait_v(i - 1);
    my_turn();
    fence_operands();
    qk(i);
    pv(i - 1);
    your_turn(false);
    hopper::wgmma_wait<1>();         // S of tile i has landed
    hopper::fence_regs(sc);
    release_k(i);
    softmax(i);
    hopper::wgmma_wait<0>();         // P V of tile i - 1 has landed
    hopper::fence_regs(acc);
    release_v(i - 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= corr[r];
        acc[4 * j + 2 * r + 1] *= corr[r];
      }
    pack();
  }
  if (n > 0) {
    wait_v(n - 1);
    my_turn();
    fence_operands();
    pv(n - 1);
    your_turn(true);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release_v(n - 1);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    // a row that saw no key (m still NEG_INF) writes 0
    const float inv = m[r] <= NEG_INF ? 0.f : 1.f / fmaxf(lr, 1e-30f);
    const int qi = qw + 8 * r;
    if (qi >= Sq) continue;
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * Sq + qi) * Hq + h] =
          m[r] <= NEG_INF ? NEG_INF : (m[r] + log2f(fmaxf(lr, 1e-30f))) * LN2;
    __nv_bfloat16* orow = o + (((long long)b * Sq + qi) * Hq + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          mma::pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
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
                 int causal, int window, int q_off, float cap, float scale) {
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

  // kv positions this q tile can see: [kv_lo, kv_hi]; q row i sits at
  // position q_off + i
  const int q_last = min(q0 + T, Sq) - 1;
  const int kv_hi = causal ? min(q_last + q_off, Skv - 1) : Skv - 1;
  const int kv_lo = window ? max(q0 + q_off - window + 1, 0) : 0;
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
        if (causal) keep = keep && kj <= qi + q_off;
        if (window) keep = keep && kj > qi + q_off - window;
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
                       int window, int q_off, float cap, float scale,
                       cudaStream_t stream) {
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
      Sq, Skv, Hq, Hkv, causal, window, q_off, cap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_mma(const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int Sq, int Skv,
                            int Hq, int Hkv, int causal, int window,
                            int q_off, float cap, float scale,
                            cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * BK) * (D + mma::PAD) * sizeof(__nv_bfloat16);
  auto kernel = q_off ? flash_fwd_mma_kernel<D, true> : flash_fwd_mma_kernel<D, false>;
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
      lse, Sq, Skv, Hq, Hkv, causal, window, q_off, cap, scale, vec);
  return cudaGetLastError();
}

// D = 64, 128, 256: flash_fwd_wgmma_kernel, reading q, k, v by TMA
template <int D>
cudaError_t launch_bf16_wgmma(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int Sq, int Skv,
                              int Hq, int Hkv, int causal, int window,
                              int q_off, float cap, float scale,
                              cudaStream_t stream) {
  using L = FwdWg<D>;
  // TMA reads 16-byte aligned bases (the wrapper checks them too)
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return cudaErrorMisalignedAddress;
  const int nq = (Sq + 64 * L::NWG - 1) / (64 * L::NWG);
  if (B > 65535 || nq > 65535) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (hopper::bshd_map(&qm, q, B, Sq, Hq, D) != CUDA_SUCCESS ||
      hopper::bshd_map(&km, k, B, Skv, Hkv, D, L::BN) != CUDA_SUCCESS ||
      hopper::bshd_map(&vm, v, B, Skv, Hkv, D, L::BN) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = cap != 0.f
      ? (q_off ? flash_fwd_wgmma_kernel<D, true, true> : flash_fwd_wgmma_kernel<D, true, false>)
      : (q_off ? flash_fwd_wgmma_kernel<D, false, true> : flash_fwd_wgmma_kernel<D, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hq, B, nq), L::THREADS, L::BYTES, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq, Hkv,
      causal, window, q_off, cap, scale);
  return cudaGetLastError();
}

#define FLASH_ARGS q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, q_off, cap, scale, stream

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int causal, int window, int q_off, float cap,
                         float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_f32<16>(FLASH_ARGS);
    case 32: return launch_f32<32>(FLASH_ARGS);
    case 64: return launch_f32<64>(FLASH_ARGS);
    case 128: return launch_f32<128>(FLASH_ARGS);
    case 256: return launch_f32<256>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                          float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                          int D, int causal, int window, int q_off, float cap,
                          float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bf16_mma<16>(FLASH_ARGS);
    case 32: return launch_bf16_mma<32>(FLASH_ARGS);
    case 64: return launch_bf16_wgmma<64>(FLASH_ARGS);
    case 128: return launch_bf16_wgmma<128>(FLASH_ARGS);
    case 256: return launch_bf16_wgmma<256>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef FLASH_ARGS

}  // namespace

// C entry bound with ctypes.  dtype: 0 = float32 (CUDA-core kernel),
// 1 = bfloat16 (tensor-core kernels; at D = 64, 128 and 256 q, k, v
// 16-byte aligned for TMA).  lse: f32 (B,Sq,Hq) or null.  q_offset: the position of q's
// row 0 (a sequence-parallel chunk of q against the whole of k and v).
// Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int Sq, int Skv,
                                   int Hq, int Hkv, int D, int dtype,
                                   int causal, int window, int q_offset,
                                   float cap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_f32(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, cap, scale, s);
  if (dtype == 1)
    return (int)dispatch_bf16(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, cap, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
