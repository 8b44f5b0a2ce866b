// Warp-level tensor-core and async-copy helpers for sm_90a, shared by the
// bf16 paths of the port's kernels.
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate) fragments, for lane l with
// g = l / 4 and t = l % 4:
//   A (16x16, row-major):  a0 = (row g,   cols 2t, 2t+1)   a1 = (row g+8, cols 2t, 2t+1)
//                          a2 = (row g,   cols 2t+8, 2t+9) a3 = (row g+8, cols 2t+8, 2t+9)
//   B (16x8, k x n):       b0 = (k 2t, 2t+1; col g)       b1 = (k 2t+8, 2t+9; col g)
//   C (16x8, f32):         c0, c1 = (row g, cols 2t, 2t+1) c2, c3 = (row g+8, cols 2t, 2t+1)
// The C layout of two neighbouring n-tiles is the A layout of one k-step,
// so a product's accumulator feeds the next product from registers.
//
// Shared-memory tiles hold bf16 rows padded by 8 elements (16 bytes): with a
// row of W elements, W a multiple of 16, the row stride is an odd multiple
// of 16 bytes, so the 8 row addresses of one ldmatrix fall in 8 distinct
// 16-byte bank groups and no load conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

constexpr int PAD = 8;          // bf16 elements of padding per shared row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// D += A * B, m16n8k16, bf16 x bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: lane (g, t) gets rows 2t, 2t+1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

// x = hi + mid + lo, three bf16 parts, to about 2^-27 relative: hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each difference
// exact in f32.  Three products, one with each part, into one f32
// accumulator run a near-f32 operand at f32 accuracy on bf16 tensor cores
// (two parts would leave about 2^-18).
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;
  mid = pack_bf16(r0, r1);
  const float2 m = unpack_bf16(mid);
  lo = pack_bf16(r0 - m.x, r1 - m.y);
}

// 16-byte async copy global -> shared; with ok false nothing is read and
// the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
// 4-byte async copy global -> shared (a strided f32 gather).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy rows [0, rows) x columns [0, wpad) of a bf16 matrix into a shared
// tile of row stride ld: global row r is at g + r * stride.  Rows >= nrows
// and columns >= w read as zero.  vec: g and stride are 16-byte aligned and
// w is a multiple of 8, so each 8-element piece is one cp.async (the caller
// commits and waits); otherwise element loads, stored at once.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int ld,
                                          const __nv_bfloat16* g,
                                          long long stride, int rows,
                                          int nrows, int w, int wpad, bool vec,
                                          int tid, int nthreads) {
  const int cpr = wpad / 8;
  for (int e = tid; e < rows * cpr; e += nthreads) {
    const int r = e / cpr, c = (e - r * cpr) * 8;
    __nv_bfloat16* dst = s + r * ld + c;
    const bool row_ok = r < nrows;
    if (vec) {
      const bool ok = row_ok && c < w;
      cp_async16(dst, ok ? g + r * stride + c : g, ok);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        dst[u] = (row_ok && c + u < w) ? g[r * stride + c + u]
                                       : __float2bfloat16(0.f);
    }
  }
}

}  // namespace mma
