// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): cp.async copies into padded
// bf16 tiles, ldmatrix fragment loads, the mma.sync.m16n8k16 bf16 -> f32
// product, and the hi/lo split of a float32 operand.
//
// Fragments of mma.sync.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A (16 x 16, row-major), 4 registers of 2 bf16: (row g, cols 2t, 2t+1),
//     (row g + 8, cols 2t..), (row g, cols 8 + 2t..), (row g + 8, 8 + 2t..);
//   B (16 x 8, k by n), 2 registers: (k 2t, 2t+1; n g), (k 8 + 2t..; n g);
//   C (16 x 8) float32: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8.
// So the C fragments of two neighbouring 8-column tiles are, pairwise, the
// A fragment of a 16-deep step of the next product: a score tile becomes
// the left operand of P V without leaving the registers.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zeros when !full (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// 4 bytes global -> shared; zeros when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [pos0, pos0 + nrows) of a (S, d)-row-strided bf16 operand into a
// shared tile of stride sstride, zero past S and in the columns [d, dp)
// (dp a multiple of 16).  vec: 16-byte cp.async copies (d a multiple of 8,
// the operand 16-byte aligned); else plain loads and stores.
__device__ __forceinline__ void load_tile(bf16* dst, int sstride,
                                          const bf16* src,
                                          long long row_stride, int pos0,
                                          int nrows, int d, int dp, int S,
                                          bool vec, int tid, int nthreads) {
  const int cpr = dp >> 3;  // 8-element chunks per row
  const int total = nrows * cpr;
  for (int i = tid; i < total; i += nthreads) {
    const int r = i / cpr;
    const int c = (i - r * cpr) << 3;
    const int pos = pos0 + r;
    bf16* out = dst + r * sstride + c;
    const bf16* in = src + (long long)pos * row_stride + c;
    if (vec) {
      const bool full = pos < S && c < d;
      cp_async16(out, full ? in : src, full);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = (pos < S && c + e < d) ? in[e] : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b (16 x 8 x 16, bf16 operands, float32 accumulator)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16(x, y), lo = bf16((x, y) - hi): hi + lo is (x, y) to
// ~2^-17 of each (x - hi is exact in float32; rounding it loses 2^-9 of it)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of a 16-deep step from the C fragments of two
// neighbouring 8-column tiles c0 (columns 0-7) and c1 (8-15).
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// Where lane `lane` points for ldmatrix.x4 of a 16 x 16 block at (r0, c0)
// of a row-major tile with stride `stride`:
//   a_addr: the A fragment (matrices: rows 0-7 / 8-15 x cols 0-7, then the
//     same x cols 8-15);
//   b_addr: the B fragments of two 8-row tiles of a tile stored n by k
//     (rows 0-7 x cols 0-7, rows 0-7 x 8-15, rows 8-15 x 0-7, 8-15 x 8-15),
//     which .x4 (not .trans) returns as b0, b1 of rows 0-7 and of rows 8-15;
//   the .trans loads of a tile stored k by n (the B operand of P V) use
//     a_addr: b0, b1 of columns 0-7, then of columns 8-15.
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int stride,
                                              int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + c0 +
         (lane >> 4) * 8;
}

__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int stride,
                                              int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + (lane >> 4) * 8) * stride + c0 +
         ((lane >> 3) & 1) * 8;
}

// Whether every operand pointer is 16-byte aligned
__device__ __host__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

}  // namespace tc
