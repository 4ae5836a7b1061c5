// PTX wrappers for tiles staged in shared memory and multiplied on the
// tensor cores (sm_80+ instructions, all present on sm_90a): 16-byte
// `cp.async` with zero fill, `ldmatrix` (plain and transposed) and
// `mma.sync` m16n8k16 in bf16 with f32 accumulators, plus the XOR swizzle
// of 16-byte chunks that keeps `ldmatrix` free of bank conflicts.
//
// Included by the kernels that use it; `_build.py` hashes every `.cuh`
// into every library's name, so an edit here rebuilds them all.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared, bypassing L1.  With `pred` false no byte
// is read and the 16 shared bytes are zero-filled (source size 0); `src`
// must still be a valid address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l/4, columns 2(l%4), 2(l%4)+1 of it
// (with .trans: column l/4, rows 2(l%4), 2(l%4)+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row major) * b (16x8, column major); bf16 in, f32 out.
// Lane l (g = l/4, t = l%4) holds a: {(g, 2t..), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}, b: {(2t.., g), (2t+8.., g)}, d: {(g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (about 2 ulp; a subnormal result is 0, and
// 2^-inf = +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 and packed, `lo` in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile whose rows are
// `row_bytes` long (a multiple of 128): the chunk index is XORed with
// row % 8, so the 8 rows one `ldmatrix` matrix reads at one logical chunk
// land in 8 distinct 16-byte bank groups.
__device__ __forceinline__ uint32_t swz(int row, int chunk, int row_bytes) {
  return static_cast<uint32_t>(row * row_bytes + ((chunk ^ (row & 7)) << 4));
}

}  // namespace
