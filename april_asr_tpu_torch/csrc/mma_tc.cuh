// Tensor-core building blocks for sm_90a: warp-level `mma.sync` on bf16 and
// int8 operands, their operand loads from shared memory (`ldmatrix`), and
// the byte transpose that stages a row-major [k][n] int8 tile as the [n][k]
// layout the int8 B operand needs.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" and
// "mma.m16n8k32"), with g = lane / 4 and q = lane % 4:
//
//   bf16 m16n8k16 -> f32. A [16][16] row-major, 4 registers of 2 bf16:
//     a0 (row g, cols 2q..2q+1), a1 (row g+8, same cols), a2 (row g, cols
//     8+2q..), a3 (row g+8, cols 8+2q..). B [16][8] (k, n), 2 registers:
//     b0 (k 2q..2q+1, col g), b1 (k 8+2q.., col g).
//   s8 m16n8k32 -> s32. A [16][32] row-major, 4 registers of 4 int8:
//     a0 (row g, cols 4q..4q+3), a1 (row g+8), a2 (row g, cols 16+4q..),
//     a3 (row g+8, cols 16+4q..). B [32][8], 2 registers: b0 (k 4q..4q+3,
//     col g), b1 (k 16+4q.., col g).
//   Accumulator C/D [16][8], 4 registers: c0, c1 (row g, cols 2q, 2q+1),
//     c2, c3 (row g+8, the same cols) -- the same for f32 and s32.
//
// In bytes, the s8 A fragment is the bf16 A fragment: register i holds the
// same 4 bytes of the same row. So one `ldmatrix.x4` of a [16 rows][32
// bytes] tile loads either. The B operand is "col": each register holds
// consecutive k of one column n. For bf16 `ldmatrix.trans` reads it from a
// [k][n] row-major tile; `ldmatrix.trans` moves only 16-bit elements, so an
// int8 B tile is staged as [n][k] (`transpose4x4_s8`) and read with the plain
// `ldmatrix`, each 8x8 b16 matrix then being 8 columns n x 16 k-bytes.
#pragma once

#include <stdint.h>

// Shared-memory address of a generic pointer, for ldmatrix (also defined,
// under the same guard, by mbar_ring.cuh)
#ifndef APRIL_SMEM_U32
#define APRIL_SMEM_U32
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
#endif

// Four 8x8 b16 matrices: lanes 8i..8i+7 give the 8 row addresses (16 bytes
// each) of matrix i; r[i] is this lane's pair (row lane/4, cols 2(lane%4)..)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// As ldmatrix_x4, each matrix transposed: r[i] is (col lane/4, rows
// 2(lane%4), 2(lane%4)+1) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a (16x16 bf16) * b (16x8 bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8) * b (32x8 s8), exact s32 accumulate
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 4x4 block of int8 transposed in registers: w[r] holds row r (bytes
// 0..3 = cols 0..3); on return w[j] holds col j (bytes 0..3 = rows 0..3).
__device__ __forceinline__ void transpose4x4_s8(uint32_t (&w)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);  // c0: r0 r1 r2 r3
  w[1] = __byte_perm(lo01, lo23, 0x7632);  // c1
  w[2] = __byte_perm(hi01, hi23, 0x5410);  // c2
  w[3] = __byte_perm(hi01, hi23, 0x7632);  // c3
}
