// Tensor-core products for the port's kernels (flash_fwd.cu, matmul.cu):
// mma.sync wrappers, bfloat16 packing, cp.async, and float32 as split
// TF32 ("3xTF32", CUTLASS's OpMultiplyAddFastF32).
//
// float32 under precision="highest" must keep float32's accuracy, and a
// TF32 product keeps only 10 mantissa bits of each input.  So each float32
// operand x is split in two TF32 values,
//
//   big = rna(x),  small = rna(x - big)      (rna: cvt.rna.tf32.f32)
//
// and a product is big*big + big*small + small*big, summed in float32 by
// three m16n8k8 TF32 MMAs (small*small, about 2^-22 relative, is dropped).
// Each part errs by at most 2^-22 relative, so a product errs by about
// 2^-21: float32's own accumulation error dominates.  big must be the
// rounded value the MMA reads exactly: fed the raw x, the tensor core drops
// its low 13 bits while small was taken against the rounded value, and
// half the products then err by a TF32 step (2^-11).
// tests/test_torch_tf32x3.py emulates the arithmetic on the CPU
// (exprgrad_torch/ops/tf32.py).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8/k16"):
// lane = 4 * g + t (g = groupID 0..7, t = threadID_in_group 0..3).
//   C/D 16x8 f32:     c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   A 16x8 tf32:      a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8 tf32:       b0 (t, g), b1 (t+4, g)
//   A 16x16 bf16:     a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                     a3 (g+8, 2t+8..)     (low half = lower column)
//   B 16x8 bf16:      b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
// The sum over k does not depend on the order of k, so the kernels feed
// the TF32 MMA a permuted k: logical k = t is physical 2t and logical
// t+4 is physical 2t+1.  A's pair (a0, a2) is then two neighbouring
// floats (one 8-byte load), and a C fragment (c0, c1 | c2, c3) is already
// the A fragment (a0, a2 | a1, a3) of the next product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace egt_mma {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 values (low 13 mantissa bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a . b, one m16n8k8 TF32 MMA with a float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in split TF32: the two small terms first, then big . big
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// d += a . b, one m16n8k16 bfloat16 MMA with a float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bfloat16 values in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// 16-byte asynchronous copy to shared memory; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace egt_mma
