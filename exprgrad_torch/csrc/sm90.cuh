// Hopper building blocks shared by the port's sm_90a kernels
// (gemm_sm90.cu, gemm_skinny_sm90.cu): mbarriers, TMA loads, wgmma
// descriptors and fences, and cuTensorMapEncodeTiled looked up
// through the CUDA runtime.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egt_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of parity `phase` has completed.  The
// loop is PTX's own, so the compiler sees no divergent path while a
// consumer's wgmmas are in flight (it would serialize them).  A wait
// that outlasts 2^26 tries (seconds; a stage takes microseconds) traps,
// so a fault in the ring ends the launch with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 tries;\n"
      "mov.u32 tries, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 tries, tries, 1;\n"
      "setp.lt.u32 p, tries, %2;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase), "n"(1 << 26)
      : "memory");
}

// One TMA load of a 4-D box at coordinates (c0, c1, c2, c3), innermost
// first, completion on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A wgmma descriptor of a K-major operand in 128-byte swizzled rows: the
// start address, stride 1024 bytes between 8-row groups, layout 1
// (128-byte swizzle).  A k offset inside the 128-byte row is added to the
// address, as the swizzle is applied to the address the wgmma forms.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes (accumulators, A fragments) across
// its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda); null where it is not found.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace egt_sm90
