// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// float conversions, warp reductions, the attention mask, the bands of live
// tiles, the loads and splits of shared tiles and the P . V product.
//
// Positions are global: query row i is at i + q_off, key column j at
// j + k_off.  Causal keeps col <= row; a sliding window (window > 0) keeps
// col > row - window.  The bands replace the TPU kernels' _tri_schedule,
// _kv_band and _q_band (exprgrad_tpu/ops/attention.py): a block walks only
// the tiles that hold a live (row, col) pair.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace egt_flash {

constexpr int kMaxD = 128;                // largest head_dim taken
constexpr int kCols = kMaxD / 32;         // head_dim columns per lane
constexpr float kMasked = -1e30f;         // ops/attention.py _NEG_INF

static __device__ __forceinline__ float to_float(float x) { return x; }
static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

static __device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

static __device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// does global query row `row` attend global key column `col`?
static __device__ __forceinline__ bool attends(int row, int col,
                                               int causal, int window) {
  return (!causal || col <= row) && (window <= 0 || col > row - window);
}

// an inclusive range of tile indices; empty when hi < lo
struct Band {
  int lo, hi;
};

// kv tiles of `tile` rows holding a live key for the local query rows
// [r_first, r_last]
static __device__ __forceinline__ Band kv_band(int r_first, int r_last,
                                               int skv, int causal,
                                               int window, int q_off,
                                               int k_off, int tile) {
  int c_lo = 0, c_hi = skv - 1;
  if (window > 0) c_lo = max(c_lo, r_first + q_off - window + 1 - k_off);
  if (causal) c_hi = min(c_hi, r_last + q_off - k_off);
  if (c_hi < c_lo) return {0, -1};
  return {c_lo / tile, c_hi / tile};
}

// q tiles of `tile` rows holding a live query for the local kv columns
// [c_first, c_last]
static __device__ __forceinline__ Band q_band(int c_first, int c_last,
                                              int sq, int causal, int window,
                                              int q_off, int k_off,
                                              int tile) {
  int r_lo = 0, r_hi = sq - 1;
  if (causal) r_lo = max(r_lo, c_first + k_off - q_off);
  if (window > 0) r_hi = min(r_hi, c_last + k_off + window - 1 - q_off);
  if (r_hi < r_lo) return {0, -1};
  return {r_lo / tile, r_hi / tile};
}

static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Rows [r0, r0 + n) of a [rows, d] matrix into a shared tile of row
// stride ld, by a block of kThreads; rows past `rows` are zero.  Columns
// [d, kMaxD) are not written (the kernels zero them once).  vec: 16-byte
// cp.async (the caller commits and waits), else plain loads.
template <int kThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int r0, int n, int rows, int d,
                                          bool vec, int tid) {
  if (vec) {
    // walk whole kMaxD-wide rows, so the index math is shifts, and skip
    // the chunks past d
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kRow = kMaxD / kPer;
    for (int i = tid; i < n * kRow; i += kThreads) {
      const int r = i / kRow, c = (i % kRow) * kPer;
      if (c >= d) continue;
      const bool in = r0 + r < rows;
      egt_mma::cp_async16(dst + r * ld + c,
                          in ? src + (size_t)(r0 + r) * d + c : src,
                          in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < n * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      dst[r * ld + c] =
          r0 + r < rows ? src[(size_t)(r0 + r) * d + c] : from_float<T>(0.f);
    }
  }
}

// zero columns [d, kMaxD) of `rows` rows of stride ld
template <int kThreads, typename T>
__device__ __forceinline__ void zero_pad(T* dst, int rows, int ld, int d,
                                         int tid) {
  const int pad = kMaxD - d;
  for (int i = tid; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    dst[r * ld + d + i - r * pad] = from_float<T>(0.f);
  }
}

// float32: `rows` rows of stride ld in place into their TF32 big parts,
// and the small parts beside them; bfloat16 tiles are read as they are.
// The caller synchronizes after.
template <int kThreads>
__device__ __forceinline__ void split_rows(float* big, float* small,
                                           int rows, int ld, int tid) {
  for (int i = tid; i < rows * kMaxD; i += kThreads) {
    const int at = (i / kMaxD) * ld + i % kMaxD;
    uint32_t b, s;
    egt_mma::split_tf32(big[at], b, s);
    big[at] = __uint_as_float(b);
    small[at] = __uint_as_float(s);
  }
}

template <int kThreads>
__device__ __forceinline__ void split_rows(__nv_bfloat16*, __nv_bfloat16*,
                                           int, int, int) {}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// o = alpha * o + P V for a warp's 16 rows over the first kD columns: p
// holds the accumulator fragments of a 16 x 8kNT product (k = the kNT * 8
// rows of the shared tile tv, of row stride ld).  Each 8-column n-tile of
// P V is summed in a fresh accumulator and added to o in float32 with
// round-to-nearest: the tensor cores truncate each MMA's sum, and a long
// loop into one accumulator would add that bias up.  alpha = 1 adds
// exactly (fmaf(o, 1, x) = o + x).
template <int kD, int kNT, int ld>
__device__ __forceinline__ void pv(float (&o)[kD / 8][4],
                                   const float (&p)[kNT][4],
                                   const float (&alpha)[2], const float* tv,
                                   int g, int t) {
  using namespace egt_mma;
  // (c0, c2, c1, c3) of n-tile ks are P's (a0, a1, a2, a3) under the
  // permuted k: rows 2t and 2t+1 of the tile are logical t and t+4
  uint32_t pb[kNT][4], ps[kNT][4];
#pragma unroll
  for (int ks = 0; ks < kNT; ++ks) {
    split_tf32(p[ks][0], pb[ks][0], ps[ks][0]);
    split_tf32(p[ks][2], pb[ks][1], ps[ks][1]);
    split_tf32(p[ks][1], pb[ks][2], ps[ks][2]);
    split_tf32(p[ks][3], pb[ks][3], ps[ks][3]);
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kNT; ++ks) {
      const float* v0 = tv + (8 * ks + 2 * t) * ld + 8 * j + g;
      uint32_t bb[2], bs[2];
      split_tf32(v0[0], bb[0], bs[0]);
      split_tf32(v0[ld], bb[1], bs[1]);
      mma_tf32x3(acc, pb[ks], ps[ks], bb, bs);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], acc[e]);
  }
}

// bfloat16: P rounded to bfloat16, m16n8k16
template <int kD, int kNT, int ld>
__device__ __forceinline__ void pv(float (&o)[kD / 8][4],
                                   const float (&p)[kNT][4],
                                   const float (&alpha)[2],
                                   const __nv_bfloat16* tv, int g, int t) {
  using namespace egt_mma;
  uint32_t af[kNT / 2][4];
#pragma unroll
  for (int ks = 0; ks < kNT / 2; ++ks) {
    af[ks][0] = pack_bf16(p[2 * ks][0], p[2 * ks][1]);
    af[ks][1] = pack_bf16(p[2 * ks][2], p[2 * ks][3]);
    af[ks][2] = pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    af[ks][3] = pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kNT / 2; ++ks) {
      const __nv_bfloat16* v0 = tv + (16 * ks + 2 * t) * ld + 8 * j + g;
      const uint32_t bf[2] = {pack_bf16(v0[0], v0[ld]),
                              pack_bf16(v0[8 * ld], v0[9 * ld])};
      mma_bf16(acc, af[ks], bf);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], acc[e]);
  }
}

// raise a kernel's dynamic shared-memory limit once (above 48 KB it must be
// asked for); returns a cudaError_t
template <typename Kernel>
static int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return (int)err;
}

}  // namespace egt_flash
