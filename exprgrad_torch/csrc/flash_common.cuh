// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, float conversions, warp reductions, the attention mask and the
// bands of live tiles.
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

namespace egt_flash {

constexpr int kTile = 32;                 // rows of a q or kv tile
constexpr int kMaxD = 128;                // largest head_dim taken
constexpr int kWarps = 4;
constexpr int kRows = kTile / kWarps;     // tile rows per warp
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
                                               int k_off, int tile = kTile) {
  int c_lo = 0, c_hi = skv - 1;
  if (window > 0) c_lo = max(c_lo, r_first + q_off - window + 1 - k_off);
  if (causal) c_hi = min(c_hi, r_last + q_off - k_off);
  if (c_hi < c_lo) return {0, -1};
  return {c_lo / tile, c_hi / tile};
}

// q tiles holding a live query for the local kv columns [c_first, c_last]
static __device__ __forceinline__ Band q_band(int c_first, int c_last,
                                              int sq, int causal, int window,
                                              int q_off, int k_off) {
  int r_lo = 0, r_hi = sq - 1;
  if (causal) r_lo = max(r_lo, c_first + k_off - q_off);
  if (window > 0) r_hi = min(r_hi, c_last + k_off + window - 1 - q_off);
  if (r_hi < r_lo) return {0, -1};
  return {r_lo / kTile, r_hi / kTile};
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
