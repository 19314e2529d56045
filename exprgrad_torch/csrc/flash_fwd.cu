// Flash-attention forward for Hopper (sm_90a), FP32 FMA on CUDA cores.
//
// Replaces the Pallas TPU kernel exprgrad_tpu/ops/attention.py::_fwd_kernel
// (launched by _forward).  Computes, per (batch, head):
//
//   out = softmax(scale * Q K^T + mask) V        out [b, h, sq, d], q's dtype
//   lse = m + log(l)                             lse [b*h, sq], float32
//
// with a float32 online max and sum over kv tiles.  K/V carry h/group heads
// (grouped-query attention): query head hq reads kv head hq / group.  Masks
// are taken in global positions row = i + q_off, col = j + k_off: causal
// keeps col <= row, a sliding window (window > 0) keeps col > row - window.
// Masked scores take the TPU kernel's constant -1e30.  A row that sees no
// live key anywhere gives out = 0 and lse = -inf, which is what the TPU
// kernel returns for a row whose tiles are all dead.
//
// Layout of the work: one block per (b*h, 32-row q tile), four warps of
// eight query rows each.  The TPU kernel's sequential kv grid axis becomes
// a loop inside the block, and the loop runs only over the live band of kv
// tiles for this q tile (what _tri_schedule and _kv_band enumerate on the
// TPU).  In the score step lane j of a warp owns kv column j of the tile;
// in the P.V step it owns output columns j, j+32, j+64, j+96.
//
// What bounds it: at the serving shape [8, 4, 256, 128] f32 causal the
// call does ~0.54 GFLOP and moves ~17 MB, which the card's FP32 rate
// (67 TFLOP/s) and memory (3.35 TB/s) would finish in under 10 us.  The
// grid is only 256 blocks of four warps, about two per SM, and the last
// q tile walks eight kv tiles where the first walks one; so the time is
// launch and latency (a shared-memory round trip and two block barriers
// per kv tile, with few warps to hide them), not flops or bytes.  The
// design keeps it simple and right: FP32 FMA, as precision="highest"
// asks of float32 (TF32 tensor cores would round the inputs); no async
// copies.  mma.sync/wgmma for bfloat16, and TMA, are later work.

#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace egt_flash;

constexpr int kBlockQ = kTile;  // query rows per block
constexpr int kBlockK = kTile;  // kv rows per tile (one per lane)

// shared memory: Q [kBlockQ][kMaxD], K [kBlockK][kMaxD + 1] (padded so
// lanes reading one column of K hit distinct banks), V [kBlockK][kMaxD],
// P [kBlockQ][kBlockK]
constexpr int kSmemFloats = kBlockQ * kMaxD + kBlockK * (kMaxD + 1) +
                            kBlockK * kMaxD + kBlockQ * kBlockK;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int h, int group, int sq, int skv,
                 int d, float scale, int causal, int window, int q_off,
                 int k_off) {
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + kBlockQ * kMaxD;
  float* s_v = s_k + kBlockK * (kMaxD + 1);
  float* s_p = s_v + kBlockK * kMaxD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int kv_head = (bh / h) * (h / group) + (bh % h) / group;
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)kv_head * skv * d;
  const T* vp = v + (size_t)kv_head * skv * d;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * kRows;

  for (int i = tid; i < kBlockQ * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    s_q[r * kMaxD + c] =
        q0 + r < sq ? to_float(qp[(size_t)(q0 + r) * d + c]) : 0.f;
  }

  // live band of kv tiles for this q tile
  const Band band = kv_band(q0, min(q0 + kBlockQ, sq) - 1, skv, causal,
                            window, q_off, k_off);

  float m[kRows], l[kRows], acc[kRows][kCols];
  bool live[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
    live[rr] = false;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[rr][jj] = 0.f;
  }

  for (int t = band.lo; t <= band.hi; ++t) {
    const int kv0 = t * kBlockK;
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBlockK * d; i += blockDim.x) {
      const int r = i / d, c = i % d;
      const bool in = kv0 + r < skv;
      const size_t at = (size_t)(kv0 + r) * d + c;
      s_k[r * (kMaxD + 1) + c] = in ? to_float(kp[at]) : 0.f;
      s_v[r * kMaxD + c] = in ? to_float(vp[at]) : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against kv column `lane`
    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
    const float* krow = s_k + lane * (kMaxD + 1);
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        s[rr] = fmaf(s_q[(r0 + rr) * kMaxD + c], kc, s[rr]);
    }

    const int col = kv0 + lane + k_off;
    const bool col_in = kv0 + lane < skv;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = q0 + r0 + rr + q_off;
      const bool keep = col_in && attends(row, col, causal, window);
      const float sv = keep ? s[rr] * scale : kMasked;
      const bool any_keep = __any_sync(0xffffffffu, keep);
      live[rr] = live[rr] || any_keep;
      const float m_next = fmaxf(m[rr], warp_max(sv));
      const float alpha = expf(m[rr] - m_next);
      const float p = expf(sv - m_next);
      l[rr] = alpha * l[rr] + warp_sum(p);
      m[rr] = m_next;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[rr][jj] *= alpha;
      s_p[(r0 + rr) * kBlockK + lane] = p;
    }
    __syncwarp();

    for (int c = 0; c < kBlockK; ++c) {
      float vc[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) vc[jj] = s_v[c * kMaxD + lane + 32 * jj];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float p = s_p[(r0 + rr) * kBlockK + c];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[rr][jj] = fmaf(p, vc[jj], acc[rr][jj]);
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = q0 + r0 + rr;
    if (r >= sq) continue;
    const float inv = live[rr] ? 1.f / l[rr] : 0.f;
    T* orow = out + ((size_t)bh * sq + r) * d;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = lane + 32 * jj;
      if (c < d) orow[c] = from_float<T>(acc[rr][jj] * inv);
    }
    if (lane == 0)
      lse[(size_t)bh * sq + r] = live[rr] ? m[rr] + logf(l[rr]) : -INFINITY;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int h, int hkv, int sq, int skv, int d, float scale,
           int causal, int window, int q_off, int k_off,
           cudaStream_t stream) {
  static bool smem_set = false;
  const int err = allow_smem(flash_fwd_kernel<T>, kSmemBytes, &smem_set);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T><<<grid, kWarps * 32, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), h, h / hkv, sq, skv, d, scale, causal,
      window, q_off, k_off);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
// Shapes are checked by the Python wrapper: d <= 128, h % hkv == 0, all
// tensors contiguous, q/k/v of one dtype, lse float32.
extern "C" int egt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int b, int h, int hkv,
                             int sq, int skv, int d, float scale, int causal,
                             int window, int q_off, int k_off, int dtype,
                             void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b * h == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, lse, b, h, hkv, sq, skv, d, scale,
                         causal, window, q_off, k_off, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, lse, b, h, hkv, sq, skv, d,
                                 scale, causal, window, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}
