// Flash-attention backward for Hopper (sm_90a), FP32 FMA on CUDA cores.
//
// Two kernels, which replace the Pallas TPU kernels of
// exprgrad_tpu/ops/attention.py:
//
//   dq  (_bwd_dq_kernel)   dQ = scale * sum_kv P o (dO V^T - delta) K
//   dkv (_bwd_dkv_kernel)  dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q
//
// with P = exp(scale * Q K^T - lse) recomputed from the forward's saved
// lse, dS = P o (dO V^T - delta), and delta = rowsum(dO o O).  The dq
// kernel computes delta in its prologue (it loads the dO tile anyway) and
// writes it out; the dkv kernel, launched after it on the same stream,
// reads it.  Inputs are float32 or bfloat16, sums are float32, gradients
// come out in the inputs' dtype.  Masks, grouped-query heads and global
// offsets are those of flash_fwd.cu (flash_common.cuh).  A row with no
// live key (the forward wrote lse = -inf for it) has P = 0: it gets
// dq = 0 and adds nothing to dk or dv, where exp(-1e30 - lse) would give
// exp(+inf) and then inf * 0 = NaN.
//
// Layout of the work.  The TPU kernels carry their sums in VMEM scratch
// across a sequential grid axis; here that axis is a loop inside the block
// over the live band of tiles (kv_band / q_band):
//
// * dq: one block per (b*h, 32-row q tile), four warps of eight query
//   rows.  In the score step lane j owns kv column j of the tile (S and
//   dO V^T in one pass over head_dim); in the dS K step it owns dq
//   columns j, j+32, j+64, j+96.
// * dkv: one block per (b*hkv, 32-row kv tile), four warps of eight kv
//   rows, with the dK and dV sums in registers.  Under grouped-query
//   attention the block loops over the group's query heads itself, so
//   each kv row is summed by one thread in a fixed order: no partial
//   buffer per query head (the TPU kernel writes [b*h, skv, d] partials
//   and sums them in XLA), no float atomics, and the same bits every run.
//   In the score step lane i owns query row i of the q tile (S^T and
//   (dO V^T)^T); in the update step it owns dk/dv columns i, i+32, ...
//
// What bounds it: at the serving shape [8, 4, 256, 128] f32 causal each
// kernel does about 0.5-0.8 GFLOP and moves about 17-25 MB, which the
// card's FP32 rate (67 TFLOP/s) and memory (3.35 TB/s) would finish in
// about 10 us.  As in the forward, the grid is 256 blocks of four warps
// and the causal band makes the work per block uneven, so the time is
// latency: shared-memory reads (two operands per FMA in the score step)
// and two block barriers per tile, with few warps to hide them.  The
// design keeps it simple and right: FP32 FMA, as precision="highest" asks
// of float32 (TF32 would round the inputs); no async copies.  mma.sync or
// wgmma, TMA and a fused dq+dkv pass are later work.

#include "flash_common.cuh"

namespace {

using namespace egt_flash;

constexpr int kPad = kMaxD + 1;  // a row read one element per lane: pad

// dq shared memory: Q and dO [kTile][kMaxD] (a warp reads one row whole:
// broadcast), K and V [kTile][kPad] (lane j reads row j), dS [kTile][kTile]
constexpr size_t kDqSmemBytes =
    (2 * kTile * kMaxD + 2 * kTile * kPad + kTile * kTile) * sizeof(float);
// dkv shared memory: K and V [kTile][kMaxD], Q and dO [kTile][kPad],
// P^T and dS^T [kTile][kTile]
constexpr size_t kDkvSmemBytes =
    (2 * kTile * kMaxD + 2 * kTile * kPad + 2 * kTile * kTile) *
    sizeof(float);

// rows [row0, row0 + kTile) of a [rows, d] matrix into shared memory with
// row stride `stride`, zero past the last row
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int rows, int d) {
  for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dst[r * stride + c] =
        row0 + r < rows ? to_float(src[(size_t)(row0 + r) * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int h,
                    int group, int sq, int skv, int d, float scale,
                    int causal, int window, int q_off, int k_off) {
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kTile * kMaxD;
  float* s_k = s_do + kTile * kMaxD;
  float* s_v = s_k + kTile * kPad;
  float* s_ds = s_v + kTile * kPad;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int kv_head = (bh / h) * (h / group) + (bh % h) / group;
  const size_t q_base = (size_t)bh * sq * d;
  const T* kp = k + (size_t)kv_head * skv * d;
  const T* vp = v + (size_t)kv_head * skv * d;

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRows;

  load_tile(s_q, kMaxD, q + q_base, q0, sq, d);
  load_tile(s_do, kMaxD, dout + q_base, q0, sq, d);
  __syncthreads();

  // delta = rowsum(dO o O) and lse of this warp's rows
  float row_lse[kRows], row_delta[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = q0 + r0 + rr;
    float part = 0.f;
    if (r < sq) {
      const T* orow = out + q_base + (size_t)r * d;
      for (int c = lane; c < d; c += 32)
        part = fmaf(s_do[(r0 + rr) * kMaxD + c], to_float(orow[c]), part);
    }
    row_delta[rr] = warp_sum(part);
    row_lse[rr] = r < sq ? lse[(size_t)bh * sq + r] : -INFINITY;
    if (lane == 0 && r < sq) delta[(size_t)bh * sq + r] = row_delta[rr];
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[rr][jj] = 0.f;

  const Band band = kv_band(q0, min(q0 + kTile, sq) - 1, skv, causal,
                            window, q_off, k_off);
  for (int t = band.lo; t <= band.hi; ++t) {
    const int kv0 = t * kTile;
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile(s_k, kPad, kp, kv0, skv, d);
    load_tile(s_v, kPad, vp, kv0, skv, d);
    __syncthreads();

    // S and dO V^T of this warp's rows against kv column `lane`
    float s[kRows], dp[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = dp[rr] = 0.f;
    const float* krow = s_k + lane * kPad;
    const float* vrow = s_v + lane * kPad;
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c], vc = vrow[c];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        s[rr] = fmaf(s_q[(r0 + rr) * kMaxD + c], kc, s[rr]);
        dp[rr] = fmaf(s_do[(r0 + rr) * kMaxD + c], vc, dp[rr]);
      }
    }

    const int col = kv0 + lane + k_off;
    const bool col_in = kv0 + lane < skv;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = q0 + r0 + rr + q_off;
      const bool keep = col_in && row_lse[rr] != -INFINITY &&
                        attends(row, col, causal, window);
      const float p = keep ? expf(s[rr] * scale - row_lse[rr]) : 0.f;
      s_ds[(r0 + rr) * kTile + lane] = p * (dp[rr] - row_delta[rr]) * scale;
    }
    __syncwarp();

    // dq += dS K over this tile's kv rows
    for (int c = 0; c < kTile; ++c) {
      float kc[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) kc[jj] = s_k[c * kPad + lane + 32 * jj];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float ds = s_ds[(r0 + rr) * kTile + c];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[rr][jj] = fmaf(ds, kc[jj], acc[rr][jj]);
      }
    }
    __syncwarp();  // dS is rewritten by the next tile
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = q0 + r0 + rr;
    if (r >= sq) continue;
    T* row = dq + q_base + (size_t)r * d;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = lane + 32 * jj;
      if (c < d) row[c] = from_float<T>(acc[rr][jj]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int group, int sq, int skv,
                     int d, float scale, int causal, int window, int q_off,
                     int k_off) {
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTile * kMaxD;
  float* s_q = s_v + kTile * kMaxD;
  float* s_do = s_q + kTile * kPad;
  float* s_pt = s_do + kTile * kPad;
  float* s_dst = s_pt + kTile * kTile;

  const int bkv = blockIdx.x;  // batch * hkv + kv head
  const int kv0 = blockIdx.y * kTile;
  const int hkv = h / group;
  const int head0 = (bkv / hkv) * h + (bkv % hkv) * group;  // first q head
  const size_t kv_base = (size_t)bkv * skv * d;

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRows;

  // this tile's K and V; the first barrier of the q loop publishes them
  load_tile(s_k, kMaxD, k + kv_base, kv0, skv, d);
  load_tile(s_v, kMaxD, v + kv_base, kv0, skv, d);

  float acc_k[kRows][kCols], acc_v[kRows][kCols];
#pragma unroll
  for (int jr = 0; jr < kRows; ++jr)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc_k[jr][cc] = acc_v[jr][cc] = 0.f;

  const Band band = q_band(kv0, min(kv0 + kTile, skv) - 1, sq, causal,
                           window, q_off, k_off);
  for (int g = 0; g < group; ++g) {
    const int bh = head0 + g;
    const size_t q_base = (size_t)bh * sq * d;
    for (int t = band.lo; t <= band.hi; ++t) {
      const int qs = t * kTile;
      __syncthreads();  // the previous tile's Q/dO reads are done
      load_tile(s_q, kPad, q + q_base, qs, sq, d);
      load_tile(s_do, kPad, dout + q_base, qs, sq, d);
      __syncthreads();

      // lane i owns query row qs + i: S^T and (dO V^T)^T of this warp's
      // kv rows against it
      const int qi = qs + lane;
      const float row_lse = qi < sq ? lse[(size_t)bh * sq + qi] : -INFINITY;
      const float row_delta = qi < sq ? delta[(size_t)bh * sq + qi] : 0.f;
      float s[kRows], dp[kRows];
#pragma unroll
      for (int jr = 0; jr < kRows; ++jr) s[jr] = dp[jr] = 0.f;
      const float* qrow = s_q + lane * kPad;
      const float* dorow = s_do + lane * kPad;
      for (int c = 0; c < d; ++c) {
        const float qc = qrow[c], doc = dorow[c];
#pragma unroll
        for (int jr = 0; jr < kRows; ++jr) {
          s[jr] = fmaf(s_k[(r0 + jr) * kMaxD + c], qc, s[jr]);
          dp[jr] = fmaf(s_v[(r0 + jr) * kMaxD + c], doc, dp[jr]);
        }
      }

      const int row = qi + q_off;
#pragma unroll
      for (int jr = 0; jr < kRows; ++jr) {
        const int j = kv0 + r0 + jr;
        const bool keep = qi < sq && j < skv && row_lse != -INFINITY &&
                          attends(row, j + k_off, causal, window);
        const float p = keep ? expf(s[jr] * scale - row_lse) : 0.f;
        s_pt[(r0 + jr) * kTile + lane] = p;
        s_dst[(r0 + jr) * kTile + lane] = p * (dp[jr] - row_delta) * scale;
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q over this tile's query rows
      for (int i = 0; i < kTile; ++i) {
        float qv[kCols], dov[kCols];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          qv[cc] = s_q[i * kPad + lane + 32 * cc];
          dov[cc] = s_do[i * kPad + lane + 32 * cc];
        }
#pragma unroll
        for (int jr = 0; jr < kRows; ++jr) {
          const float p = s_pt[(r0 + jr) * kTile + i];
          const float ds = s_dst[(r0 + jr) * kTile + i];
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            acc_v[jr][cc] = fmaf(p, dov[cc], acc_v[jr][cc]);
            acc_k[jr][cc] = fmaf(ds, qv[cc], acc_k[jr][cc]);
          }
        }
      }
      __syncwarp();  // P^T and dS^T are rewritten by the next tile
    }
  }

#pragma unroll
  for (int jr = 0; jr < kRows; ++jr) {
    const int j = kv0 + r0 + jr;
    if (j >= skv) continue;
    T* krow = dk + kv_base + (size_t)j * d;
    T* vrow = dv + kv_base + (size_t)j * d;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) {
        krow[c] = from_float<T>(acc_k[jr][cc]);
        vrow[c] = from_float<T>(acc_v[jr][cc]);
      }
    }
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, void* delta, void* dq,
              int b, int h, int hkv, int sq, int skv, int d, float scale,
              int causal, int window, int q_off, int k_off,
              cudaStream_t stream) {
  static bool smem_set = false;
  const int err =
      allow_smem(flash_bwd_dq_kernel<T>, kDqSmemBytes, &smem_set);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T><<<grid, kWarps * 32, kDqSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), h, h / hkv, sq, skv,
      d, scale, causal, window, q_off, k_off);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int b, int h, int hkv, int sq, int skv,
               int d, float scale, int causal, int window, int q_off,
               int k_off, cudaStream_t stream) {
  static bool smem_set = false;
  const int err =
      allow_smem(flash_bwd_dkv_kernel<T>, kDkvSmemBytes, &smem_set);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(b * hkv, (skv + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T><<<grid, kWarps * 32, kDkvSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, h / hkv, sq, skv, d,
      scale, causal, window, q_off, k_off);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Both return a cudaError_t
// (0 = success).  Shapes are checked by the Python wrapper: d <= 128,
// h % hkv == 0, all tensors contiguous, q/k/v/out/dout of one dtype,
// lse and delta float32 [b*h, sq].
//
// egt_flash_bwd_dq writes dq [b, h, sq, d] and delta [b*h, sq].
extern "C" int egt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* out, const void* dout,
                                const void* lse, void* delta, void* dq,
                                int b, int h, int hkv, int sq, int skv,
                                int d, float scale, int causal, int window,
                                int q_off, int k_off, int dtype,
                                void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b * h == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, out, dout, lse, delta, dq, b, h, hkv,
                            sq, skv, d, scale, causal, window, q_off, k_off,
                            s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, b,
                                    h, hkv, sq, skv, d, scale, causal,
                                    window, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}

// egt_flash_bwd_dkv writes dk and dv [b, hkv, skv, d]; it reads the delta
// that egt_flash_bwd_dq wrote.
extern "C" int egt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int b, int h, int hkv,
                                 int sq, int skv, int d, float scale,
                                 int causal, int window, int q_off,
                                 int k_off, int dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (b * hkv == 0 || skv == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, b, h, hkv,
                             sq, skv, d, scale, causal, window, q_off, k_off,
                             s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b,
                                     h, hkv, sq, skv, d, scale, causal,
                                     window, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}
