// Mamba-1 mixer kernels for Hopper (sm_90a): the causal depthwise conv and
// the selective scan, for prefill over a bucket of rows and for the decode
// step inside the continuous batcher's CUDA graph, in float32 on the CUDA
// cores.
//
// Replaces no TPU kernel: the JAX package has no state-space layer.  It was
// added for AI21-Jamba2-Mini (7 of every 8 mixers are Mamba-1), whose
// serving path would otherwise scan a 1,024-token prompt as a Python loop
// of about 6,000 launches a layer.
//
// mamba_conv_kernel, for each row r and channel c (one thread each):
//
//   win   = the row's conv state [k-1] (its last k-1 inputs), then x[r, t]
//   out   = silu(bias[c] + sum_j w[c, j] * win[t + j])     t < len[r]
//   out   = 0                                               len[r] <= t
//   state = the window's last k-1 inputs after len[r] of them
//
// mamba_scan_kernel, for each row r and channel c (one thread each, the
// d_state values of its state in registers):
//
//   delta = softplus(dt[r, t, c] + dt_bias[c])     (x past 20 is x, as
//                                                   torch's softplus)
//   s[n]  = exp(delta * A[c, n]) * s[n] + delta * x[r, t, c] * B[r, t, n]
//   y     = (sum_n s[n] * C[r, t, n] + D[c] * x[r, t, c]) * silu(z[r, t, c])
//
// with A = -exp(a_log), for t < len[r]; positions at or past len[r] write
// y = 0 and leave the state as it was, so bucket padding never moves it and
// a row of length 0 (a parked decode row) is not touched at all.  The state
// [b, d, n] is read at the start and written at the end of the row, in
// place.  A block takes 64 channels of one row; B and C of 32 positions at
// a time are staged in shared memory, read by every thread of the block.
//
// x and z may be strided views (the two halves of in_proj's output): the
// wrapper passes their row and position strides in elements, and the
// channel stride is 1.  Every other tensor is contiguous.  No atomics, no
// reduction across threads: two runs give the same bits.
//
// What bounds them: memory.  A prefill row of L positions reads x, dt, z
// (12 L d bytes) and writes y (4 L d); a decode step reads and writes the
// slots' states (2 * 4 d n bytes a row, 1 MB at d 8192, n 16) against about
// 7 n operations a channel and position, far below the 20 operations a
// byte at which the CUDA cores' 67 TFLOP/s would bound them
// (portbench/flops_hybrid.py counts both).  At prefill, one row of 8,192
// channels is 128 blocks of 64 threads: a sequential walk over the
// positions, latency-bound, about as many blocks as the card has SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;   // channels a block
constexpr int kTile = 32;      // positions of B and C staged at a time
constexpr int kMaxConv = 8;    // largest d_conv taken

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

__global__ void __launch_bounds__(kThreads)
    mamba_conv_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, float* state,
                      const int* __restrict__ lengths,
                      float* __restrict__ out, int t, int d, int k,
                      int x_sb, int x_st) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= d) return;
  const int len = min(max(lengths[r], 0), t);
  const int keep = k - 1;
  float wc[kMaxConv], win[kMaxConv];
  for (int j = 0; j < k; ++j) wc[j] = w[(long long)c * k + j];
  float* st = state + ((long long)r * d + c) * keep;
  for (int j = 0; j < keep; ++j) win[j] = st[j];
  const float bc = bias[c];
  const float* xr = x + (long long)r * x_sb + c;
  float* orow = out + (long long)r * t * d + c;
  for (int i = 0; i < len; ++i) {
    const float xi = xr[(long long)i * x_st];
    float acc = bc;
    for (int j = 0; j < keep; ++j) acc += wc[j] * win[j];
    acc += wc[keep] * xi;
    for (int j = 0; j + 1 < keep; ++j) win[j] = win[j + 1];
    if (keep > 0) win[keep - 1] = xi;
    orow[(long long)i * d] = silu(acc);
  }
  for (int i = len; i < t; ++i) orow[(long long)i * d] = 0.0f;
  if (len > 0)
    for (int j = 0; j < keep; ++j) st[j] = win[j];
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ z,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_log,
                      const float* __restrict__ dskip,
                      const float* __restrict__ dt_bias, float* state,
                      const int* __restrict__ lengths,
                      float* __restrict__ y, int t, int d, int x_sb,
                      int x_st, int z_sb, int z_st) {
  __shared__ float sb[kTile][N];
  __shared__ float sc[kTile][N];
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int r = blockIdx.y;
  const bool on = c < d;
  const int len = min(max(lengths[r], 0), t);
  float a[N], s[N];
  float* st = state + ((long long)r * d + (on ? c : 0)) * N;
  float db = 0.0f, dd = 0.0f;
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n] = -expf(a_log[(long long)c * N + n]);
      s[n] = st[n];
    }
    db = dt_bias[c];
    dd = dskip[c];
  }
  const float* xr = x + (long long)r * x_sb + c;
  const float* zr = z + (long long)r * z_sb + c;
  const float* dtr = dt + (long long)r * t * d + c;
  const float* br = bm + (long long)r * t * N;
  const float* cr = cm + (long long)r * t * N;
  float* yr = y + (long long)r * t * d + c;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int span = min(kTile, len - t0);
    __syncthreads();  // the previous tile is read
    for (int e = threadIdx.x; e < span * N; e += kThreads) {
      sb[e / N][e % N] = br[(long long)t0 * N + e];
      sc[e / N][e % N] = cr[(long long)t0 * N + e];
    }
    __syncthreads();
    if (!on) continue;
    for (int i = 0; i < span; ++i) {
      const long long p = t0 + i;
      const float xv = xr[p * x_st];
      const float delta = softplus(dtr[p * d] + db);
      const float dx = delta * xv;
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        s[n] = expf(delta * a[n]) * s[n] + dx * sb[i][n];
        acc += s[n] * sc[i][n];
      }
      yr[p * d] = (acc + dd * xv) * silu(zr[p * z_st]);
    }
  }
  if (!on) return;
  for (int i = len; i < t; ++i) yr[(long long)i * d] = 0.0f;
  if (len > 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) st[n] = s[n];
  }
}

template <int N>
cudaError_t launch_scan(const float* x, const float* dt, const float* z,
                        const float* bm, const float* cm, const float* a_log,
                        const float* dskip, const float* dt_bias,
                        float* state, const int* lengths, float* y, int b,
                        int t, int d, int x_sb, int x_st, int z_sb, int z_st,
                        cudaStream_t s) {
  dim3 grid((d + kThreads - 1) / kThreads, b);
  mamba_scan_kernel<N><<<grid, kThreads, 0, s>>>(
      x, dt, z, bm, cm, a_log, dskip, dt_bias, state, lengths, y, t, d,
      x_sb, x_st, z_sb, z_st);
  return cudaGetLastError();
}

}  // namespace

extern "C" int egt_mamba_conv(const void* x, const void* w, const void* bias,
                              void* state, const void* lengths, void* out,
                              int b, int t, int d, int k, int x_sb, int x_st,
                              void* stream) {
  if (k < 1 || k > kMaxConv || d < 1) return (int)cudaErrorInvalidValue;
  if (b == 0 || t == 0) return (int)cudaSuccess;
  dim3 grid((d + kThreads - 1) / kThreads, b);
  mamba_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(state),
      static_cast<const int*>(lengths), static_cast<float*>(out), t, d, k,
      x_sb, x_st);
  return (int)cudaGetLastError();
}

extern "C" int egt_mamba_scan(const void* x, const void* dt, const void* z,
                              const void* bm, const void* cm,
                              const void* a_log, const void* dskip,
                              const void* dt_bias, void* state,
                              const void* lengths, void* y, int b, int t,
                              int d, int n, int x_sb, int x_st, int z_sb,
                              int z_st, void* stream) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (b == 0 || t == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(x),
                      static_cast<const float*>(dt),
                      static_cast<const float*>(z),
                      static_cast<const float*>(bm),
                      static_cast<const float*>(cm),
                      static_cast<const float*>(a_log),
                      static_cast<const float*>(dskip),
                      static_cast<const float*>(dt_bias)};
  float* st = static_cast<float*>(state);
  const int* lens = static_cast<const int*>(lengths);
  float* out = static_cast<float*>(y);
  switch (n) {
    case 16:
      return (int)launch_scan<16>(f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                  f[7], st, lens, out, b, t, d, x_sb, x_st,
                                  z_sb, z_st, s);
    case 8:
      return (int)launch_scan<8>(f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                 f[7], st, lens, out, b, t, d, x_sb, x_st,
                                 z_sb, z_st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
