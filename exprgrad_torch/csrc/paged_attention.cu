// Paged decode attention for Hopper (sm_90a), FP32 FMA on CUDA cores.
//
// Replaces the Pallas TPU kernel exprgrad_tpu/ops/paged_attention.py::_kernel
// (launched by paged_decode_attention).  For each batch row b and kv head g
// it attends the group's query rows against the row's pages in place:
//
//   out = softmax(scale * q K^T, masked) V       out [b, h, t, d], q's dtype
//
// K and V live in a page pool [n_pages, hkv, page, d] (float32, bfloat16, or
// int8 with per-slot float32 scales [n_pages, hkv, page]); the row's virtual
// slot s is slot s % page of page table[b, s / page], and table entries < 0
// are unallocated.  key_pos [b, P*page] gives each virtual slot's position
// (-1 = dead); q_pos [b, t] the query tokens' positions.  A query at position
// qp sees a key at kp when kp >= 0, kp <= qp and, with a window, kp > qp -
// window.  Query row r of kv head g is query head g*group + r/t, token r%t
// (the JAX kernel's q.reshape(b, hkv, group*t, d)).  Softmax runs in float32
// with an online max and sum; a row that sees no live key gives 0, the rule
// of the flash kernels (the TPU kernel gives the mean of the visited V).
//
// Layout of the work: one block per (b*hkv, 8-row slice of the group*t query
// rows), four warps.  Each warp walks its own 32-slot chunks of the row's
// virtual slots (chunk w, w+4, ...), lane j owning slot j of a chunk: it
// skips a chunk in which no query row sees a key (unallocated and dead
// slots, positions past the query, slots behind the window), stages the
// others' K and V rows in shared memory as float (dequantized per slot),
// scores them against the rows held in registers and keeps its own online
// max, sum and P.V accumulator.  The four warps' partial softmaxes are
// merged through shared memory at the end.  The TPU kernel's sequential
// page axis becomes this loop; its padded query rows and 128-lane scratch
// have no counterpart.
//
// What bounds it: at bench.py's shape (b 8, hkv 8, group 1, d 128, 16
// pages of 128 bfloat16 slots a row) a call moves 67 MB of K and V and does
// 67 MFLOP, so the card's memory (3.35 TB/s) bounds it at about 20 us.  The
// grid is only b*hkv blocks (64 there, 32 at the serving step) on 132 SMs,
// with four warps each and one load stream per warp, so it cannot reach
// that: latency, not bytes, sets the time.  Split-K over pages
// (flash-decoding), wgmma and TMA are later work.

#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace egt_flash;

constexpr int kPWarps = 4;
constexpr int kChunk = 32;    // virtual slots a warp takes at once, one a lane
constexpr int kMaxRows = 8;   // query rows a block holds

// shared memory: the block's query rows [kMaxRows][kMaxD], then for each warp
// a K chunk [kChunk][kMaxD + 1] (padded so lanes reading one column of K hit
// distinct banks) and a V chunk [kChunk][kMaxD]
constexpr int kWarpFloats = kChunk * (kMaxD + 1) + kChunk * kMaxD;
constexpr size_t kSmemBytes =
    (kMaxRows * kMaxD + kPWarps * kWarpFloats) * sizeof(float);

static __device__ __forceinline__ float kv_float(float x) { return x; }
static __device__ __forceinline__ float kv_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
static __device__ __forceinline__ float kv_float(int8_t x) {
  return (float)x;
}

// 16 bytes of K or V as floats (4 float32, 8 bfloat16 or 16 int8 values)
static __device__ __forceinline__ void unpack16(const uint4& raw,
                                                float* dst, float) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
static __device__ __forceinline__ void unpack16(const uint4& raw,
                                                float* dst, __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
static __device__ __forceinline__ void unpack16(const uint4& raw,
                                                float* dst, int8_t) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
  }
}

// Stage the chunk's K and V rows in shared memory as float.  rows[j] is the
// pool row (page * hkv + head) * page_size + offset of slot j, or -1 for a
// slot no query row sees: it is not read and stages as zeros.  scales[j]
// dequantizes slot j (1 for float pools).  vec: d * sizeof(T) is a multiple
// of 16 bytes and both pools are 16-byte aligned, so each lane loads 16
// bytes at a time.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ k, const T* __restrict__ v,
    const long long* rows, const float* k_sc, const float* v_sc, int d,
    int vec, float* s_k, float* s_v, int lane) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int units = d / kV;
    for (int i = lane; i < kChunk * units; i += 32) {
      const int j = i / units, c = (i % units) * kV;
      float kf[kV], vf[kV];
      if (rows[j] >= 0) {
        const size_t at = (size_t)rows[j] * d + c;
        unpack16(__ldg(reinterpret_cast<const uint4*>(k + at)), kf, T());
        unpack16(__ldg(reinterpret_cast<const uint4*>(v + at)), vf, T());
      } else {
#pragma unroll
        for (int x = 0; x < kV; ++x) kf[x] = vf[x] = 0.f;
      }
#pragma unroll
      for (int x = 0; x < kV; ++x) {
        s_k[j * (kMaxD + 1) + c + x] = kf[x] * k_sc[j];
        s_v[j * kMaxD + c + x] = vf[x] * v_sc[j];
      }
    }
    return;
  }
  for (int i = lane; i < kChunk * d; i += 32) {
    const int j = i / d, c = i % d;
    const bool in = rows[j] >= 0;
    const size_t at = in ? (size_t)rows[j] * d + c : 0;
    s_k[j * (kMaxD + 1) + c] = in ? kv_float(k[at]) * k_sc[j] : 0.f;
    s_v[j * kMaxD + c] = in ? kv_float(v[at]) * v_sc[j] : 0.f;
  }
}

template <typename TQ, typename TKV, int ROWS>
__global__ void __launch_bounds__(kPWarps * 32)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ key_pos,
                    const int* __restrict__ q_pos, TQ* __restrict__ out,
                    int hkv, int n_pages, int rows, int t, int d, int page,
                    int n_tbl, float scale, int window, int vec) {
  extern __shared__ float smem[];
  __shared__ long long s_rows[kPWarps][kChunk];
  __shared__ float s_ksc[kPWarps][kChunk];
  __shared__ float s_vsc[kPWarps][kChunk];
  float* s_q = smem;
  float* s_w = s_q + kMaxRows * kMaxD;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* s_k = s_w + warp * kWarpFloats;
  float* s_v = s_k + kChunk * (kMaxD + 1);

  const int bg = blockIdx.x;  // b * hkv + kv head
  const int b = bg / hkv;
  const int head = bg % hkv;
  const int r0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, rows - r0);
  const int virt = n_tbl * page;

  const TQ* qb = q + ((size_t)bg * rows + r0) * d;
  for (int i = tid; i < ROWS * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    s_q[r * kMaxD + c] = r < nr ? kv_float(qb[i]) : 0.f;
  }
  int qp[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr)  // a padding row sees nothing
    qp[rr] = rr < nr ? q_pos[b * t + (r0 + rr) % t] : -1;

  float m[ROWS], l[ROWS], acc[ROWS][kCols];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[rr][jj] = 0.f;
  }
  __syncthreads();

  const int n_chunks = (virt + kChunk - 1) / kChunk;
  for (int ch = warp; ch < n_chunks; ch += kPWarps) {
    // this lane's slot: its pool row and position
    const int slot = ch * kChunk + lane;
    int kp = -1;
    long long row = -1;
    if (slot < virt) {
      const int pid = table[b * n_tbl + slot / page];
      if (pid >= 0 && pid < n_pages) {
        kp = key_pos[(size_t)b * virt + slot];
        row = ((long long)pid * hkv + head) * page + slot % page;
      }
    }
    bool keep[ROWS];
    bool seen = false;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      keep[rr] = kp >= 0 && kp <= qp[rr] &&
                 (window <= 0 || kp > qp[rr] - window);
      seen = seen || keep[rr];
    }
    if (!__any_sync(0xffffffffu, seen)) continue;

    s_rows[warp][lane] = seen ? row : -1;
    s_ksc[warp][lane] = (k_scale != nullptr && seen) ? k_scale[row] : 1.f;
    s_vsc[warp][lane] = (v_scale != nullptr && seen) ? v_scale[row] : 1.f;
    __syncwarp();
    stage_chunk<TKV>(k, v, s_rows[warp], s_ksc[warp], s_vsc[warp], d, vec,
                     s_k, s_v, lane);
    __syncwarp();

    // scores of the block's rows against slot `lane`
    float s[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.f;
    const float* krow = s_k + lane * (kMaxD + 1);
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
        s[rr] = fmaf(s_q[rr * kMaxD + c], kc, s[rr]);
    }

    float p[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const float sv = keep[rr] ? s[rr] * scale : -INFINITY;
      const float m_next = fmaxf(m[rr], warp_max(sv));
      // nothing seen yet (m_next = -inf): nothing to rescale
      const float alpha = m_next == -INFINITY ? 1.f : expf(m[rr] - m_next);
      p[rr] = keep[rr] ? expf(sv - m_next) : 0.f;
      l[rr] = alpha * l[rr] + warp_sum(p[rr]);
      m[rr] = m_next;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[rr][jj] *= alpha;
    }

    for (int j = 0; j < kChunk; ++j) {
      float vc[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int c = lane + 32 * jj;
        vc[jj] = c < d ? s_v[j * kMaxD + c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float pj = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[rr][jj] = fmaf(pj, vc[jj], acc[rr][jj]);
      }
    }
    __syncwarp();  // the next chunk rewrites this warp's K and V
  }

  // merge the warps' partial softmaxes (the staging area is free now)
  __syncthreads();
  float* s_m = s_w;                          // [kPWarps][kMaxRows]
  float* s_l = s_m + kPWarps * kMaxRows;     // [kPWarps][kMaxRows]
  float* s_acc = s_l + kPWarps * kMaxRows;   // [kPWarps][kMaxRows][kMaxD]
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    if (lane == 0) {
      s_m[warp * kMaxRows + rr] = m[rr];
      s_l[warp * kMaxRows + rr] = l[rr];
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = lane + 32 * jj;
      if (c < d) s_acc[(warp * kMaxRows + rr) * kMaxD + c] = acc[rr][jj];
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * d; i += blockDim.x) {
    const int rr = i / d, c = i % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kPWarps; ++w) mx = fmaxf(mx, s_m[w * kMaxRows + rr]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kPWarps; ++w) {
        const float mw = s_m[w * kMaxRows + rr];
        if (mw == -INFINITY) continue;
        const float f = expf(mw - mx);
        num = fmaf(f, s_acc[(w * kMaxRows + rr) * kMaxD + c], num);
        den = fmaf(f, s_l[w * kMaxRows + rr], den);
      }
    }
    out[((size_t)bg * rows + r0 + rr) * d + c] =
        from_float<TQ>(den > 0.f ? num / den : 0.f);
  }
}

template <typename TQ, typename TKV, int ROWS>
int launch_rows(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* table,
                const void* key_pos, const void* q_pos, void* out, int b,
                int hkv, int n_pages, int rows, int t, int d, int page,
                int n_tbl, float scale, int window, int vec,
                cudaStream_t stream) {
  static bool smem_set = false;
  const int err = allow_smem(paged_decode_kernel<TQ, TKV, ROWS>, kSmemBytes,
                             &smem_set);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(b * hkv, (rows + ROWS - 1) / ROWS);
  paged_decode_kernel<TQ, TKV, ROWS><<<grid, kPWarps * 32, kSmemBytes,
                                       stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(key_pos), static_cast<const int*>(q_pos),
      static_cast<TQ*>(out), hkv, n_pages, rows, t, d, page, n_tbl, scale,
      window, vec);
  return (int)cudaGetLastError();
}

// the fewest rows per block (1, 2, 4 or 8) that hold the group's rows
template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* table, const void* key_pos,
           const void* q_pos, void* out, int b, int hkv, int n_pages,
           int rows, int t, int d, int page, int n_tbl, float scale,
           int window, int vec, cudaStream_t s) {
#define EGT_PAGED_ROWS(R)                                                   \
  return launch_rows<TQ, TKV, R>(q, k, v, k_scale, v_scale, table, key_pos, \
                                 q_pos, out, b, hkv, n_pages, rows, t, d,   \
                                 page, n_tbl, scale, window, vec, s)
  if (rows <= 1) EGT_PAGED_ROWS(1);
  if (rows <= 2) EGT_PAGED_ROWS(2);
  if (rows <= 4) EGT_PAGED_ROWS(4);
  EGT_PAGED_ROWS(kMaxRows);
#undef EGT_PAGED_ROWS
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* table,
              const void* key_pos, const void* q_pos, void* out, int b,
              int hkv, int n_pages, int rows, int t, int d, int page,
              int n_tbl, float scale, int window, int vec, cudaStream_t s) {
  if (kv_dtype == 0)
    return launch<TQ, float>(q, k, v, nullptr, nullptr, table, key_pos,
                             q_pos, out, b, hkv, n_pages, rows, t, d, page,
                             n_tbl, scale, window, vec, s);
  if (kv_dtype == 1)
    return launch<TQ, __nv_bfloat16>(q, k, v, nullptr, nullptr, table,
                                     key_pos, q_pos, out, b, hkv, n_pages,
                                     rows, t, d, page, n_tbl, scale, window,
                                     vec, s);
  if (kv_dtype == 2 && k_scale != nullptr && v_scale != nullptr)
    return launch<TQ, int8_t>(q, k, v, k_scale, v_scale, table, key_pos,
                              q_pos, out, b, hkv, n_pages, rows, t, d, page,
                              n_tbl, scale, window, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale and v_scale then required).  table, key_pos and q_pos
// are int32.  vec: 16-byte loads of K and V are allowed (see stage_chunk).
// Returns a cudaError_t (0 = success).  Shapes are checked by the Python
// wrapper: d <= 128, h % hkv == 0, every tensor contiguous.
extern "C" int egt_paged_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* table, const void* key_pos,
                                const void* q_pos, void* out, int b, int h,
                                int hkv, int n_pages, int t, int d, int page,
                                int n_tbl, float scale, int window, int vec,
                                int q_dtype, int kv_dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0 || page < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || t == 0) return (int)cudaSuccess;
  const int rows = (h / hkv) * t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, q, k, v, k_scale, v_scale, table,
                            key_pos, q_pos, out, b, hkv, n_pages, rows, t, d,
                            page, n_tbl, scale, window, vec, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale,
                                    table, key_pos, q_pos, out, b, hkv,
                                    n_pages, rows, t, d, page, n_tbl, scale,
                                    window, vec, s);
  return (int)cudaErrorInvalidValue;
}
