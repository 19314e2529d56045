// Paged decode attention for Hopper (sm_90a): split-K over pages
// (flash-decoding), FP32 FMA on CUDA cores.
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
// Layout of the work.  The grid is (b*hkv, 8-row slices of the group*t
// query rows, n_split): split z walks the page-table entries [z*pps,
// (z+1)*pps) of its row, so the card holds enough blocks to fill its SMs
// where b*hkv alone (64 at bench.py's shape, 32 at the serving step) would
// not.  The wrapper picks n_split from the table's width, its page size
// and the grid alone, never from the data (ops/paged_attention.py
// split_plan).  In a block four warps take the split's 32-slot
// chunks in turn (chunk w, w+4, ...), lane j owning slot j.  A warp skips
// a chunk that no query row sees (unallocated and dead slots, positions
// past the query, slots behind the window), and copies the others' K and
// V rows into its own shared ring in their stored dtype with 16-byte
// cp.async, 32 copies a lane in flight, zero-filled for the slots no row
// sees; the next live chunk's copies are issued once the current one is
// scored (one ring stage: three blocks an SM for bfloat16 rows of 128).
// K and V are converted and dequantized as they are read from shared
// memory: QK^T reads lane j's own K row in 16-byte units (rows padded by
// 16 bytes, so the 8 lanes of a phase hit distinct banks), P.V reads V
// columns lane, lane+32, ...  The four warps'
// online softmaxes merge through shared memory in warp order; with one
// split that is the output, else each split writes its partial (m, l,
// acc[d]) in float32 and a second kernel merges the splits in split
// order, skipping those that saw no key.  No atomics: two runs give the
// same bits.
//
// What bounds it: at bench.py's shape (b 8, hkv 8, group 1, d 128, 16
// pages of 128 bfloat16 slots a row) a call moves 67 MB of K and V and does
// 67 MFLOP, so the card's memory (3.35 TB/s) bounds it at about 20 us.

#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace egt_flash;
using egt_mma::cp_async16;
using egt_mma::cp_async_commit;
using egt_mma::cp_async_wait;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPWarps = 4;
constexpr int kChunk = 32;    // virtual slots a warp takes at once, one a lane
constexpr int kMaxRows = 8;   // query rows a block holds
// shared memory: the query rows [kMaxRows][kMaxD] as float, then each warp's
// ring ({K rows, V rows} x kChunk rows), reused at the end for the warps'
// merge ([kPWarps][kMaxRows] m and l, [kPWarps][kMaxRows][kMaxD] acc)
constexpr int kQBytes = kMaxRows * kMaxD * (int)sizeof(float);
constexpr int kMergeBytes =
    kPWarps * kMaxRows * (kMaxD + 2) * (int)sizeof(float);

// bytes of one K or V row in the ring: whole 16-byte units plus 16 bytes
__host__ __device__ inline int ring_row(int d, int item) {
  return (d * item + 15) / 16 * 16 + 16;
}
inline int smem_bytes(int d, int item) {
  const int ring = kPWarps * 2 * kChunk * ring_row(d, item);
  return kQBytes + (ring > kMergeBytes ? ring : kMergeBytes);
}

static __device__ __forceinline__ float kv_float(float x) { return x; }
static __device__ __forceinline__ float kv_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
static __device__ __forceinline__ float kv_float(int8_t x) {
  return (float)x;
}

// 16 bytes of K as floats (4 float32, 8 bfloat16 or 16 int8 values)
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

static __device__ __forceinline__ bool sees(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// Copy a chunk's K and V rows into a warp's ring: row j of K at
// buf + j * rowb, of V at buf + (kChunk + j) * rowb.  `row` is this lane's
// pool row ((page * hkv + head) * page_size + offset), -1 for a slot no
// query row sees, which is zero-filled and not read.  vec: rows of whole
// 16-byte units in 16-byte-aligned pools, copied with cp.async (the caller
// commits and waits); else element by element, synchronously.
template <typename T>
__device__ __forceinline__ void issue_chunk(const T* __restrict__ k,
                                            const T* __restrict__ v,
                                            long long row, int d, int rowb,
                                            int vec, unsigned char* buf,
                                            int lane) {
  if (vec) {
    const int units = d * (int)sizeof(T) / 16;
    const char* kb = reinterpret_cast<const char*>(k);
    const char* vb = reinterpret_cast<const char*>(v);
    // kChunk * units is a multiple of 32: every lane takes the shuffles
    for (int i = lane; i < kChunk * units; i += 32) {
      const int j = i / units, u = i - j * units;
      const long long rj = __shfl_sync(kFull, row, j);
      const bool in = rj >= 0;
      const size_t at = in ? (size_t)rj * d * sizeof(T) + u * 16 : 0;
      cp_async16(buf + j * rowb + u * 16, kb + at, in ? 16 : 0);
      cp_async16(buf + (kChunk + j) * rowb + u * 16, vb + at, in ? 16 : 0);
    }
    return;
  }
  for (int i = lane; i < kChunk * d; i += 32) {
    const int j = i / d, c = i - j * d;
    const long long rj = __shfl_sync(kFull, row, j);
    T* dk = reinterpret_cast<T*>(buf + j * rowb);
    T* dv = reinterpret_cast<T*>(buf + (kChunk + j) * rowb);
    dk[c] = rj >= 0 ? k[(size_t)rj * d + c] : T{};
    dv[c] = rj >= 0 ? v[(size_t)rj * d + c] : T{};
  }
}

template <typename TQ, typename TKV, int ROWS>
__global__ void __launch_bounds__(kPWarps * 32)
paged_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ key_pos,
                   const int* __restrict__ q_pos, TQ* __restrict__ out,
                   float* __restrict__ part, int hkv, int n_pages, int rows,
                   int t, int d, int page, int n_tbl, float scale,
                   int window, int vec, int pps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  unsigned char* s_ring = smem + kQBytes;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rowb = ring_row(d, (int)sizeof(TKV));
  unsigned char* ring = s_ring + warp * 2 * kChunk * rowb;

  const int bg = blockIdx.x;  // b * hkv + kv head
  const int b = bg / hkv;
  const int head = bg % hkv;
  const int r0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, rows - r0);
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int virt = n_tbl * page;
  const int base = split * pps * page;
  const int end = min(n_tbl, (split + 1) * pps) * page;
  const int n_chunks = end > base ? (end - base + kChunk - 1) / kChunk : 0;

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

  // this lane's slot of chunk ch: its pool row (-1 when no query row of
  // the block sees it), position and scales; true when some lane's slot is
  // seen
  auto probe = [&](int ch, long long& row, int& kp, float& ksc,
                   float& vsc) -> bool {
    const int slot = base + ch * kChunk + lane;
    kp = -1;
    row = -1;
    if (slot < end) {
      const int pid = table[b * n_tbl + slot / page];
      if (pid >= 0 && pid < n_pages) {
        kp = key_pos[(size_t)b * virt + slot];
        row = ((long long)pid * hkv + head) * page + slot % page;
      }
    }
    bool seen = false;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) seen = seen || sees(kp, qp[rr], window);
    if (!seen) row = -1;
    ksc = (k_scale != nullptr && seen) ? k_scale[row] : 1.f;
    vsc = (v_scale != nullptr && seen) ? v_scale[row] : 1.f;
    return __any_sync(kFull, seen);
  };

  // score one staged chunk and fold it into the online softmax
  auto consume = [&](const unsigned char* buf, int kp, float ksc,
                     float vsc) {
    float s[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.f;
    const unsigned char* krow = buf + lane * rowb;
    if (vec) {
      constexpr int kV = 16 / sizeof(TKV);
      const int units = d * (int)sizeof(TKV) / 16;
      for (int u = 0; u < units; ++u) {
        float kf[kV];
        unpack16(*reinterpret_cast<const uint4*>(krow + u * 16), kf, TKV());
#pragma unroll
        for (int x = 0; x < kV; ++x) {
          const float kc = kf[x] * ksc;  // dequantize, then the product
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr)
            s[rr] = fmaf(s_q[rr * kMaxD + u * kV + x], kc, s[rr]);
        }
      }
    } else {
      const TKV* kr = reinterpret_cast<const TKV*>(krow);
      for (int c = 0; c < d; ++c) {
        const float kc = kv_float(kr[c]) * ksc;
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          s[rr] = fmaf(s_q[rr * kMaxD + c], kc, s[rr]);
      }
    }
    float pv[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const bool keep = sees(kp, qp[rr], window);
      const float sv = keep ? s[rr] * scale : -INFINITY;
      const float m_next = fmaxf(m[rr], warp_max(sv));
      // nothing seen yet (m_next = -inf): nothing to rescale
      const float alpha = m_next == -INFINITY ? 1.f : expf(m[rr] - m_next);
      const float p = keep ? expf(sv - m_next) : 0.f;
      l[rr] = alpha * l[rr] + warp_sum(p);
      m[rr] = m_next;
      pv[rr] = p * vsc;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[rr][jj] *= alpha;
    }
    for (int j = 0; j < kChunk; ++j) {
      const TKV* vr = reinterpret_cast<const TKV*>(buf + (kChunk + j) * rowb);
      float vc[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int c = lane + 32 * jj;
        vc[jj] = c < d ? kv_float(vr[c]) : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float pj = __shfl_sync(kFull, pv[rr], j);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj)
          acc[rr][jj] = fmaf(pj, vc[jj], acc[rr][jj]);
      }
    }
  };

  long long row;
  int kp;
  float ksc, vsc;
  int ch = warp;
  while (ch < n_chunks && !probe(ch, row, kp, ksc, vsc)) ch += kPWarps;
  if (ch < n_chunks) {
    issue_chunk<TKV>(k, v, row, d, rowb, vec, ring, lane);
    cp_async_commit();
  }
  while (ch < n_chunks) {
    long long row2 = -1;
    int kp2 = -1;
    float ksc2 = 1.f, vsc2 = 1.f;
    int nxt = ch + kPWarps;
    while (nxt < n_chunks && !probe(nxt, row2, kp2, ksc2, vsc2))
      nxt += kPWarps;
    cp_async_wait<0>();
    __syncwarp();
    consume(ring, kp, ksc, vsc);
    __syncwarp();  // the next copies rewrite the ring
    if (nxt < n_chunks) {
      issue_chunk<TKV>(k, v, row2, d, rowb, vec, ring, lane);
      cp_async_commit();
    }
    ch = nxt;
    row = row2;
    kp = kp2;
    ksc = ksc2;
    vsc = vsc2;
  }

  // merge the warps' partial softmaxes (the rings are free now)
  __syncthreads();
  float* s_m = reinterpret_cast<float*>(s_ring);  // [kPWarps][kMaxRows]
  float* s_l = s_m + kPWarps * kMaxRows;           // [kPWarps][kMaxRows]
  float* s_acc = s_l + kPWarps * kMaxRows;  // [kPWarps][kMaxRows][kMaxD]
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
  const size_t n_bg = gridDim.x;
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
    const size_t at = ((size_t)bg * rows + r0 + rr) * d + c;
    if (n_split == 1) {
      out[at] = from_float<TQ>(den > 0.f ? num / den : 0.f);
      continue;
    }
    // split z's partial: acc [n_split][b*hkv][rows][d], then (m, l)
    // [n_split][b*hkv][rows][2]
    const size_t row_at = (size_t)split * n_bg * rows + (size_t)bg * rows +
                          r0 + rr;
    part[row_at * d + c] = num;
    if (c == 0) {
      float* ml = part + (size_t)n_split * n_bg * rows * d;
      ml[2 * row_at] = mx;
      ml[2 * row_at + 1] = den;
    }
  }
}

// Combine the splits' partials in split order; a split that saw no key
// (m = -inf) is skipped, and a row no split saw gives 0.
template <typename TQ>
__global__ void __launch_bounds__(128)
paged_merge_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                   int rows, int d, int n_split) {
  const int bg = blockIdx.x;
  const size_t n_bg = gridDim.x;
  const float* ml = part + (size_t)n_split * n_bg * rows * d;
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    float mx = -INFINITY;
    for (int z = 0; z < n_split; ++z)
      mx = fmaxf(mx, ml[2 * ((size_t)z * n_bg * rows + (size_t)bg * rows + r)]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int z = 0; z < n_split; ++z) {
        const size_t row_at = (size_t)z * n_bg * rows + (size_t)bg * rows + r;
        const float mz = ml[2 * row_at];
        if (mz == -INFINITY) continue;
        const float f = expf(mz - mx);
        num = fmaf(f, part[row_at * d + c], num);
        den = fmaf(f, ml[2 * row_at + 1], den);
      }
    }
    out[((size_t)bg * rows + r) * d + c] =
        from_float<TQ>(den > 0.f ? num / den : 0.f);
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *table, *key_pos, *q_pos;
  void *out;
  float* part;
  int b, hkv, n_pages, rows, t, d, page, n_tbl;
  float scale;
  int window, vec, n_split, pps;
};

template <typename TQ, typename TKV, int ROWS>
int launch_rows(const Args& a, cudaStream_t stream) {
  // the limit each instantiation may ask for: the widest rows' ring
  static bool smem_set = false;
  int err = allow_smem(paged_split_kernel<TQ, TKV, ROWS>,
                       smem_bytes(kMaxD, (int)sizeof(TKV)), &smem_set);
  if (err != (int)cudaSuccess) return err;
  const dim3 grid(a.b * a.hkv, (a.rows + ROWS - 1) / ROWS, a.n_split);
  paged_split_kernel<TQ, TKV, ROWS>
      <<<grid, kPWarps * 32, smem_bytes(a.d, (int)sizeof(TKV)), stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), static_cast<const float*>(a.k_scale),
          static_cast<const float*>(a.v_scale),
          static_cast<const int*>(a.table),
          static_cast<const int*>(a.key_pos),
          static_cast<const int*>(a.q_pos), static_cast<TQ*>(a.out), a.part,
          a.hkv, a.n_pages, a.rows, a.t, a.d, a.page, a.n_tbl, a.scale,
          a.window, a.vec, a.pps);
  err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess || a.n_split == 1) return err;
  paged_merge_kernel<TQ><<<a.b * a.hkv, 128, 0, stream>>>(
      a.part, static_cast<TQ*>(a.out), a.rows, a.d, a.n_split);
  return (int)cudaGetLastError();
}

// the fewest rows per block (1, 4 or 8) that hold the group's rows
// (ops/paged_attention.py rows_per_block); three instantiations, not
// four, keep the build short
template <typename TQ, typename TKV>
int launch(const Args& a, cudaStream_t s) {
  if (a.rows <= 1) return launch_rows<TQ, TKV, 1>(a, s);
  if (a.rows <= 4) return launch_rows<TQ, TKV, 4>(a, s);
  return launch_rows<TQ, TKV, kMaxRows>(a, s);
}

template <typename TQ>
int launch_kv(int kv_dtype, const Args& a, cudaStream_t s) {
  if (kv_dtype == 0 && a.k_scale == nullptr) return launch<TQ, float>(a, s);
  if (kv_dtype == 1 && a.k_scale == nullptr)
    return launch<TQ, __nv_bfloat16>(a, s);
  if (kv_dtype == 2 && a.k_scale != nullptr && a.v_scale != nullptr)
    return launch<TQ, int8_t>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (k_scale and v_scale then required, else both null).  table,
// key_pos and q_pos are int32.  vec: 16-byte copies of K and V are allowed
// (see issue_chunk).  n_split splits of pps table entries each cover the
// table (n_split * pps >= n_tbl); with n_split > 1, part holds
// n_split * b * hkv * rows * (d + 2) floats of scratch.  Returns a
// cudaError_t (0 = success).  Shapes are checked by the Python wrapper:
// d <= 128, h % hkv == 0, every tensor contiguous.
extern "C" int egt_paged_decode(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* table, const void* key_pos,
                                const void* q_pos, void* out, void* part,
                                int b, int h, int hkv, int n_pages, int t,
                                int d, int page, int n_tbl, float scale,
                                int window, int vec, int n_split, int pps,
                                int q_dtype, int kv_dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0 || page < 1 ||
      n_split < 1 || pps < 1 || (long long)n_split * pps < n_tbl ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || t == 0) return (int)cudaSuccess;
  const Args a{q,       k,   v,       k_scale, v_scale,
               table,   key_pos, q_pos, out,     static_cast<float*>(part),
               b,       hkv, n_pages, (h / hkv) * t, t,
               d,       page, n_tbl,  scale,   window,
               vec,     n_split, pps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch_kv<float>(kv_dtype, a, s);
  if (q_dtype == 1) return launch_kv<__nv_bfloat16>(kv_dtype, a, s);
  return (int)cudaErrorInvalidValue;
}
