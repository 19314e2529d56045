// Flash-attention forward for Hopper (sm_90a) on the tensor cores.
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
// Layout of the work (FlashAttention-2): one block of eight warps per
// (b*h, 32-row q tile).  Two row groups of 16 query rows, four warps
// each: a warp takes 16 of the 64 columns of every kv tile and keeps its
// S (16 x 16) and O (16 x d) fragments in registers, with the online max
// and sum per fragment row, reduced over the four lanes of a quad; at the
// end the four warps of a row group merge their (m, l, O) through shared
// memory.  The TPU kernel's sequential kv grid axis becomes a loop over
// the live band of 64-row kv tiles (what _tri_schedule and _kv_band
// enumerate on the TPU); the mask is applied only on tiles that hold a
// dead (row, col) pair or columns past skv (_tile_needs_mask on the TPU).
// K and V tiles come through a ring of kStages buffers filled by cp.async,
// so the next tile loads while this one computes, with one block barrier
// per tile.  Blocks walk the q tiles from the last, so under a causal
// mask the longest bands start first, and 32-row q tiles keep the longest
// band at half the work of a 64-row one.
//
// Products run on the tensor cores with mma.sync: bfloat16 as m16n8k16
// with a float32 accumulator (P is rounded to bfloat16 for P.V), float32
// as split TF32 (tf32x3.cuh: three m16n8k8 TF32 MMAs per product, about
// float32's accuracy, as precision="highest" asks).  Q is split once, in
// shared memory; K and V as each warp reads them.  The TF32 products read
// k in a permuted order, so S's accumulator fragment is P's operand
// fragment as it stands: P never leaves registers.  d need not be a
// multiple of 8: the columns past d are zero in shared memory.  Rows of
// d * sizeof(T) bytes that are not a multiple of 16 (or a base that is not
// 16-byte aligned) take plain loads instead of cp.async.
//
// What bounds it: at the serving shape [8, 4, 256, 128] f32 causal the
// call does 0.54 GFLOP of products (1.6 GFLOP of TF32 MMAs in split TF32)
// and moves 16.8 MB: at 495 TFLOP/s TF32 and 3.35 TB/s the bytes bound it
// at 5 us.  It takes about 35 us on an H100: mma.sync does not reach that
// TF32 rate (B1 sustains about one m16n8k8 TF32 MMA per 13 cycles per
// scheduler), and more than half the time is not the products but the
// launch, two waves of 32 x 8 = 256 blocks (one an SM: 168 KB of shared
// memory in float32), the K/V tiles each 32-row q tile reloads from L2,
// the softmax and the merge (scripts/probe_torch_kernels.py cuts each
// part out in turn).  wgmma and TMA are later work: wgmma's TF32 form
// wants both operands K-major, and V [kv, d] is not, and the split values
// would have to go back to shared memory.

#include <stdint.h>

#include "flash_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace egt_flash;
using namespace egt_mma;

constexpr int kBlockQ = 32;                // query rows per block
constexpr int kBlockK = 64;                // kv rows per tile
constexpr int kStages = 2;                 // K/V tiles in the cp.async ring
constexpr int kRowGroups = kBlockQ / 16;   // 16 query rows per warp
constexpr int kSplit = 4;                  // warps per row group
constexpr int kWarpK = kBlockK / kSplit;   // kv columns per warp
constexpr int kFwdThreads = kRowGroups * kSplit * 32;
constexpr int kSTiles = kWarpK / 8;        // a warp's 8-column n-tiles of S
constexpr int kXLd = kMaxD + 8;            // stride of the warps' merge

// Row strides of the shared tiles, in elements, chosen so the fragment
// loads hit 32 distinct banks (tf32x3.cuh gives the lanes' positions):
// float32 Q and K are read as float2 at (g, 2t) -> stride = 8 mod 32, V
// at rows (2t, 2t+1) -> stride = 4 mod 16; bfloat16 reads words at (g, t)
// -> 68 words, and V's halves at rows (2t, 2t+1) the same.
template <typename T> struct Layout;
template <> struct Layout<float> {
  static constexpr int kQK = kMaxD + 8;
  static constexpr int kV = kMaxD + 4;
};
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kQK = kMaxD + 8;
  static constexpr int kV = kMaxD + 8;
};

// Q [kBlockQ][kQK] (float32: its TF32 big parts), Q's small parts
// [kBlockQ][kQK] (float32 only), K [kStages][kBlockK][kQK],
// V [kStages][kBlockK][kV]
template <typename T>
__host__ __device__ constexpr int q_small_rows() {
  return sizeof(T) == 4 ? kBlockQ : 0;
}

template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) *
         (size_t)((kBlockQ + q_small_rows<T>()) * Layout<T>::kQK +
                  kStages * kBlockK * (Layout<T>::kQK + Layout<T>::kV));
}

// s += Q_w K^T for a warp's 16 rows (big parts qw, small parts qs) against
// its kv rows (tk), over the first kD columns (zero past d).  big . big and
// the two small terms go to separate sums, which halves the chain of
// dependent MMAs the warp waits on.
template <int kD>
__device__ __forceinline__ void qk(float (&s)[kSTiles][4], const float* qw,
                                   const float* qs, const float* tk, int g,
                                   int t) {
  constexpr int ld = Layout<float>::kQK;
  float c[kSTiles][4];
#pragma unroll
  for (int j = 0; j < kSTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    const int lo = g * ld + 8 * ks + 2 * t, hi = lo + 8 * ld;
    const float2 b_lo = *reinterpret_cast<const float2*>(qw + lo);
    const float2 b_hi = *reinterpret_cast<const float2*>(qw + hi);
    const float2 s_lo = *reinterpret_cast<const float2*>(qs + lo);
    const float2 s_hi = *reinterpret_cast<const float2*>(qs + hi);
    const uint32_t ab[4] = {__float_as_uint(b_lo.x), __float_as_uint(b_hi.x),
                            __float_as_uint(b_lo.y), __float_as_uint(b_hi.y)};
    const uint32_t as[4] = {__float_as_uint(s_lo.x), __float_as_uint(s_hi.x),
                            __float_as_uint(s_lo.y), __float_as_uint(s_hi.y)};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(
          tk + (8 * j + g) * ld + 8 * ks + 2 * t);
      uint32_t bb[2], bs[2];
      split_tf32(b.x, bb[0], bs[0]);
      split_tf32(b.y, bb[1], bs[1]);
      mma_tf32(c[j], as, bb);
      mma_tf32(c[j], ab, bs);
      mma_tf32(s[j], ab, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < kSTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];
}

template <int kD>
__device__ __forceinline__ void qk(float (&s)[kSTiles][4],
                                   const __nv_bfloat16* qw,
                                   const __nv_bfloat16*,
                                   const __nv_bfloat16* tk, int g, int t) {
  constexpr int ld = Layout<__nv_bfloat16>::kQK;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* a = qw + 16 * ks + 2 * t;
    const uint32_t af[4] = {ld32(a + g * ld), ld32(a + (g + 8) * ld),
                            ld32(a + g * ld + 8),
                            ld32(a + (g + 8) * ld + 8)};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      const __nv_bfloat16* b = tk + (8 * j + g) * ld + 16 * ks + 2 * t;
      const uint32_t bf[2] = {ld32(b), ld32(b + 8)};
      mma_bf16(s[j], af, bf);
    }
  }
}

// does global query row `row` see any of the keys [k_off, k_off + skv)?
__device__ __forceinline__ bool row_live(int row, int skv, int causal,
                                         int window, int k_off) {
  int lo = k_off, hi = k_off + skv - 1;
  if (window > 0) lo = max(lo, row - window + 1);
  if (causal) hi = min(hi, row);
  return lo <= hi;
}

// kD: the head columns the MMAs cover, d rounded up to 32, 64 or 128
template <typename T, int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int h, int group, int sq, int skv,
                 int d, float scale, int causal, int window, int q_off,
                 int k_off, int vec) {
  using L = Layout<T>;
  static_assert((kSplit - 1) * kBlockQ * (kXLd + 2) * sizeof(float) <=
                    smem_bytes<T>(),
                "the warps' merge must fit in the tiles' shared memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_qs = s_q + kBlockQ * L::kQK;
  T* s_k = s_qs + q_small_rows<T>() * L::kQK;
  T* s_v = s_k + kStages * kBlockK * L::kQK;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last tile first
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int kv_head = (bh / h) * (h / group) + (bh % h) / group;
  const T* qp = q + (size_t)bh * sq * d;
  const T* kp = k + (size_t)kv_head * skv * d;
  const T* vp = v + (size_t)kv_head * skv * d;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups, kq = warp / kRowGroups;
  const int wr = rg * 16;      // the warp's first row in the block
  const int wc = kq * kWarpK;  // and its first column in a kv tile

  // the columns past d are read by the MMAs' last k steps: zero them once
  // in Q and every K and V buffer
  zero_pad<kFwdThreads>(s_q, kBlockQ, L::kQK, d, tid);
  zero_pad<kFwdThreads>(s_k, kStages * kBlockK, L::kQK, d, tid);
  zero_pad<kFwdThreads>(s_v, kStages * kBlockK, L::kV, d, tid);

  const Band band = kv_band(q0, q_last, skv, causal, window, q_off, k_off,
                            kBlockK);
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8 of the warp: running max and this lane's part of the
  // sum, over the warp's columns
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  // Q and the first kStages - 1 tiles, one cp.async group each (Q with
  // the first); then each tile's turn waits for its group and issues the
  // tile kStages - 1 ahead into the buffer the last turn freed
  for (int st = 0; st < kStages - 1; ++st) {
    const int tile = band.lo + st;
    if (tile <= band.hi) {
      if (st == 0)
        load_tile<kFwdThreads>(s_q, L::kQK, qp, q0, kBlockQ, sq, d, vec,
                               tid);
      load_tile<kFwdThreads>(s_k + st * kBlockK * L::kQK, L::kQK, kp,
                             tile * kBlockK, kBlockK, skv, d, vec, tid);
      load_tile<kFwdThreads>(s_v + st * kBlockK * L::kV, L::kV, vp,
                             tile * kBlockK, kBlockK, skv, d, vec, tid);
    }
    cp_async_commit();
  }
  for (int tile = band.lo; tile <= band.hi; ++tile) {
    const int buf = (tile - band.lo) % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile is in; every warp is done with the last
    if (tile == band.lo) {  // Q, once for all kv tiles
      split_rows<kFwdThreads>(s_q, s_qs, kBlockQ, L::kQK, tid);
      __syncthreads();
    }
    const int ahead = tile + kStages - 1;
    if (ahead <= band.hi) {
      const int at = (ahead - band.lo) % kStages;
      load_tile<kFwdThreads>(s_k + at * kBlockK * L::kQK, L::kQK, kp,
                             ahead * kBlockK, kBlockK, skv, d, vec, tid);
      load_tile<kFwdThreads>(s_v + at * kBlockK * L::kV, L::kV, vp,
                             ahead * kBlockK, kBlockK, skv, d, vec, tid);
    }
    cp_async_commit();
    const T* tk = s_k + buf * kBlockK * L::kQK;
    const T* tv = s_v + buf * kBlockK * L::kV;
    const int kv0 = tile * kBlockK;

    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    qk<kD>(s, s_q + wr * L::kQK, s_qs + wr * L::kQK, tk + wc * L::kQK, g, t);

    // every (row, col) pair of the block and tile live: no mask
    const bool full =
        kv0 + kBlockK <= skv &&
        (!causal || kv0 + kBlockK - 1 + k_off <= q0 + q_off) &&
        (window <= 0 || kv0 + k_off > q_last + q_off - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (!full) {
          const int col = kv0 + wc + 8 * j + 2 * t + (e & 1);
          const int row = q0 + wr + g + 8 * (e >> 1);
          if (!(col < skv && attends(row + q_off, col + k_off, causal, window)))
            x = kMasked;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_next);
      m_run[r] = m_next;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    pv<kD, kSTiles, L::kV>(o, s, alpha, tv + wc * L::kV, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  // the warps of a row group merge their (m, l, o): all but the first hand
  // theirs over through shared memory, free once every warp is done with
  // the last tile
  __syncthreads();
  float* xo = reinterpret_cast<float*>(smem_raw);  // [kSplit-1][kBlockQ][kXLd]
  float* xm = xo + (kSplit - 1) * kBlockQ * kXLd;  // [kSplit-1][kBlockQ]
  float* xl = xm + (kSplit - 1) * kBlockQ;         // [kSplit-1][kBlockQ]
  if (kq > 0) {
    const int slot = (kq - 1) * kBlockQ;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = slot + wr + g + 8 * r;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<float2*>(xo + lr * kXLd + 8 * j + 2 * t) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t == 0) {
        xm[lr] = m_run[r];
        xl[lr] = l_run[r];
      }
    }
  }
  __syncthreads();
  if (kq > 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = wr + g + 8 * r;
    float m = m_run[r];
#pragma unroll
    for (int x = 0; x < kSplit - 1; ++x) m = fmaxf(m, xm[x * kBlockQ + lr]);
    // all -inf only where the band is empty and the row dead
    const float a0 = m_run[r] == -INFINITY ? 0.f : expf(m_run[r] - m);
    l_run[r] *= a0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][2 * r] *= a0;
      o[j][2 * r + 1] *= a0;
    }
#pragma unroll
    for (int x = 0; x < kSplit - 1; ++x) {
      const int at = x * kBlockQ + lr;
      const float a = xm[at] == -INFINITY ? 0.f : expf(xm[at] - m);
      l_run[r] += xl[at] * a;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float2 y =
            *reinterpret_cast<const float2*>(xo + at * kXLd + 8 * j + 2 * t);
        o[j][2 * r] = fmaf(y.x, a, o[j][2 * r]);
        o[j][2 * r + 1] = fmaf(y.y, a, o[j][2 * r + 1]);
      }
    }
    m_run[r] = m;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= sq) continue;
    const bool live = row_live(row + q_off, skv, causal, window, k_off);
    const float inv = live ? 1.f / l_run[r] : 0.f;
    T* orow = out + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < d) orow[c] = from_float<T>(o[j][2 * r] * inv);
      if (c + 1 < d) orow[c + 1] = from_float<T>(o[j][2 * r + 1] * inv);
    }
    if (t == 0)
      lse[(size_t)bh * sq + row] = live ? m_run[r] + logf(l_run[r]) : -INFINITY;
  }
}

template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int h, int hkv, int sq, int skv, int d, float scale,
           int causal, int window, int q_off, int k_off,
           cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t bytes = smem_bytes<T>();
  const int err = allow_smem(flash_fwd_kernel<T, kD>, bytes, &smem_set);
  if (err != (int)cudaSuccess) return err;
  const int vec = (d * sizeof(T)) % 16 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v);
  const dim3 grid(b * h, (sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, kD><<<grid, kFwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), h, h / hkv, sq, skv, d, scale, causal,
      window, q_off, k_off, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             void* lse, int b, int h, int hkv, int sq, int skv, int d,
             float scale, int causal, int window, int q_off, int k_off,
             cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, lse, b, h, hkv, sq, skv, d, scale,
                         causal, window, q_off, k_off, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, lse, b, h, hkv, sq, skv, d, scale,
                         causal, window, q_off, k_off, stream);
  return launch<T, kMaxD>(q, k, v, out, lse, b, h, hkv, sq, skv, d, scale,
                          causal, window, q_off, k_off, stream);
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
    return launch_d<float>(q, k, v, out, lse, b, h, hkv, sq, skv, d, scale,
                           causal, window, q_off, k_off, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, lse, b, h, hkv, sq, skv, d,
                                   scale, causal, window, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}

// egt_flash_fwd's arguments in one struct, so that the Python wrapper
// passes one pointer through ctypes instead of converting 17 arguments
// (about 3 us of host time a launch).  ops/attention.py packs it with
// struct.Struct("<5Q6if5i"): five pointers, then ints and the scale in
// this order, no padding.
struct FlashFwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  void* lse;
  int b, h, hkv, sq, skv, d;
  float scale;
  int causal, window, q_off, k_off, dtype;
};
static_assert(sizeof(FlashFwdArgs) == 88, "FlashFwdArgs layout");

extern "C" int egt_flash_fwd_packed(const FlashFwdArgs* a, void* stream) {
  return egt_flash_fwd(a->q, a->k, a->v, a->out, a->lse, a->b, a->h, a->hkv,
                       a->sq, a->skv, a->d, a->scale, a->causal, a->window,
                       a->q_off, a->k_off, a->dtype, stream);
}
