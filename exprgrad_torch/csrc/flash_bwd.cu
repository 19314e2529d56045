// Flash-attention backward for Hopper (sm_90a) on the tensor cores.
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
// over the live band of streamed tiles (kv_band / q_band).  Both kernels
// have the forward's shape: a block of eight warps owns 32 rows (dq: query
// rows, dkv: kv rows) in two row groups of 16, and streams 64-row tiles
// of the other side through a ring of kStages buffers filled by cp.async,
// one block barrier per tile.  The four warps of a row group each take
// 16 of a tile's 64 streamed rows and keep their partial gradient rows in
// registers; at the end they add them up through shared memory in a fixed
// order.
//
// * dq: one block per (b*h, 32-row q tile), the last tile first (under a
//   causal mask its band is the longest).  Per kv tile a warp computes
//   S = Q K^T and dP = dO V^T (k = d), then P and dS in registers, then
//   dQ += dS K (k = the warp's 16 kv rows).
// * dkv: one block per (b*hkv, 32-row kv tile).  It computes the
//   transposes directly: S^T = K Q^T and dP^T = V dO^T, with lse and
//   delta per column, then dV += P^T dO and dK += dS^T Q (k = the warp's
//   16 query rows).  Under grouped-query attention the block walks the
//   group's query heads itself, one after the other through the same
//   ring, so each kv row is summed in a fixed order: no partial buffer per
//   query head (the TPU kernel writes [b*h, skv, d] partials and sums them
//   in XLA), no float atomics, and the same bits every run.
//
// Products run on the tensor cores with mma.sync: bfloat16 as m16n8k16
// with a float32 accumulator (P and dS are rounded to bfloat16 for the
// second product, as the forward rounds P for P V), float32 as split TF32
// (tf32x3.cuh: three m16n8k8 TF32 MMAs per product, about float32's
// accuracy).  The operands a block keeps (dq: Q and dO; dkv: K and V) are
// split once, in shared memory; the streamed tiles as each warp reads
// them.  The first product of a tile reads k in the natural order; the
// second reads it permuted (tf32x3.cuh), so the first product's
// accumulator fragments are its A fragments as they stand: P and dS never
// leave registers.  Its B operand is the streamed tile read across rows
// (dq: K, dkv: Q and dO), while the first product reads K (dq) along its
// rows; float32 rows of kMaxD + 4 floats serve both reads without bank
// conflicts (scalar loads at (g, t) and at rows (2t, 2t+1)), bfloat16 rows
// of kMaxD + 8 as in the forward.  Each tile's second product is summed in
// a fresh accumulator and added to the gradient in float32: the tensor
// cores truncate each MMA's sum, and dk/dv sum up to a GQA group's whole
// query length.  The mask is applied only on tiles that hold a dead pair
// or rows past sq / skv.  d need not be a multiple of 8: the columns past
// d are zero in shared memory.  Rows of d * sizeof(T) bytes that are not a
// multiple of 16 (or a base that is not 16-byte aligned) take plain loads
// instead of cp.async.
//
// What bounds it: at the serving shape [8, 4, 256, 128] float32 causal
// dq does 0.81 GFLOP of products and dkv 1.08 (2.4 and 3.2 GFLOP of TF32
// MMAs in split TF32), and each moves about 25 MB, so at 495 TFLOP/s TF32
// and 3.35 TB/s each is bound by its bytes at about 7.5 us.  mma.sync
// does not reach that TF32 rate (B1 sustains about a third of it), and as
// in the forward the launch, two waves of 256 blocks of 200 KB of shared
// memory (one an SM in float32), the tiles each block reloads from L2 and
// the elementwise work between the products cost about as much as the
// products.  wgmma, TMA and a one-pass backward (which would need atomics
// on dq) are later work.

#include <stdint.h>

#include "flash_common.cuh"
#include "tf32x3.cuh"

namespace {

using namespace egt_flash;
using namespace egt_mma;

constexpr int kBlock = 32;                 // rows a block owns
constexpr int kStream = 64;                // rows of a streamed tile
constexpr int kStages = 2;                 // streamed tiles in the ring
constexpr int kRowGroups = kBlock / 16;    // 16 owned rows per warp
constexpr int kSplit = 4;                  // warps per row group
constexpr int kWarpN = kStream / kSplit;   // streamed rows per warp
constexpr int kThreads = kRowGroups * kSplit * 32;
constexpr int kNT = kWarpN / 8;            // a warp's 8-column n-tiles of S
constexpr int kXLd = kMaxD + 8;            // stride of the warps' merge

// Row stride of every shared tile, in elements (see the header).
template <typename T> struct Ld;
template <> struct Ld<float> {
  static constexpr int v = kMaxD + 4;
};
template <> struct Ld<__nv_bfloat16> {
  static constexpr int v = kMaxD + 8;
};

// the small TF32 parts of the two kept operands (float32 only)
template <typename T>
__host__ __device__ constexpr int small_rows() {
  return sizeof(T) == 4 ? kBlock : 0;
}

// two kept tiles [kBlock][ld] and their small parts, two streamed rings
// [kStages][kStream][ld]; the end-of-block merge of `merges` gradients
// reuses the same memory
template <typename T, int merges>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t tiles =
      sizeof(T) * (size_t)Ld<T>::v *
      (2 * (kBlock + small_rows<T>()) + 2 * kStages * kStream);
  constexpr size_t merge =
      sizeof(float) * (size_t)merges * (kSplit - 1) * kBlock * kXLd;
  return tiles > merge ? tiles : merge;
}

// s += A_w B^T, k = the first kD columns: A_w the warp's 16 kept rows
// (big parts ab, small parts as), B the warp's 16 streamed rows tb, both
// [row][ld].  k in the natural order.  big . big and the two small terms
// go to separate sums, which halves the chain of dependent MMAs.
template <int kD>
__device__ __forceinline__ void abt(float (&s)[kNT][4], const float* ab,
                                    const float* as, const float* tb, int g,
                                    int t) {
  constexpr int ld = Ld<float>::v;
  float c[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    const int lo = g * ld + 8 * ks + t, hi = lo + 8 * ld;
    const uint32_t fb[4] = {__float_as_uint(ab[lo]), __float_as_uint(ab[hi]),
                            __float_as_uint(ab[lo + 4]),
                            __float_as_uint(ab[hi + 4])};
    const uint32_t fs[4] = {__float_as_uint(as[lo]), __float_as_uint(as[hi]),
                            __float_as_uint(as[lo + 4]),
                            __float_as_uint(as[hi + 4])};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* b = tb + (8 * j + g) * ld + 8 * ks + t;
      uint32_t bb[2], bs[2];
      split_tf32(b[0], bb[0], bs[0]);
      split_tf32(b[4], bb[1], bs[1]);
      mma_tf32(c[j], fs, bb);
      mma_tf32(c[j], fb, bs);
      mma_tf32(s[j], fb, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];
}

template <int kD>
__device__ __forceinline__ void abt(float (&s)[kNT][4],
                                    const __nv_bfloat16* ab,
                                    const __nv_bfloat16*,
                                    const __nv_bfloat16* tb, int g, int t) {
  constexpr int ld = Ld<__nv_bfloat16>::v;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const __nv_bfloat16* a = ab + 16 * ks + 2 * t;
    const uint32_t af[4] = {ld32(a + g * ld), ld32(a + (g + 8) * ld),
                            ld32(a + g * ld + 8),
                            ld32(a + (g + 8) * ld + 8)};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const __nv_bfloat16* b = tb + (8 * j + g) * ld + 16 * ks + 2 * t;
      const uint32_t bf[2] = {ld32(b), ld32(b + 8)};
      mma_bf16(s[j], af, bf);
    }
  }
}

// The warps of a row group add up their partial gradients: all but the
// first hand theirs over through shared memory (free once every warp is
// done with the tiles), and the first adds them in a fixed order.
// `slot` picks one of the merge areas.
template <int kD>
__device__ __forceinline__ void merge_put(float* x, int slot, int kq, int wr,
                                          const float (&acc)[kD / 8][4],
                                          int g, int t) {
  if (kq == 0) return;
  float* xo = x + ((size_t)slot * (kSplit - 1) + kq - 1) * kBlock * kXLd;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<float2*>(xo + (wr + g + 8 * r) * kXLd + 8 * j +
                                 2 * t) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
}

template <int kD>
__device__ __forceinline__ void merge_add(const float* x, int slot, int wr,
                                          float (&acc)[kD / 8][4], int g,
                                          int t) {
#pragma unroll
  for (int w = 0; w < kSplit - 1; ++w) {
    const float* xo = x + ((size_t)slot * (kSplit - 1) + w) * kBlock * kXLd;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const float2 y = *reinterpret_cast<const float2*>(
            xo + (wr + g + 8 * r) * kXLd + 8 * j + 2 * t);
        acc[j][2 * r] += y.x;
        acc[j][2 * r + 1] += y.y;
      }
  }
}

// rows wr + g and wr + g + 8 of acc into out (row stride d), rows past
// `rows` and columns past d skipped
template <typename T, int kD>
__device__ __forceinline__ void store_rows(T* out, int row0, int rows, int d,
                                           int wr,
                                           const float (&acc)[kD / 8][4],
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wr + g + 8 * r;
    if (row >= rows) continue;
    T* o = out + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < d) o[c] = from_float<T>(acc[j][2 * r]);
      if (c + 1 < d) o[c + 1] = from_float<T>(acc[j][2 * r + 1]);
    }
  }
}

// P of one score: exp(x - lse), where lse is +inf for a row that is dead
// or past the end (exp(-inf) = 0)
__device__ __forceinline__ float live_lse(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

// kD: the head columns the MMAs cover, d rounded up to 32, 64 or 128
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int h,
                    int group, int sq, int skv, int d, float scale,
                    int causal, int window, int q_off, int k_off, int vec) {
  constexpr int ld = Ld<T>::v;
  const float kOne[2] = {1.f, 1.f};  // pv's alpha: add the tile's part
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_lse[kBlock], s_delta[kBlock];
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_do = s_q + kBlock * ld;
  T* s_qs = s_do + kBlock * ld;
  T* s_dos = s_qs + small_rows<T>() * ld;
  T* s_k = s_dos + small_rows<T>() * ld;
  T* s_v = s_k + kStages * kStream * ld;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;  // last tile first
  const int q_last = min(q0 + kBlock, sq) - 1;
  const int kv_head = (bh / h) * (h / group) + (bh % h) / group;
  const size_t q_base = (size_t)bh * sq * d;
  const T* kp = k + (size_t)kv_head * skv * d;
  const T* vp = v + (size_t)kv_head * skv * d;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups, kq = warp / kRowGroups;
  const int wr = rg * 16;      // the warp's first row in the block
  const int wc = kq * kWarpN;  // and its first row in a kv tile

  zero_pad<kThreads>(s_q, 2 * kBlock, ld, d, tid);            // Q, dO
  zero_pad<kThreads>(s_k, 2 * kStages * kStream, ld, d, tid);  // K, V rings

  // Q and dO, one cp.async group; then the first kStages - 1 kv tiles, a
  // group each; each tile's turn waits for its group and issues the tile
  // kStages - 1 ahead into the buffer the last turn freed
  const Band band = kv_band(q0, q_last, skv, causal, window, q_off, k_off,
                            kStream);
  auto issue = [&](int tile, int at) {  // kv tile `tile` into buffer `at`
    load_tile<kThreads>(s_k + at * kStream * ld, ld, kp, tile * kStream,
                        kStream, skv, d, vec, tid);
    load_tile<kThreads>(s_v + at * kStream * ld, ld, vp, tile * kStream,
                        kStream, skv, d, vec, tid);
  };
  load_tile<kThreads>(s_q, ld, q + q_base, q0, kBlock, sq, d, vec, tid);
  load_tile<kThreads>(s_do, ld, dout + q_base, q0, kBlock, sq, d, vec, tid);
  cp_async_commit();
  for (int st = 0; st < kStages - 1; ++st) {
    if (band.lo + st <= band.hi) issue(band.lo + st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();

  // delta = rowsum(dO o O) and lse of the block's rows, four rows a warp
  for (int i = 0; i < kBlock / (kRowGroups * kSplit); ++i) {
    const int r = warp * (kBlock / (kRowGroups * kSplit)) + i;
    const int row = q0 + r;
    float part = 0.f;
    if (row < sq) {
      const T* orow = out + q_base + (size_t)row * d;
      for (int c = lane; c < d; c += 32)
        part = fmaf(to_float(s_do[r * ld + c]), to_float(orow[c]), part);
    }
    part = warp_sum(part);
    if (lane == 0) {
      s_delta[r] = part;
      s_lse[r] = row < sq ? live_lse(lse[(size_t)bh * sq + row]) : INFINITY;
      if (row < sq) delta[(size_t)bh * sq + row] = part;
    }
  }
  __syncthreads();
  split_rows<kThreads>(s_q, s_qs, kBlock, ld, tid);
  split_rows<kThreads>(s_do, s_dos, kBlock, ld, tid);
  __syncthreads();
  const float row_lse[2] = {s_lse[wr + g], s_lse[wr + g + 8]};
  const float row_delta[2] = {s_delta[wr + g], s_delta[wr + g + 8]};

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tile = band.lo; tile <= band.hi; ++tile) {
    const int buf = (tile - band.lo) % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile is in; every warp is done with the last
    const int ahead = tile + kStages - 1;
    if (ahead <= band.hi) issue(ahead, (ahead - band.lo) % kStages);
    cp_async_commit();
    const T* tk = s_k + (buf * kStream + wc) * ld;
    const T* tv = s_v + (buf * kStream + wc) * ld;
    const int kv0 = tile * kStream;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    abt<kD>(s, s_q + wr * ld, s_qs + wr * ld, tk, g, t);
    abt<kD>(dp, s_do + wr * ld, s_dos + wr * ld, tv, g, t);

    // every (row, col) pair of the block and tile live: no mask
    const bool full =
        kv0 + kStream <= skv &&
        (!causal || kv0 + kStream - 1 + k_off <= q0 + q_off) &&
        (window <= 0 || kv0 + k_off > q_last + q_off - window);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = expf(s[j][e] * scale - row_lse[r]);
        if (!full) {
          const int col = kv0 + wc + 8 * j + 2 * t + (e & 1);
          const int row = q0 + wr + g + 8 * r;
          if (!(col < skv && attends(row + q_off, col + k_off, causal, window)))
            p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - row_delta[r]) * scale;  // dS
      }
    pv<kD, kNT, ld>(acc, s, kOne, tk, g, t);
  }

  __syncthreads();  // the tiles' memory becomes the merge area
  float* x = reinterpret_cast<float*>(smem_raw);
  merge_put<kD>(x, 0, kq, wr, acc, g, t);
  __syncthreads();
  if (kq > 0) return;
  merge_add<kD>(x, 0, wr, acc, g, t);
  store_rows<T, kD>(dq + q_base, q0, sq, d, wr, acc, g, t);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int group, int sq, int skv,
                     int d, float scale, int causal, int window, int q_off,
                     int k_off, int vec) {
  constexpr int ld = Ld<T>::v;
  const float kOne[2] = {1.f, 1.f};  // pv's alpha: add the tile's part
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_k = reinterpret_cast<T*>(smem_raw);
  T* s_v = s_k + kBlock * ld;
  T* s_ks = s_v + kBlock * ld;
  T* s_vs = s_ks + small_rows<T>() * ld;
  T* s_q = s_vs + small_rows<T>() * ld;
  T* s_do = s_q + kStages * kStream * ld;

  const int bkv = blockIdx.x;  // batch * hkv + kv head
  const int kv0 = blockIdx.y * kBlock;
  const int kv_last = min(kv0 + kBlock, skv) - 1;
  const int hkv = h / group;
  const int head0 = (bkv / hkv) * h + (bkv % hkv) * group;  // first q head
  const size_t kv_base = (size_t)bkv * skv * d;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups, kq = warp / kRowGroups;
  const int wr = rg * 16;      // the warp's first kv row in the block
  const int wc = kq * kWarpN;  // and its first row in a q tile

  zero_pad<kThreads>(s_k, 2 * kBlock, ld, d, tid);            // K, V
  zero_pad<kThreads>(s_q, 2 * kStages * kStream, ld, d, tid);  // Q, dO rings

  // the streamed tiles: the band of q tiles of each of the group's query
  // heads in turn, turn i = (head i / n, tile lo + i % n)
  const Band band = q_band(kv0, kv_last, sq, causal, window, q_off, k_off,
                           kStream);
  const int n = max(0, band.hi - band.lo + 1);
  const int turns = group * n;
  auto issue = [&](int i, int at) {  // turn i into buffer `at`
    const size_t q_base = (size_t)(head0 + i / n) * sq * d;
    const int qs = (band.lo + i % n) * kStream;
    load_tile<kThreads>(s_q + at * kStream * ld, ld, q + q_base, qs, kStream,
                        sq, d, vec, tid);
    load_tile<kThreads>(s_do + at * kStream * ld, ld, dout + q_base, qs,
                        kStream, sq, d, vec, tid);
  };
  load_tile<kThreads>(s_k, ld, k + kv_base, kv0, kBlock, skv, d, vec, tid);
  load_tile<kThreads>(s_v, ld, v + kv_base, kv0, kBlock, skv, d, vec, tid);
  cp_async_commit();
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < turns) issue(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  split_rows<kThreads>(s_k, s_ks, kBlock, ld, tid);
  split_rows<kThreads>(s_v, s_vs, kBlock, ld, tid);
  __syncthreads();

  float acc_k[kD / 8][4], acc_v[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int i = 0; i < turns; ++i) {
    const int buf = i % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile is in; every warp is done with the last
    const int ahead = i + kStages - 1;
    if (ahead < turns) issue(ahead, ahead % kStages);
    cp_async_commit();
    const int bh = head0 + i / n;
    const int qs = (band.lo + i % n) * kStream;
    const int q_tile_last = min(qs + kStream, sq) - 1;
    const T* tq = s_q + (buf * kStream + wc) * ld;
    const T* tdo = s_do + (buf * kStream + wc) * ld;

    // lse and delta of the warp's query columns 8j + 2t + c
    float col_lse[kNT][2], col_delta[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = qs + wc + 8 * j + 2 * t + c;
        const bool in = qi < sq;
        col_lse[j][c] = in ? live_lse(lse[(size_t)bh * sq + qi]) : INFINITY;
        col_delta[j][c] = in ? delta[(size_t)bh * sq + qi] : 0.f;
      }

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    abt<kD>(s, s_k + wr * ld, s_ks + wr * ld, tq, g, t);    // S^T
    abt<kD>(dp, s_v + wr * ld, s_vs + wr * ld, tdo, g, t);  // dP^T

    // every (q row, kv row) pair of the tile and block live: no mask
    const bool full =
        qs + kStream <= sq &&
        (!causal || kv_last + k_off <= qs + q_off) &&
        (window <= 0 || kv0 + k_off > q_tile_last + q_off - window);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        float p = expf(s[j][e] * scale - col_lse[j][c]);
        if (!full) {
          const int qi = qs + wc + 8 * j + 2 * t + c;
          const int kj = kv0 + wr + g + 8 * (e >> 1);
          if (!attends(qi + q_off, kj + k_off, causal, window)) p = 0.f;
        }
        s[j][e] = p;                                          // P^T
        dp[j][e] = p * (dp[j][e] - col_delta[j][c]) * scale;  // dS^T
      }
    pv<kD, kNT, ld>(acc_v, s, kOne, tdo, g, t);
    pv<kD, kNT, ld>(acc_k, dp, kOne, tq, g, t);
  }

  __syncthreads();  // the tiles' memory becomes the merge area
  float* x = reinterpret_cast<float*>(smem_raw);
  merge_put<kD>(x, 0, kq, wr, acc_k, g, t);
  merge_put<kD>(x, 1, kq, wr, acc_v, g, t);
  __syncthreads();
  if (kq > 0) return;
  merge_add<kD>(x, 0, wr, acc_k, g, t);
  merge_add<kD>(x, 1, wr, acc_v, g, t);
  store_rows<T, kD>(dk + kv_base, kv0, skv, d, wr, acc_k, g, t);
  store_rows<T, kD>(dv + kv_base, kv0, skv, d, wr, acc_v, g, t);
}

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, void* delta, void* dq,
              int b, int h, int hkv, int sq, int skv, int d, float scale,
              int causal, int window, int q_off, int k_off,
              cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t bytes = smem_bytes<T, 1>();
  const int err = allow_smem(flash_bwd_dq_kernel<T, kD>, bytes, &smem_set);
  if (err != (int)cudaSuccess) return err;
  const int vec = (d * sizeof(T)) % 16 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);
  const dim3 grid(b * h, (sq + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), h, h / hkv, sq, skv,
      d, scale, causal, window, q_off, k_off, vec);
  return (int)cudaGetLastError();
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int b, int h, int hkv, int sq, int skv,
               int d, float scale, int causal, int window, int q_off,
               int k_off, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t bytes = smem_bytes<T, 2>();
  const int err = allow_smem(flash_bwd_dkv_kernel<T, kD>, bytes, &smem_set);
  if (err != (int)cudaSuccess) return err;
  const int vec = (d * sizeof(T)) % 16 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);
  const dim3 grid(b * hkv, (skv + kBlock - 1) / kBlock);
  flash_bwd_dkv_kernel<T, kD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), h, h / hkv, sq, skv, d,
      scale, causal, window, q_off, k_off, vec);
  return (int)cudaGetLastError();
}

// the head columns the MMAs cover: d rounded up to 32, 64 or 128
#define EGT_BY_HEAD_DIM(launch, T, ...)                 \
  (d <= 32   ? launch<T, 32>(__VA_ARGS__)               \
   : d <= 64 ? launch<T, 64>(__VA_ARGS__)               \
             : launch<T, kMaxD>(__VA_ARGS__))

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
    return EGT_BY_HEAD_DIM(launch_dq, float, q, k, v, out, dout, lse, delta,
                           dq, b, h, hkv, sq, skv, d, scale, causal, window,
                           q_off, k_off, s);
  if (dtype == 1)
    return EGT_BY_HEAD_DIM(launch_dq, __nv_bfloat16, q, k, v, out, dout, lse,
                           delta, dq, b, h, hkv, sq, skv, d, scale, causal,
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
    return EGT_BY_HEAD_DIM(launch_dkv, float, q, k, v, dout, lse, delta, dk,
                           dv, b, h, hkv, sq, skv, d, scale, causal, window,
                           q_off, k_off, s);
  if (dtype == 1)
    return EGT_BY_HEAD_DIM(launch_dkv, __nv_bfloat16, q, k, v, dout, lse,
                           delta, dk, dv, b, h, hkv, sq, skv, d, scale,
                           causal, window, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}
