// The serving decode step's float32 weight products on the tensor cores:
//
//   Y[g, m, n] = sum_k X[g, m, k] W[g, k, n]      (m <= 32)
//
// for the few rows of a decode step (one a slot) against a weight that
// is read once a step.  The JAX package leaves these products to XLA
// (jnp einsums and matmuls in exprgrad_tpu/models/serve.py's _step); the
// port ran them through torch.matmul and torch.einsum, whose float32
// kernels (TF32 off) are cuBLAS's float32 tiles at 32-64 rows.  No Pallas
// kernel is replaced: this one is added because at 32 rows the product is
// bound by the weight's bytes (48 TF32 operations a weight byte: 32 rows,
// a multiply and an add, three products; the card's ridge is about 148),
// and cuBLAS's float32 tiles reached about half of that bound (PERF.md).
//
// Design:
// * Swap-AB wgmma.  A warpgroup's wgmma takes 64 rows of A; here those
//   are 64 weight columns, and the rows of X are its N (32, zero past m).
//   A is read from registers: each consumer thread loads its fragment of
//   the weight tile from shared memory and splits it into TF32 big and
//   small halves there (tf32x3.cuh), so nothing rewrites W and every
//   weight byte crosses HBM once.  B is X's slice of the stage, which
//   each consumer warpgroup splits into big and small planes of its own,
//   K-major in 128-byte swizzled rows, as wgmma reads TF32.  Each 8 of a
//   stage's 32 k run the three products in two wgmmas: W big against both
//   X planes as one 64-row B (W big . X big, W big . X small), then W
//   small . X big into the first product's registers; the stage's sum
//   (a fresh accumulator) is added to the run's float32 sum, as B1's
//   kernels sum each 32-deep k slice (the tensor core truncates a long
//   running sum).
// * A ring of kStages stages, each a 32 x 128 weight tile and X's 32 x 32
//   slice, kept full by one producer thread's TMA loads; two blocks an
//   SM, so that one block's wgmmas and splits run while the other's wait
//   (a consumer warpgroup takes a stage at a time: its latency, not the
//   tensor core's rate, bounds it).  setmaxnreg gives the consumers 104
//   registers, the producer 24.
// * Split-K over the card: the work is g x (n / 128) tiles of k / 32
//   stages each, walked tile by tile; block b takes stages [b per,
//   (b + 1) per), per a whole number of tiles or an equal part of one
//   (ops/matmul.py's skinny_plan), so that the blocks read neighbouring
//   tiles at the same k together.  A tile that one
//   block covers whole is stored from registers.  The others' pieces go
//   to a scratch slot of their block, and the last of the tile's blocks
//   to arrive (a counter a tile, left at 0 for the next launch) adds them
//   up in k order and stores the tile: the same bits every launch and
//   every graph replay.
//
// Operands: X is [g][m][k] with unit k stride (its group stride may be 0:
// one X for every group); W is [g][k][heads][hw] with unit stride along
// hw and n = head * hw + column (a head axis that lies between k and the
// columns, as the attention's [h, c, d] weights store it; hw a multiple
// of 128 when there are several heads, so no tile straddles two); Y is
// [g][m][n], contiguous.  An infinite operand splits into inf and NaN,
// so a product with one reads NaN where float32 would read inf, as in
// B1-B4.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace egt_skinny {

using namespace egt_sm90;

constexpr int kRows = 32;                      // wgmma N: rows of X
constexpr int kBN = 128;                       // weight columns a tile
constexpr int kBK = 32;                        // k a stage
constexpr int kWBytes = kBK * kBN * 4;         // 16 KB
constexpr int kXBytes = kRows * kBK * 4;       // 4 KB, as X holds it
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kStages = 4;                     // 80 KB
constexpr int kPlanes = 2 * kXBytes;           // X's big and small planes
constexpr int kThreads = 384;  // the producer warpgroup, two consumers
constexpr int kBlocksPerSM = 2;
constexpr int kTile = kRows * kBN;             // floats of a scratch slot
// the ring, then each consumer warpgroup's planes, then the barriers and
// the last-block flag
constexpr int kPlaneBase = kStages * kStageBytes;
constexpr int kBarBase = kPlaneBase + 2 * kPlanes;
constexpr size_t kSmem = kBarBase + 2 * kStages * sizeof(uint64_t) + 16 +
                         1024;

// egt_skinny_gemm's arguments (ops/matmul.py packs them).
struct SkinnyArgs {
  const float* x;
  const float* w;
  float* y;
  float* partial;  // [grid][2][kRows][kBN]
  int* counters;   // one a tile, 0 on entry and on exit
  long long g, m, n, k, hw;
  long long x_g, x_m;       // X's group (0: one X) and row strides
  long long w_g, w_k, w_h;  // W's group, k and head strides (elements)
  long long per, grid;      // stages a block, blocks
};

struct Params {
  float* y;
  float* partial;
  int* counters;
  int m, n, k, k_tiles, n_tiles, hw, per, pairs, x_groups;
  long long units;
};

// d (+)= a . b: one m64n32k8 TF32 wgmma, A from registers (the thread's
// fragment), B K-major in shared memory (descriptor b), float32
// accumulator; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// d (+)= a . b: one m64n64k8 TF32 wgmma, A from registers, B the 64
// K-major rows at descriptor b; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// X's row r, k 4c .. 4c + 3 of a stage, split and stored into the big and
// small planes at `planes` (row r at r * 128 bytes, its 16-byte chunk c
// at chunk c ^ (r % 8): wgmma's 128-byte swizzle).
__device__ __forceinline__ void put_split(uint8_t* planes, int r, int c,
                                          float4 v) {
  uint4 big, small;
  egt_mma::split_tf32(v.x, big.x, small.x);
  egt_mma::split_tf32(v.y, big.y, small.y);
  egt_mma::split_tf32(v.z, big.z, small.z);
  egt_mma::split_tf32(v.w, big.w, small.w);
  const int off = r * 128 + ((c ^ (r & 7)) << 4);
  *reinterpret_cast<uint4*>(planes + off) = big;
  *reinterpret_cast<uint4*>(planes + kXBytes + off) = small;
}

// What a consumer warpgroup prepares of a stage before its wgmmas: its
// X planes (thread t splits row t / 4, k 8 (t % 4) .. + 7 of the stage's
// X, stored by TMA as [kRows][kBK]) and its threads' A fragments, the
// weight at k rows 8 kk + t4 (+ 4) and columns col, col + 1, split
// (big[4 kk + i], small[4 kk + i]: a0 .. a3 of k step kk).  `bar` is the
// warpgroup's named barrier: the planes are complete, and visible to
// wgmma, once it is passed.
__device__ __forceinline__ void prepare(const uint8_t* stage, uint8_t* planes,
                                        int t, int t4, int col, int bar,
                                        uint32_t (&big)[16],
                                        uint32_t (&small)[16]) {
  const float4* xs =
      reinterpret_cast<const float4*>(stage + kWBytes) + 2 * t;
  put_split(planes, t >> 2, 2 * (t & 3), xs[0]);
  put_split(planes, t >> 2, 2 * (t & 3) + 1, xs[1]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const float* ws = reinterpret_cast<const float*>(stage);
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const float2 lo =
        *reinterpret_cast<const float2*>(ws + (8 * kk + t4) * kBN + col);
    const float2 hi = *reinterpret_cast<const float2*>(
        ws + (8 * kk + t4 + 4) * kBN + col);
    egt_mma::split_tf32(lo.x, big[4 * kk], small[4 * kk]);
    egt_mma::split_tf32(lo.y, big[4 * kk + 1], small[4 * kk + 1]);
    egt_mma::split_tf32(hi.x, big[4 * kk + 2], small[4 * kk + 2]);
    egt_mma::split_tf32(hi.y, big[4 * kk + 3], small[4 * kk + 3]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}

// The stage's wgmmas (see prepare) into a fresh accumulator `part`: for
// each 8 of its k, W big against both X planes at once (the big plane's
// 32 rows then the small plane's are one 64-row B, so one m64n64k8 gives
// W big . X big in columns 0 .. 31 and W big . X small in 32 .. 63), then
// W small . X big (one m64n32k8) added to columns 0 .. 31, which hold the
// first 16 of part's registers in the same layout.
__device__ __forceinline__ void issue(uint32_t planes, uint32_t (&big)[16],
                                      uint32_t (&small)[16],
                                      float (&part)[32]) {
  float(&low)[16] = *reinterpret_cast<float(*)[16]>(&part[0]);
  fence_operands(part);
  fence_operands(big);  // the split is done before the fence
  fence_operands(small);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const uint64_t x = smem_desc(planes + kk * 32);
    const uint32_t* b4 = big + 4 * kk;
    const uint32_t* s4 = small + 4 * kk;
    wgmma_rs64(part, b4[0], b4[1], b4[2], b4[3], x, kk > 0);
    wgmma_rs(low, s4[0], s4[1], s4[2], s4[3], x, 1);
  }
  wgmma_commit();
}

// The first and the last block of tile `tile`'s stages.
__device__ __forceinline__ void tile_blocks(const Params& p, int tile,
                                            int& first, int& last) {
  const long long u = (long long)tile * p.k_tiles;
  first = (int)(u / p.per);
  last = (int)((u + p.k_tiles - 1) / p.per);
}

// This thread's part of a tile's 32 x 128 sums, stored to Y: element
// (row 8 j + 2 t + c, column col + i) is acc[4 j + 2 i + c].
__device__ __forceinline__ void store_tile(const Params& p,
                                           const float (&acc)[16], int g,
                                           int n0, int col, int t) {
  const int n = n0 + col;
  if (n >= p.n) return;
  float* y = p.y + (long long)g * p.m * p.n + n;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = 8 * j + 2 * t + c;
      if (m >= p.m) continue;
      float* at = y + (long long)m * p.n;
      if (p.pairs) {
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[4 * j + c], acc[4 * j + 2 + c]);
      } else {
        at[0] = acc[4 * j + c];
        if (n + 1 < p.n) at[1] = acc[4 * j + 2 + c];
      }
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    skinny_kernel(const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_x, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarBase);
  uint64_t* empty = full + kStages;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + kStages);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long u0 = (long long)blockIdx.x * p.per;
  const long long u1 = min(p.units, u0 + p.per);

  if (wg == 0) {
    // the producer: one thread keeps the ring's loads in flight, each
    // stage the weight tile and X's slice
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (long long u = u0; u < u1; ++u) {
        const int tile = (int)(u / p.k_tiles);
        const int kt = (int)(u - (long long)tile * p.k_tiles);
        const int g = tile / p.n_tiles, nt = tile - g * p.n_tiles;
        const int n0 = nt * kBN, head = n0 / p.hw;
        mbar_wait(&empty[s], phase ^ 1);
        uint8_t* stage = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_4d(stage, &map_w, &full[s], n0 - head * p.hw, kt * kBK,
                    head, g);
        tma_load_4d(stage + kWBytes, &map_x, &full[s], kt * kBK, 0,
                    p.x_groups > 1 ? g : 0, 0);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup w owns columns 64 w .. 64 w + 63 of a tile;
  // its warp q's A rows g and g + 8 are columns col and col + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 104;\n");
  const int w = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int col = 64 * w + 16 * warp + 2 * g8;
  uint8_t* planes = smem + kPlaneBase + w * kPlanes;
  const int bar = 2 + w;
  int s = 0;
  uint32_t phase = 0;
  for (long long u = u0; u < u1;) {
    const int tile = (int)(u / p.k_tiles);
    const int kt0 = (int)(u - (long long)tile * p.k_tiles);
    const int run = (int)min((long long)(p.k_tiles - kt0), u1 - u);
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int i = 0; i < run; ++i) {
      mbar_wait(&full[s], phase);
      uint32_t big[16], small[16];
      float part[32];
      prepare(smem + s * kStageBytes, planes, t, t4, col, bar, big, small);
      issue(smem_u32(planes), big, small, part);
      wgmma_wait<0>();
      fence_operands(part);
      fence_operands(big);
      fence_operands(small);
      mbar_arrive(&empty[s]);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
      // acc += W big . X small + (W big . X big + W small . X big); column
      // 8 j + 2 t + c of W big . X small is part[16 + 4 j + .]
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += part[16 + j] + part[j];
    }
    const int g = tile / p.n_tiles;
    const int n0 = (tile - g * p.n_tiles) * kBN;
    if (run == p.k_tiles) {
      store_tile(p, acc, g, n0, col, t4);
    } else {
      // a piece of the tile: to this block's slot (0: its first run),
      // then the tile's last block to arrive sums the pieces in k order
      float* mine = p.partial + ((long long)blockIdx.x * 2 + (u != u0)) *
                                    kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          *reinterpret_cast<float2*>(mine + (8 * j + 2 * t4 + c) * kBN +
                                     col) =
              make_float2(acc[4 * j + c], acc[4 * j + 2 + c]);
      __threadfence();
      consumer_sync();
      int first, last;
      tile_blocks(p, tile, first, last);
      if (threadIdx.x == 128) {
        const int seen = atomicAdd(&p.counters[tile], 1);
        const int done = seen == last - first;
        if (done) p.counters[tile] = 0;  // ready for the next launch
        *last_flag = done;
      }
      consumer_sync();
      if (*last_flag) {
        __threadfence();
        float sum[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) sum[i] = 0.f;
        // kBatch pieces' loads in flight at once, added in block order
        constexpr int kBatch = 4;
        for (int b0 = first; b0 <= last; b0 += kBatch) {
          float2 v[kBatch][8];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int b = min(b0 + i, last);
            // block b's slot 0 holds the tile when the tile is its first
            const long long bu = (long long)b * p.per;
            const int slot = bu / p.k_tiles == tile ? 0 : 1;
            const float* src =
                p.partial + ((long long)b * 2 + slot) * kTile + col;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                v[i][2 * j + c] = __ldcg(reinterpret_cast<const float2*>(
                    src + (8 * j + 2 * t4 + c) * kBN));
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            if (b0 + i > last) break;
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                sum[4 * j + c] += v[i][2 * j + c].x;
                sum[4 * j + 2 + c] += v[i][2 * j + c].y;
              }
          }
        }
        store_tile(p, sum, g, n0, col, t4);
      }
    }
    u += run;
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace egt_skinny

using egt_skinny::SkinnyArgs;

// The product (see the top of this file).  Returns a cudaError_t;
// arguments the kernel does not take, or a tensor map that cannot be
// encoded, are cudaErrorInvalidValue.
extern "C" int egt_skinny_gemm(const SkinnyArgs* a, void* stream) {
  using namespace egt_skinny;
  if (a->g < 1 || a->g > 65535 || a->m < 1 || a->m > kRows || a->n < 1 ||
      a->k < 1 || a->k % 4 || a->hw < 1 || a->n % a->hw ||
      (a->n != a->hw && a->hw % kBN) || a->n > INT_MAX - kBN ||
      a->k > INT_MAX - kBK || a->x_g < 0 || a->x_g % 4 || a->x_m % 4 ||
      a->x_m < a->k || a->w_k % 4 || a->w_h % 4 || a->w_g % 4 ||
      a->w_k < 1 || a->per < 1 || a->grid < 1 || a->grid > INT_MAX ||
      !aligned16(a->x) || !aligned16(a->w) || a->y == nullptr ||
      a->counters == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (a->n + kBN - 1) / kBN;
  const long long k_tiles = (a->k + kBK - 1) / kBK;
  const long long units = a->g * n_tiles * k_tiles;
  if (a->g * n_tiles > INT_MAX || units > INT_MAX ||
      (a->grid - 1) * a->per >= units || a->grid * a->per < units)
    return (int)cudaErrorInvalidValue;
  if (a->partial == nullptr && a->per % k_tiles)  // pieces need a slot
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  // W as [g][heads][k][hw] boxes of {kBN columns, kBK k}, X as
  // [groups][m][k] boxes of {kBK k, kRows rows} (rows past m read 0);
  // strides of unused axes are given as if the axis were packed
  const long long heads = a->n / a->hw;
  const long long w_h = heads > 1 ? a->w_h : a->w_k * a->k;
  const long long w_g = a->g > 1 ? a->w_g : w_h * heads;
  const long long x_groups = a->x_g > 0 ? a->g : 1;
  const long long x_g = x_groups > 1 ? a->x_g : a->x_m * a->m;
  const cuuint64_t w_dims[4] = {(cuuint64_t)a->hw, (cuuint64_t)a->k,
                                (cuuint64_t)heads, (cuuint64_t)a->g};
  const cuuint64_t w_strides[3] = {(cuuint64_t)a->w_k * 4,
                                   (cuuint64_t)w_h * 4, (cuuint64_t)w_g * 4};
  const cuuint32_t w_box[4] = {kBN, kBK, 1, 1};
  const cuuint64_t x_dims[4] = {(cuuint64_t)a->k, (cuuint64_t)a->m,
                                (cuuint64_t)x_groups, 1};
  const cuuint64_t x_strides[3] = {(cuuint64_t)a->x_m * 4,
                                   (cuuint64_t)x_g * 4,
                                   (cuuint64_t)(x_g * x_groups) * 4};
  const cuuint32_t x_box[4] = {kBK, kRows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUtensorMap map_w, map_x;
  if (fn(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(a->w),
         w_dims, w_strides, w_box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      fn(&map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(a->x),
         x_dims, x_strides, x_box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = a->y;
  p.partial = a->partial;
  p.counters = a->counters;
  p.m = (int)a->m;
  p.n = (int)a->n;
  p.k = (int)a->k;
  p.k_tiles = (int)k_tiles;
  p.n_tiles = (int)n_tiles;
  p.hw = (int)a->hw;
  p.per = (int)a->per;
  p.pairs = a->n % 2 == 0 && reinterpret_cast<uintptr_t>(a->y) % 8 == 0;
  p.x_groups = (int)x_groups;
  p.units = units;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static bool attributed[64] = {};  // a device's shared-memory limit set
  if (device >= 64 || !attributed[device]) {
    err = cudaFuncSetAttribute(skinny_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) attributed[device] = true;
  }
  skinny_kernel<<<(unsigned)a->grid, kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(map_w, map_x, p);
  return (int)cudaGetLastError();
}
