// Kernel B1's Hopper mainloop for float32: the contractions of the einsum
// path (exprgrad_torch/backend/torcheval.py, lowering path "einsum-b1")
// as one GEMM on wgmma, fed by TMA.
//
// The JAX package left these contractions to XLA (jnp.einsum); the port
// ran them through torch.einsum, whose float32 GEMMs (TF32 off) are
// cuBLAS's and CUTLASS's SIMT kernels at about 50 TFLOP/s.  Under
// precision="highest" a float32 product must keep float32's accuracy, so
// this kernel keeps B1's split-TF32 arithmetic (tf32x3.cuh): each operand
// x is split as big = rna(x), small = rna(x - big), and a product is
// small.big + big.small + big.big, three TF32 products summed in float32.
// Computes
//
//   D[b, m, n] = alpha * sum_k A[b, m, k] B[b, n, k]  (+ C[b, m, n])
//
// in two steps:
//
// * egt_tf32_split, a pre-pass over each operand: reads it with any
//   strides (each of its batch, row and k groups up to three axes of the
//   einsum) and writes its big and small TF32 planes K-major, [2][batch]
//   [rows][kp] (kp = k rounded up to 4, for TMA's 16-byte row pitch).
//   wgmma takes TF32 operands K-major only; the backward's dW = X^T dY
//   and the forward's x W (W stored [in, out]) are not, and the split is
//   where they become so.  It reads 4 bytes and writes 8 an element,
//   through a 32x32 tile in shared memory when the operand's k axis is
//   not its fastest.
// * egt_gemm_tf32x3: persistent blocks of three warpgroups, one a block
//   per SM.  One thread of the first warpgroup issues TMA loads of a
//   128x128 output tile's A and B planes, 32 deep in k (128-byte rows,
//   swizzled as wgmma reads them), into a ring of three 64 KB stages,
//   completion on an mbarrier per stage; the two others each own 64 rows
//   of the tile and issue m64n128k8 TF32 wgmmas: for each 8 of the
//   stage's 32 k, small.big, big.small, big.big.  A stage's 12 wgmmas
//   sum into a fresh accumulator that is then added to the tile's running
//   float32 sum, as B1's mma.sync mainloop sums each 32-deep k group
//   (the tensor core truncates a long running sum).  Each consumer keeps
//   two fresh accumulators and issues stage kt + 1's wgmmas before it
//   waits for stage kt's and adds them, so the tensor cores never wait
//   on that addition (setmaxnreg gives the consumers 232 registers, the
//   producer 40); a stage is released to the producer once its wgmmas
//   have read it.  A block walks output tiles blockIdx.x, + gridDim.x,
//   ... in groups of 8 tile rows (so neighbouring blocks share A and B
//   rows in L2), and the producer loads the next tile's stages while the
//   consumers store this one.  The epilogue writes alpha * acc (+ C)
//   straight from the accumulator registers to D at any strides (each of
//   D's batch, m and n groups up to three axes), float2 where D's
//   innermost n axis is unit-stride.  Ragged edges: TMA zero-fills rows and k past the
//   operands' ends; stores are guarded.
//
// What bounds it: a float32-exact product is three TF32 products, so
// 3 x 2 m n k over the card's 495 TFLOP/s of TF32 (165 TFLOP/s of
// float32-exact work); bytes are far below (at 4096^3 0.83 ms of
// operations against 0.06 ms of the split planes' 8 bytes an element and
// D's 4).  The pre-pass is bandwidth-bound (12 bytes an element at
// 3.35 TB/s).  An infinite operand splits into inf and NaN, so a product
// with one reads NaN where float32 would read inf, as in B1 and B2-B4.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace egt_sm90 {

constexpr int kBM = 128;  // output tile rows: 64 for each consumer
constexpr int kBN = 128;  // output tile columns
constexpr int kBK = 32;   // k a stage: 128-byte rows
constexpr int kPlaneA = kBM * kBK * 4;  // one TF32 plane of A's tile
constexpr int kPlaneB = kBN * kBK * 4;
constexpr int kStageBytes = 2 * (kPlaneA + kPlaneB);  // big, small: A, B
constexpr int kStages = 3;                            // 192 KB
constexpr int kThreads = 384;  // a producer warpgroup and two consumers
constexpr int kGroupM = 8;     // tile rows of a raster group
constexpr size_t kSmem = kStages * (size_t)kStageBytes + 1024 + 64;

// Up to three axes of one group of a tensor's (batch, rows or k, ...),
// innermost first: index i of the group lies at sum of its digits (in the
// mixed radix of size[]) times stride[] elements.
struct Axes {
  long long n;  // axes used, 1 to 3 (a group of none is size 1, stride 0)
  long long size[3];
  long long stride[3];
};

// The split pre-pass's arguments (ops/matmul.py packs them).
struct SplitArgs {
  const float* x;
  float* out;  // [2][batch][rows][kp]: big plane, then small
  long long batch, rows, k, kp;
  Axes x_batch, x_rows, x_k;
};

// The GEMM's arguments (ops/matmul.py packs them): a and b are split
// planes [2][batch][m or n][kp]; d and c (null: none) are indexed by
// d_batch, d_m and d_n.
struct GemmArgs {
  const float* a;
  const float* b;
  float* d;
  const float* c;
  long long batch, m, n, k, kp;
  double alpha;
  Axes d_batch, d_m, d_n;
};

// What the consumers' epilogue needs, by value in the kernel's parameters.
struct Epi {
  float* d;
  const float* c;
  float alpha;
  int m, n;
  int pairs;  // D's innermost n axis is unit-stride and even, offsets even
  Axes d_batch, d_m, d_n;
};

__device__ __forceinline__ long long axes_offset(const Axes& a, int i) {
  if (a.n <= 1) return (long long)i * a.stride[0];
  long long off = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (d + 1 >= a.n) {
      off += (long long)i * a.stride[d];
      break;
    }
    const int size = (int)a.size[d];
    const int q = i / size;
    off += (long long)(i - q * size) * a.stride[d];
    i = q;
  }
  return off;
}

// d (+)= a . b: one m64n128k8 TF32 wgmma, A and B K-major in shared memory
// (descriptors a, b), float32 accumulator; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Output tile `tile` of the walk: its batch, tile row and tile column.
// Within a batch, tiles go by groups of kGroupM tile rows, column by
// column inside a group.
__device__ __forceinline__ void tile_at(int tile, int m_tiles, int n_tiles,
                                        int& b, int& mt, int& nt) {
  const int per = m_tiles * n_tiles;
  b = tile / per;
  const int r = tile - b * per;
  const int span = kGroupM * n_tiles;
  const int g = r / span;
  const int first = g * kGroupM;
  const int rows = min(m_tiles - first, kGroupM);
  const int in = r - g * span;
  mt = first + in % rows;
  nt = in / rows;
}

// A consumer's wgmmas of one stage for 64 rows of the tile: for each 8 of
// the stage's 32 k, small.big, big.small and big.big into a fresh `part`
// (a0: the rows' big plane of A, b0: B's big plane).
__device__ __forceinline__ void issue_stage(float (&part)[64], uint32_t a0,
                                            uint32_t b0) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const uint64_t a_big = smem_desc(a0 + kk * 32);
    const uint64_t a_small = smem_desc(a0 + kPlaneA + kk * 32);
    const uint64_t b_big = smem_desc(b0 + kk * 32);
    const uint64_t b_small = smem_desc(b0 + kPlaneB + kk * 32);
    wgmma_tf32(part, a_small, b_big, kk > 0);
    wgmma_tf32(part, a_big, b_small, 1);
    wgmma_tf32(part, a_big, b_big, 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void add_part(float (&acc)[64],
                                         float (&part)[64]) {
  fence_operands(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i];
}

// Store 64 rows of a tile: the accumulator's element (row g or g + 8 of
// the warp's 16, column 8 j + 2 t or + 1) is acc[4 j + 2 i + c].  The
// columns' offsets are worked out once a tile; with `pairs` a column and
// its neighbour are neighbours in D too (float2).
__device__ __forceinline__ void store_rows(const Epi& ep, float (&acc)[64],
                                           int row0, int col0,
                                           long long boff) {
  long long coff[kBN / 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
    coff[j] = col0 + 8 * j < ep.n ? axes_offset(ep.d_n, col0 + 8 * j) : 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= ep.m) continue;
    const long long roff = boff + axes_offset(ep.d_m, r);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= ep.n) continue;
      float v0 = ep.alpha * acc[4 * j + 2 * i];
      float v1 = ep.alpha * acc[4 * j + 2 * i + 1];
      const long long off = roff + coff[j];
      if (ep.pairs) {
        if (ep.c) {
          const float2 c2 = *reinterpret_cast<const float2*>(ep.c + off);
          v0 = c2.x + v0;
          v1 = c2.y + v1;
        }
        *reinterpret_cast<float2*>(ep.d + off) = make_float2(v0, v1);
      } else {
        if (ep.c) v0 = ep.c[off] + v0;
        ep.d[off] = v0;
        if (col + 1 < ep.n) {
          const long long off1 = roff + axes_offset(ep.d_n, col + 1);
          if (ep.c) v1 = ep.c[off1] + v1;
          ep.d[off1] = v1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const Epi ep,
                int k_tiles, int m_tiles, int n_tiles, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread keeps the ring's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, mt, nt;
        tile_at(tile, m_tiles, n_tiles, b, mt, nt);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          uint8_t* stage = smem + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_4d(stage, &map_a, &full[s], kt * kBK, mt * kBM, b, 0);
          tma_load_4d(stage + 2 * kPlaneA, &map_b, &full[s], kt * kBK,
                      nt * kBN, b, 0);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup w owns rows w * 64 .. w * 64 + 63 of a
  // tile, its running sum and two fresh accumulators (232 registers)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int s = 0;
  uint32_t phase = 0;
  auto a_rows = [&](int st) {
    return smem_u32(smem + st * kStageBytes) + w * 64 * kBK * 4;
  };
  auto b_base = [&](int st) {
    return smem_u32(smem + st * kStageBytes + 2 * kPlaneA);
  };
  auto release = [&]() {
    mbar_arrive(&empty[s]);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, mt, nt;
    tile_at(tile, m_tiles, n_tiles, b, mt, nt);
    const int row0 = mt * kBM + w * 64 + warp * 16 + lane / 4;
    const int col0 = nt * kBN + 2 * (lane % 4);
    const long long boff = axes_offset(ep.d_batch, b);
    // stage kt + 1's wgmmas run while stage kt's sum is added
    float acc[64], p0[64], p1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int issued = s;  // the next stage to issue, and its phase
    uint32_t issued_phase = phase;
    auto next = [&](float(&part)[64]) {
      mbar_wait(&full[issued], issued_phase);
      fence_operands(part);
      issue_stage(part, a_rows(issued), b_base(issued));
      if (++issued == kStages) {
        issued = 0;
        issued_phase ^= 1;
      }
    };
    next(p0);
    for (int kt = 0; kt < k_tiles; kt += 2) {
      if (kt + 1 < k_tiles) {
        next(p1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      release();
      add_part(acc, p0);
      if (kt + 1 >= k_tiles) break;
      if (kt + 2 < k_tiles) {
        next(p0);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      release();
      add_part(acc, p1);
    }
    store_rows(ep, acc, row0, col0, boff);
  }
}

// The split pre-pass: a 32 x 32 (rows x k) tile of one batch a block,
// read along the operand's faster axis, written along k.
__global__ void __launch_bounds__(256) split_kernel(const SplitArgs p) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.x * 32, k0 = blockIdx.y * 32, b = blockIdx.z;
  const int rows = (int)p.rows, k = (int)p.k, kp = (int)p.kp;
  const long long base = axes_offset(p.x_batch, b);
  if (p.x_k.stride[0] == 1 || p.x_rows.stride[0] != 1) {
    const int kk = k0 + tx;
    const long long koff = kk < k ? axes_offset(p.x_k, kk) : 0;
    for (int i = ty; i < 32; i += 8) {
      const int r = r0 + i;
      tile[i][tx] = r < rows && kk < k
                        ? p.x[base + axes_offset(p.x_rows, r) + koff]
                        : 0.f;
    }
  } else {
    const int r = r0 + tx;
    const long long roff = r < rows ? axes_offset(p.x_rows, r) : 0;
    for (int i = ty; i < 32; i += 8) {
      const int kk = k0 + i;
      tile[tx][i] = r < rows && kk < k
                        ? p.x[base + roff + axes_offset(p.x_k, kk)]
                        : 0.f;
    }
  }
  __syncthreads();
  const int kk = k0 + tx;
  if (kk >= kp) return;
  const long long plane = p.batch * p.rows * p.kp;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i;
    if (r >= rows) break;
    uint32_t big, small;
    egt_mma::split_tf32(tile[i][tx], big, small);
    const long long at = ((long long)b * rows + r) * kp + kk;
    p.out[at] = __uint_as_float(big);
    p.out[plane + at] = __uint_as_float(small);
  }
}

// The tensor map of split planes [2][batch][rows][kp] with k valid
// columns: boxes {kBK, box_rows, 1, 2}, 128-byte swizzle, zero fill past
// the ends.
bool plane_map(CUtensorMap* map, const float* planes, long long batch,
               long long rows, long long k, long long kp, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)rows,
                              (cuuint64_t)batch, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)kp * 4,
                                 (cuuint64_t)(rows * kp) * 4,
                                 (cuuint64_t)(batch * rows * kp) * 4};
  const cuuint32_t box[4] = {kBK, (cuuint32_t)box_rows, 1, 2};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<float*>(planes), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool axes_ok(const Axes& a) {
  if (a.n < 1 || a.n > 3) return false;
  for (int d = 0; d < a.n; ++d)
    if (a.size[d] < 1 || a.size[d] > INT_MAX) return false;
  return true;
}

// Whether the group's axes from the `from`-th innermost on have even
// strides.
bool even(const Axes& a, int from = 0) {
  for (int d = from; d < a.n; ++d)
    if (a.stride[d] % 2) return false;
  return true;
}

}  // namespace egt_sm90

using egt_sm90::GemmArgs;
using egt_sm90::SplitArgs;

// The split pre-pass (see the top of this file).  Returns a cudaError_t.
extern "C" int egt_tf32_split(const SplitArgs* p, void* stream) {
  using namespace egt_sm90;
  if (p->batch < 1 || p->batch > 65535 || p->rows < 0 ||
      p->rows > INT_MAX - 32 || p->k < 0 || p->kp < p->k ||
      p->kp > 65535LL * 32 || !axes_ok(p->x_batch) ||
      !axes_ok(p->x_rows) || !axes_ok(p->x_k))
    return (int)cudaErrorInvalidValue;
  if (p->rows == 0 || p->kp == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((p->rows + 31) / 32),
                  (unsigned)((p->kp + 31) / 32), (unsigned)p->batch);
  split_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

// The GEMM over split planes (see the top of this file).  Returns a
// cudaError_t; a tensor map that cannot be encoded is
// cudaErrorInvalidValue.
extern "C" int egt_gemm_tf32x3(const GemmArgs* x, void* stream) {
  using namespace egt_sm90;
  if (x->batch < 1 || x->m < 0 || x->n < 0 || x->k < 1 ||
      x->m > INT_MAX - kBM || x->n > INT_MAX - kBN || x->kp < x->k ||
      x->kp % 4 || !axes_ok(x->d_batch) || !axes_ok(x->d_m) ||
      !axes_ok(x->d_n))
    return (int)cudaErrorInvalidValue;
  if (x->m == 0 || x->n == 0) return (int)cudaSuccess;
  const long long m_tiles = (x->m + kBM - 1) / kBM;
  const long long n_tiles = (x->n + kBN - 1) / kBN;
  const long long tiles = x->batch * m_tiles * n_tiles;
  const long long k_tiles = (x->k + kBK - 1) / kBK;
  if (tiles > INT_MAX || k_tiles > INT_MAX / kBK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!plane_map(&map_a, x->a, x->batch, x->m, x->k, x->kp, kBM) ||
      !plane_map(&map_b, x->b, x->batch, x->n, x->k, x->kp, kBN))
    return (int)cudaErrorInvalidValue;
  Epi ep;
  ep.d = x->d;
  ep.c = x->c;
  ep.alpha = (float)x->alpha;
  ep.m = (int)x->m;
  ep.n = (int)x->n;
  ep.d_batch = x->d_batch;
  ep.d_m = x->d_m;
  ep.d_n = x->d_n;
  ep.pairs = x->d_n.stride[0] == 1 && x->d_n.size[0] % 2 == 0 &&
             even(x->d_n, 1) && even(x->d_batch) &&
             even(x->d_m) && reinterpret_cast<uintptr_t>(x->d) % 8 == 0 &&
             reinterpret_cast<uintptr_t>(x->c) % 8 == 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, ep, (int)k_tiles, (int)m_tiles, (int)n_tiles,
      (int)tiles);
  return (int)cudaGetLastError();
}
