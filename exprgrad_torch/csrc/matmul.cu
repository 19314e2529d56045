// Scheduled matmul with a fused elementwise epilogue, for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the Pallas TPU kernel exprgrad_tpu/ops/matmul.py::_matmul_impl
// (kernel B1: what every schedule(tile=...) contraction runs).  Computes
//
//   acc = A[m, k] . B[k, n]            float32 accumulation
//   C   = epilogue(acc) stored [m, n], or its transpose [n, m]
//
// A and B are float32 or bfloat16; C and the epilogue's extra operands are
// float32 or bfloat16.  The epilogue is data, not code: a small register
// program (EpiProgram) that the TPU kernel ran as a traced Python closure.
// It is interpreted per output element after the k loop and reads extra
// operands in the stored frame [rows, cols] (rows = n and cols = m when
// the store is transposed): pattern 0 "row" reads [1, cols] at the
// column, 1 "col" reads [rows, 1] at the row, 2 "full" reads [rows, cols].
// Register 0 holds the running value and is the result.
//
// Layout of the work: one 256-thread block per 128x128 output tile, eight
// warps of 64x32; the TPU kernel's sequential k grid axis becomes a loop
// over 32-deep k slices, fed by a four-stage cp.async ring in shared
// memory (one block barrier per slice) so that loads overlap the MMAs.
// Products run on the tensor cores with mma.sync: bfloat16 as m16n8k16
// with a float32 accumulator, float32 as split TF32 (tf32x3.cuh: three
// m16n8k8 TF32 MMAs per product, about float32's accuracy, as
// precision="highest" asks).  After the k loop the accumulator tile goes
// through shared memory in the stored frame (transposed or not); the
// epilogue runs on each element as it leaves, and neighbouring threads
// read extra operands and write C at neighbouring addresses.  Ragged
// edges are zero-filled on load and guarded on store, so no operand is
// padded in device memory.  Rows of k or n elements that are not a
// multiple of 16 bytes (k = 50 in float32), or bases not 16-byte aligned,
// take guarded plain loads in place of 16-byte cp.async.
//
// What bounds it: at 4096^3 float32 the call does 137 GFLOP and moves
// 201 MB; split TF32 issues three TF32 MMAs per product, so the card's
// TF32 rate (495 TFLOP/s) bounds it at 0.83 ms, and memory at 0.06 ms.
// It takes about 2.7 ms on an H100, level with torch.matmul's float32
// SGEMM: mma.sync does not reach wgmma's rate (about one m16n8k8 TF32 MMA
// per 13 cycles per scheduler here), each warp splits its operand
// fragments itself (two cvt and a subtraction per value), and the card
// reaches its power limit and lowers its clock under this load.  wgmma
// and TMA are later work: wgmma's TF32 form wants B K-major, and B [k, n]
// is not, and the split values would have to go back to shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace egt_mma;

constexpr int kBM = 128;     // output rows per block
constexpr int kBN = 128;     // output columns per block
constexpr int kBK = 32;      // k slice per stage
constexpr int kStages = 4;   // the cp.async ring
constexpr int kWarpsN = 4;   // warps across n; two across m
constexpr int kWM = 64;      // warp tile rows: four 16-row m-tiles
constexpr int kWN = 32;      // warp tile columns: four 8-column n-tiles
constexpr int kMT = kWM / 16;
constexpr int kNT = kWN / 8;
constexpr int kThreads = (kBM / kWM) * kWarpsN * 32;  // 256
// row strides of the staged output tile: float2 stores at (g, 2t), or
// scalar stores at (2t, g) when transposed, on 32 distinct banks
constexpr int kLdC = kBN + 8;
constexpr int kLdCT = kBM + 4;

// Limits of the epilogue program; exprgrad_torch/utils/kernels.py mirrors
// them and the struct layout.
constexpr int kMaxCode = 64;
constexpr int kMaxRegs = 32;
constexpr int kMaxConsts = 32;
constexpr int kMaxExtra = 8;

}  // namespace

// The epilogue program, passed by value into the kernel's parameter space
// (so every thread reads it from the constant bank).  code[i] =
// {op | dst << 8, a, b, c}.
struct EpiProgram {
  int n_code;
  int n_extra;
  int code[kMaxCode][4];
  float consts[kMaxConsts];
  int extra_pattern[kMaxExtra];
  const void* extra[kMaxExtra];
};

namespace {

using namespace egt_mma;

// opcodes: the ops of the JAX package's eval_elementwise (pallasgen.py)
enum Op {
  kMov = 0, kLoadConst, kLoadExtra,
  kAdd, kSub, kMul, kDiv, kNeg,
  kSin, kCos, kExp, kPow, kSqrt, kLn, kLog, kLog2, kLog10,
  kEq, kLt, kLe, kAnd, kOr, kSelect,
  kNumOps
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Booleans are 1.0 / 0.0; any nonzero value is true.
template <typename TO>
__device__ float run_epilogue(const EpiProgram& p, float acc, int i, int j,
                              int cols) {
  float reg[kMaxRegs];
  reg[0] = acc;
  for (int pc = 0; pc < p.n_code; ++pc) {
    const int op = p.code[pc][0] & 255;
    const int dst = p.code[pc][0] >> 8;
    const int a = p.code[pc][1], b = p.code[pc][2], c = p.code[pc][3];
    float v;
    switch (op) {
      case kMov: v = reg[a]; break;
      case kLoadConst: v = p.consts[a]; break;
      case kLoadExtra: {
        const TO* x = static_cast<const TO*>(p.extra[a]);
        const int pat = p.extra_pattern[a];
        const size_t at = pat == 0 ? (size_t)j
                          : pat == 1 ? (size_t)i
                                     : (size_t)i * cols + j;
        v = to_float(x[at]);
        break;
      }
      case kAdd: v = reg[a] + reg[b]; break;
      case kSub: v = reg[a] - reg[b]; break;
      case kMul: v = reg[a] * reg[b]; break;
      case kDiv: v = reg[a] / reg[b]; break;
      case kNeg: v = -reg[a]; break;
      case kSin: v = sinf(reg[a]); break;
      case kCos: v = cosf(reg[a]); break;
      case kExp: v = expf(reg[a]); break;
      case kPow: v = powf(reg[a], reg[b]); break;
      case kSqrt: v = sqrtf(reg[a]); break;
      case kLn: v = logf(reg[a]); break;
      case kLog: v = logf(reg[a]) / logf(reg[b]); break;
      case kLog2: v = log2f(reg[a]); break;
      case kLog10: v = log10f(reg[a]); break;
      case kEq: v = reg[a] == reg[b] ? 1.f : 0.f; break;
      case kLt: v = reg[a] < reg[b] ? 1.f : 0.f; break;
      case kLe: v = reg[a] <= reg[b] ? 1.f : 0.f; break;
      case kAnd: v = (reg[a] != 0.f && reg[b] != 0.f) ? 1.f : 0.f; break;
      case kOr: v = (reg[a] != 0.f || reg[b] != 0.f) ? 1.f : 0.f; break;
      default: v = reg[a] != 0.f ? reg[b] : reg[c]; break;  // kSelect
    }
    reg[dst] = v;
  }
  return reg[0];
}

// Row strides of the stage tiles A [kBM][kLdA] and B [kBK][kLdB], in
// elements, chosen so the fragment loads hit 32 distinct banks (tf32x3.cuh
// gives the lanes' positions): float32 A is read as float2 at (g, 2t) ->
// stride = 8 mod 32, B at rows (2t, 2t+1) -> stride = 4 mod 16; bfloat16 A
// as words at (g, t) -> 20 words, B as halves at rows (2t, 2t+1) -> 68
// words.  Every stride keeps rows 16-byte aligned for cp.async.
template <typename TI> struct Layout;
template <> struct Layout<float> {
  static constexpr int kLdA = kBK + 8;
  static constexpr int kLdB = kBN + 4;
};
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kLdA = kBK + 8;
  static constexpr int kLdB = kBN + 8;
};

template <typename TI>
__host__ __device__ constexpr int stage_elems() {
  return kBM * Layout<TI>::kLdA + kBK * Layout<TI>::kLdB;
}

template <typename TI>
constexpr size_t smem_bytes() {
  const size_t ring = sizeof(TI) * (size_t)kStages * stage_elems<TI>();
  const size_t out = sizeof(float) * (size_t)kBM * kLdC;  // >= kBN * kLdCT
  return ring > out ? ring : out;
}

// k slice kt of A's row panel and B's column panel into one stage.
// vec: 16-byte cp.async, zero-filled past the edges (rows of k and n
// elements are then whole 16-byte chunks); else guarded plain loads.
template <typename TI>
__device__ __forceinline__ void load_stage(TI* as, TI* bs,
                                           const TI* __restrict__ A,
                                           const TI* __restrict__ B, int m,
                                           int n, int k, int row0, int col0,
                                           int kt, bool vec, int tid) {
  using L = Layout<TI>;
  const int k0 = kt * kBK;
  if (vec) {
    constexpr int kPer = 16 / sizeof(TI);
    constexpr int kRowA = kBK / kPer;  // chunks per A row
    constexpr int kRowB = kBN / kPer;  // chunks per B row
#pragma unroll
    for (int it = 0; it < kBM * kRowA / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kRowA, c = (i % kRowA) * kPer;
      const bool in = row0 + r < m && k0 + c < k;
      cp_async16(as + r * L::kLdA + c,
                 in ? A + (size_t)(row0 + r) * k + k0 + c : A, in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kBK * kRowB / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kRowB, c = (i % kRowB) * kPer;
      const bool in = k0 + r < k && col0 + c < n;
      cp_async16(bs + r * L::kLdB + c,
                 in ? B + (size_t)(k0 + r) * n + col0 + c : B, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const bool in = row0 + r < m && k0 + c < k;
      as[r * L::kLdA + c] =
          in ? A[(size_t)(row0 + r) * k + k0 + c] : from_float<TI>(0.f);
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const bool in = k0 + r < k && col0 + c < n;
      bs[r * L::kLdB + c] =
          in ? B[(size_t)(k0 + r) * n + col0 + c] : from_float<TI>(0.f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += the warp's 64x32 share of one stage, float32 as split TF32; the
// k of each MMA is permuted (tf32x3.cuh), so A's (a0, a2) is one float2
__device__ __forceinline__ void mma_stage(float (&acc)[kMT][kNT][4],
                                          const float* as, const float* bs,
                                          int wm, int wn, int g, int t) {
  constexpr int lda = Layout<float>::kLdA, ldb = Layout<float>::kLdB;
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    uint32_t ab[kMT][4], a_sm[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const float* a = as + (wm + 16 * i + g) * lda + 8 * ks + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(a);
      const float2 hi = *reinterpret_cast<const float2*>(a + 8 * lda);
      split_tf32(lo.x, ab[i][0], a_sm[i][0]);
      split_tf32(hi.x, ab[i][1], a_sm[i][1]);
      split_tf32(lo.y, ab[i][2], a_sm[i][2]);
      split_tf32(hi.y, ab[i][3], a_sm[i][3]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* b = bs + (8 * ks + 2 * t) * ldb + wn + 8 * j + g;
      uint32_t bb[2], b_sm[2];
      split_tf32(b[0], bb[0], b_sm[0]);
      split_tf32(b[ldb], bb[1], b_sm[1]);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        mma_tf32x3(acc[i][j], ab[i], a_sm[i], bb, b_sm);
    }
  }
}

// acc += the warp's 64x32 share of one stage, bfloat16 m16n8k16
__device__ __forceinline__ void mma_stage(float (&acc)[kMT][kNT][4],
                                          const __nv_bfloat16* as,
                                          const __nv_bfloat16* bs, int wm,
                                          int wn, int g, int t) {
  constexpr int lda = Layout<__nv_bfloat16>::kLdA;
  constexpr int ldb = Layout<__nv_bfloat16>::kLdB;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    uint32_t af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const __nv_bfloat16* a = as + (wm + 16 * i + g) * lda + 16 * ks + 2 * t;
      af[i][0] = ld32(a);
      af[i][1] = ld32(a + 8 * lda);
      af[i][2] = ld32(a + 8);
      af[i][3] = ld32(a + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const __nv_bfloat16* b = bs + (16 * ks + 2 * t) * ldb + wn + 8 * j + g;
      const uint32_t bf[2] = {pack_bf16(b[0], b[ldb]),
                              pack_bf16(b[8 * ldb], b[9 * ldb])};
#pragma unroll
      for (int i = 0; i < kMT; ++i) mma_bf16(acc[i][j], af[i], bf);
    }
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
              TO* __restrict__ C, int m, int n, int k, int transpose,
              int vec, const EpiProgram prog) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TI* ring = reinterpret_cast<TI*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / kWarpsN) * kWM;
  const int wn = (warp % kWarpsN) * kWN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  constexpr int kStage = stage_elems<TI>();
  constexpr int kBOff = kBM * Layout<TI>::kLdA;  // B's offset in a stage
  const int n_kt = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt)
      load_stage(ring + s * kStage, ring + s * kStage + kBOff, A, B, m, n, k,
                 row0, col0, s, vec, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt is in; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < n_kt) {
      TI* st = ring + (next % kStages) * kStage;
      load_stage(st, st + kBOff, A, B, m, n, k, row0, col0, next, vec, tid);
    }
    cp_async_commit();
    // the slice's products into a fresh sum, added to acc in float32 with
    // round-to-nearest: the tensor cores truncate each MMA's sum, and over
    // a long k loop into one accumulator of constant sign that bias adds
    // up (4096^3: 6e-3 against 1e-5 * sqrt(k) = 6.4e-4)
    float part[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    const TI* st = ring + (kt % kStages) * kStage;
    mma_stage(part, st, st + kBOff, wm, wn, g, t);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the output tile

  // the accumulator tile in the stored frame: [kBM][kLdC], or [kBN][kLdCT]
  float* cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + g + 8 * h, c = wn + 8 * j + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (transpose) {
          cs[c * kLdCT + r] = v0;
          cs[(c + 1) * kLdCT + r] = v1;
        } else {
          *reinterpret_cast<float2*>(cs + r * kLdC + c) = make_float2(v0, v1);
        }
      }
  __syncthreads();

  // frame rows fr0.., columns fc0.. of the stored [rows, cols] output
  const int rows = transpose ? n : m, cols = transpose ? m : n;
  const int fr0 = transpose ? col0 : row0, fc0 = transpose ? row0 : col0;
  const int ld = transpose ? kLdCT : kLdC;
  constexpr int kTileCols = kBN;  // == kBM: the tile is square
#pragma unroll 1
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int lr = e / kTileCols, lc = e % kTileCols;
    const int fi = fr0 + lr, fj = fc0 + lc;
    if (fi >= rows || fj >= cols) continue;
    float v = cs[lr * ld + lc];
    if (prog.n_code > 0) v = run_epilogue<TO>(prog, v, fi, fj, cols);
    C[(size_t)fi * cols + fj] = from_float<TO>(v);
  }
}

// Reject a program whose indices leave the kernel's tables.
bool program_ok(const EpiProgram& p) {
  if (p.n_code < 0 || p.n_code > kMaxCode || p.n_extra < 0 ||
      p.n_extra > kMaxExtra)
    return false;
  for (int e = 0; e < p.n_extra; ++e)
    if (p.extra_pattern[e] < 0 || p.extra_pattern[e] > 2 || !p.extra[e])
      return false;
  for (int pc = 0; pc < p.n_code; ++pc) {
    const int op = p.code[pc][0] & 255, dst = p.code[pc][0] >> 8;
    if (op >= kNumOps || dst < 0 || dst >= kMaxRegs) return false;
    const int a = p.code[pc][1], b = p.code[pc][2], c = p.code[pc][3];
    if (op == kLoadConst) {
      if (a < 0 || a >= kMaxConsts) return false;
    } else if (op == kLoadExtra) {
      if (a < 0 || a >= p.n_extra) return false;
    } else if (a < 0 || a >= kMaxRegs || b < 0 || b >= kMaxRegs || c < 0 ||
               c >= kMaxRegs) {
      return false;
    }
  }
  return true;
}


bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename TI, typename TO>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int transpose, const EpiProgram& prog, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t bytes = smem_bytes<TI>();
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int vec = ((size_t)k * sizeof(TI)) % 16 == 0 &&
                  ((size_t)n * sizeof(TI)) % 16 == 0 && aligned16(a) &&
                  aligned16(b);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<TI, TO><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(b),
      static_cast<TO*>(c), m, n, k, transpose, vec, prog);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype (A, B) and out_dtype (C, extras): 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = success).  The Python wrapper checks shapes,
// devices and contiguity; sizes and the program are checked here too.
extern "C" int egt_matmul(const void* a, const void* b, void* c, int m,
                          int n, int k, int transpose, int in_dtype,
                          int out_dtype, EpiProgram prog, void* stream) {
  if (m < 0 || n < 0 || k < 0 || (m + kBM - 1) / kBM > 65535 ||
      !program_ok(prog))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = in_dtype * 2 + out_dtype;
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (t == 0) return launch<float, float>(a, b, c, m, n, k, transpose, prog, s);
  if (t == 1)
    return launch<float, __nv_bfloat16>(a, b, c, m, n, k, transpose, prog, s);
  if (t == 2)
    return launch<__nv_bfloat16, float>(a, b, c, m, n, k, transpose, prog, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, transpose,
                                              prog, s);
}

// egt_matmul's arguments packed for one ctypes pointer (ops/matmul.py packs
// them with struct.Struct("<3Q6i")), and the epilogue program by pointer
// instead of a copy by value: about 2 us of host time a launch.
struct MatmulArgs {
  const void* a;
  const void* b;
  void* c;
  int m, n, k, transpose, in_dtype, out_dtype;
};
static_assert(sizeof(MatmulArgs) == 48, "MatmulArgs layout");

extern "C" int egt_matmul_packed(const MatmulArgs* x, const EpiProgram* prog,
                                 void* stream) {
  return egt_matmul(x->a, x->b, x->c, x->m, x->n, x->k, x->transpose,
                    x->in_dtype, x->out_dtype, *prog, stream);
}
