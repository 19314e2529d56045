// Scheduled matmul with a fused elementwise epilogue, for Hopper (sm_90a),
// FP32 FMA on CUDA cores.
//
// Replaces the Pallas TPU kernel exprgrad_tpu/ops/matmul.py::_matmul_impl
// (kernel B1: what every schedule(tile=...) contraction runs).  Computes
//
//   acc = A[m, k] . B[k, n]            float32 accumulation
//   C   = epilogue(acc) stored [m, n], or its transpose [n, m]
//
// A and B are float32 or bfloat16 (a bfloat16 input is widened on load);
// C and the epilogue's extra operands are float32 or bfloat16.  The
// epilogue is data, not code: a small register program (EpiProgram) that
// the TPU kernel ran as a traced Python closure.  It is interpreted per
// output element after the k loop, on the accumulator in registers, and
// reads extra operands in the stored frame [rows, cols] (rows = n and
// cols = m when the store is transposed): pattern 0 "row" reads [1, cols]
// at the column, 1 "col" reads [rows, 1] at the row, 2 "full" reads
// [rows, cols].  Register 0 holds the running value and is the result.
//
// Layout of the work: one 256-thread block per 64x64 output tile; the TPU
// kernel's sequential k grid axis becomes a loop over 16-deep k slices
// staged in shared memory (A transposed, so a thread reads its four rows
// as one float4); each thread keeps a 4x4 register tile of the product.
// Ragged edges are guarded on load (zero fill) and on store, so no
// operand is padded in device memory.
//
// What bounds it: at 4096^3 float32 the call does 137 GFLOP and moves
// 201 MB; the card's float32 FMA rate (67 TFLOP/s, no tensor cores under
// precision="highest") bounds it at 2.05 ms, and memory at 0.06 ms.
// This simple kernel reaches a fraction of that rate: two block barriers
// and a shared-memory round trip per 16-deep slice, no copy/compute
// overlap.  wgmma and TMA (TF32 or bf16 tensor cores where the precision
// allows it), a Hopper-sized block and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // k slice per shared-memory stage
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kPadA = 4;  // As row padding: 2-way store conflicts, float4 aligned

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

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
              TO* __restrict__ C, int m, int n, int k, int transpose,
              const EpiProgram prog) {
  __shared__ __align__(16) float As[kBK][kBM + kPadA];  // A^T slice
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // column group
  const int ty = tid / (kBN / kTN);  // row group
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A slice [kBM, kBK]: 16 consecutive k of one row per 16 threads
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < m && gc < k) ? to_float(A[(size_t)gr * k + gc]) : 0.f;
    }
    // B slice [kBK, kBN]: one row of 64 consecutive columns per 64 threads
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < k && gc < n) ? to_float(B[(size_t)gr * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int cols = transpose ? m : n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c >= n) continue;
      const int fi = transpose ? c : r;  // position in the stored frame
      const int fj = transpose ? r : c;
      float v = acc[i][j];
      if (prog.n_code > 0) v = run_epilogue<TO>(prog, v, fi, fj, cols);
      C[(size_t)fi * cols + fj] = from_float<TO>(v);
    }
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

template <typename TI, typename TO>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           int transpose, const EpiProgram& prog, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  matmul_kernel<TI, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(b),
      static_cast<TO*>(c), m, n, k, transpose, prog);
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
