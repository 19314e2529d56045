// Entry points of the scheduled matmul kernel B1 (matmul.cuh): check the
// arguments, pick the instantiation of the requested block and launch it.

#include "matmul.cuh"

EGT_MATMUL_BLOCKS(EGT_MATMUL_EXTERN)

namespace {

using egt_b1::kNumOps;
using egt_b1::kLoadConst;
using egt_b1::kLoadExtra;

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

}  // namespace

// in_dtype (A, B) and out_dtype (C, extras): 0 = float32, 1 = bfloat16;
// (bm, bn, bk) one block of EGT_MATMUL_BLOCKS.  Returns a cudaError_t
// (0 = success); an unknown block is cudaErrorInvalidValue.  The Python
// wrapper checks shapes, devices and contiguity; sizes, the block and the
// program are checked here too.
extern "C" int egt_matmul(const void* a, const void* b, void* c, int m,
                          int n, int k, int transpose, int in_dtype,
                          int out_dtype, int bm, int bn, int bk,
                          EpiProgram prog, void* stream) {
  if (m < 0 || n < 0 || k < 0 || bm <= 0 || (m + bm - 1) / bm > 65535 ||
      in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      !program_ok(prog))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGT_MATMUL_DISPATCH(BM, BN, BK)                                  \
  if (bm == BM && bn == BN && bk == BK)                                  \
    return m == 0 || n == 0                                              \
               ? (int)cudaSuccess                                        \
               : egt_b1::launch_block<BM, BN, BK>(                   \
                     a, b, c, m, n, k, transpose, in_dtype, out_dtype,   \
                     prog, s);
  EGT_MATMUL_BLOCKS(EGT_MATMUL_DISPATCH)
#undef EGT_MATMUL_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// egt_matmul's arguments packed for one ctypes pointer (ops/matmul.py packs
// them with struct.Struct("<3Q9i4x")), and the epilogue program by pointer
// instead of a copy by value: about 2 us of host time a launch.
struct MatmulArgs {
  const void* a;
  const void* b;
  void* c;
  int m, n, k, transpose, in_dtype, out_dtype, bm, bn, bk;
};
static_assert(sizeof(MatmulArgs) == 64, "MatmulArgs layout");

extern "C" int egt_matmul_packed(const MatmulArgs* x, const EpiProgram* prog,
                                 void* stream) {
  return egt_matmul(x->a, x->b, x->c, x->m, x->n, x->k, x->transpose,
                    x->in_dtype, x->out_dtype, x->bm, x->bn, x->bk, *prog,
                    stream);
}

// Byte offset of MatmulArgs' field i (a = 0 .. bk = 11), and its size for
// i = 12: ops/matmul.py holds its packing to them before the first launch
// (a mismatch would pass garbage, not an error).
extern "C" int egt_matmul_args_offset(int i) {
  static const int offsets[] = {
      offsetof(MatmulArgs, a),         offsetof(MatmulArgs, b),
      offsetof(MatmulArgs, c),         offsetof(MatmulArgs, m),
      offsetof(MatmulArgs, n),         offsetof(MatmulArgs, k),
      offsetof(MatmulArgs, transpose), offsetof(MatmulArgs, in_dtype),
      offsetof(MatmulArgs, out_dtype), offsetof(MatmulArgs, bm),
      offsetof(MatmulArgs, bn),        offsetof(MatmulArgs, bk),
      sizeof(MatmulArgs)};
  return i >= 0 && i < (int)(sizeof(offsets) / sizeof(offsets[0]))
             ? offsets[i]
             : -1;
}
