// Kernel B1 (matmul.cuh) at the 128x128 blocks of the lattice, one
// translation unit per (BM, BN) so that the blocks build in parallel.

#include "matmul.cuh"

EGT_MATMUL_INSTANTIATE(128, 128, 32)
EGT_MATMUL_INSTANTIATE(128, 128, 64)
