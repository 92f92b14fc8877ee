// FP64 tensor-core products (sm_90a), shared by csrc/pbf_tiles.cu (the
// centred r2 of the mxu tiles) and csrc/micro_dense.cu (the r2 and the
// reduce-dot of dense_mxu / dense_wmxu): one definition, inlined into both.
//
// mma.sync.aligned.m8n8k4 with f64 operands: D (8 x 8) = A (8 x 4) . B (4 x 8)
// (+ C).  Lane (g, t) of the warp, g = lane / 4, t = lane % 4, holds
// a = A[g][t], b = B[t][g] and (d0, d1) = D[g][2t], D[g][2t + 1].  Products
// of fp32 values are exact in fp64 and a K = 4 sum rounds at 2^-53.
//
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>

namespace {

// d = a . b for one 8 x 8 x 4 block.
__device__ __forceinline__ void dmma_m8n8k4(double a, double b, double& d0,
                                            double& d1) {
  const double zero = 0.0;
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%4, %5};\n"
      : "=d"(d0), "=d"(d1)
      : "d"(a), "d"(b), "d"(zero), "d"(zero));
}

// (d0, d1) += a . b for one 8 x 8 x 4 block.
__device__ __forceinline__ void dmma_m8n8k4_acc(double a, double b, double& d0,
                                                double& d1) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

}  // namespace
