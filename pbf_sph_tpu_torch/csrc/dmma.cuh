// FP64 tensor-core products (sm_90a), shared by csrc/pbf_tiles.cu (the
// centred r2 of the mxu tiles) and csrc/micro_dense.cu (the r2 and the
// reduce-dot of dense_mxu / dense_wmxu / dense_wmxu_blocked): one
// definition, inlined into both.
//
// mma.sync.aligned.m8n8k4 with f64 operands: D (8 x 8) = A (8 x 4) . B (4 x 8)
// (+ C).  Lane (g, t) of the warp, g = lane / 4, t = lane % 4, holds
// a = A[g][t], b = B[t][g] and (d0, d1) = D[g][2t], D[g][2t + 1].  Products
// of fp32 values are exact in fp64 and a K = 4 sum rounds at 2^-53.
//
// mma.sync.aligned.m16n8k4 / m16n8k8 with f64 operands (sm_90): D (16 x 8)
// = A (16 x K) . B (K x 8) + C.  Lane (g, t) holds a_i = A[g + 8 (i & 1)][t
// + 4 (i >> 1)], b_i = B[t + 4i][g] and d_i = D[g + 8 (i >> 1)][2t + (i &
// 1)]: two rows of the 8 x 8 layout above, and K = 8 as two halves of 4.
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

// (d0, d1, d2, d3) += A (16 x 4) . B (4 x 8).
__device__ __forceinline__ void dmma_m16n8k4_acc(double a0, double a1, double b,
                                                 double& d0, double& d1, double& d2,
                                                 double& d3) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// (d0, d1, d2, d3) += A (16 x 8) . B (8 x 8).
__device__ __forceinline__ void dmma_m16n8k8_acc(double a0, double a1, double a2, double a3,
                                                 double b0, double b1, double& d0, double& d1,
                                                 double& d2, double& d3) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

}  // namespace
