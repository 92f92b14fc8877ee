// Independent fp32 carries under one op (sm_90a), shared by csrc/micro_chunk.cu
// (chunk_fma, the fma ceiling of tools/micro_chunk.py), csrc/micro_loop.cu
// (loop_fma, the tiny body and the 2-32 and wide streams, and loop_op, the
// op bodies of tools/micro_loop.py) and csrc/micro_vpu.cu (vpu_streams, the
// op streams of tools/micro_vpu.py): one definition, inlined into each.
//
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kFmaScale = 1.000001f;  // the tools' c * 1.000001 (+ x)

// The op a trip applies to a carry c of input x.  0-4 are micro_loop's e)
// bodies, 5-9 micro_vpu's streams beside its mul (2).  The values name the
// kernels' instantiations, so they do not change.
enum CarryOp {
  kRsqrtAdd = 0,   // rsqrt(c + x)
  kWhereAdd = 1,   // where(c > x, c, x) + 1e-7
  kMul = 2,        // c * 1.000001
  kAdd = 3,        // c + x
  kSubAbsCmp = 4,  // where(|c - x| <= 1, c + x, x)
  kFma = 5,        // c * 1.000001 + x, fused as XLA fuses it
  kCmpWhere = 6,   // where(c > x, c * 1.000001, x)
  kRsqrt = 7,      // rsqrt(c): MUFU.RSQ
  kSqrtAdd = 8,    // sqrt(c) + x, IEEE
  kDiv = 9,        // x / c, IEEE
};

template <int OP>
__device__ __forceinline__ float op_round(float c, float x) {
  if constexpr (OP == kRsqrtAdd) return rsqrtf(c + x);
  if constexpr (OP == kWhereAdd) return (c > x ? c : x) + 1e-7f;
  if constexpr (OP == kMul) return c * kFmaScale;
  if constexpr (OP == kAdd) return c + x;
  if constexpr (OP == kSubAbsCmp) return fabsf(c - x) <= 1.0f ? c + x : x;
  if constexpr (OP == kFma) return fmaf(c, kFmaScale, x);
  if constexpr (OP == kCmpWhere) return c > x ? c * kFmaScale : x;
  if constexpr (OP == kRsqrt) return rsqrtf(c);
  // the _rn intrinsics: IEEE whatever the flags, and never contracted
  if constexpr (OP == kSqrtAdd) return __fsqrt_rn(c) + x;
  return __fdiv_rn(x, c);
}

// K carries from x + s, each updated c = op(c, x) once a trip for `niter`
// trips, then summed in order (acc = c0; acc += c_s).  The trip loop is not
// unrolled, so a trip holds K ops and the loop's own instructions, as the
// tools' fori holds K (8, 128) ops a trip.
template <int OP, int K>
__device__ __forceinline__ float op_carries(float x, int niter) {
  float c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) c[s] = x + (float)s;
#pragma unroll 1
  for (int i = 0; i < niter; ++i) {
#pragma unroll
    for (int s = 0; s < K; ++s) c[s] = op_round<OP>(c[s], x);
  }
  float acc = c[0];
#pragma unroll
  for (int s = 1; s < K; ++s) acc += c[s];
  return acc;
}

template <int K>
__device__ __forceinline__ float fma_carries(float x, int niter) {
  return op_carries<kFma, K>(x, niter);
}

}  // namespace
