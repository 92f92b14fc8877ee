// Independent fp32 FMA carries (sm_90a), shared by csrc/micro_chunk.cu
// (chunk_fma, the fma ceiling of tools/micro_chunk.py) and csrc/micro_loop.cu
// (loop_fma, the tiny body and the 2-32 and wide streams of
// tools/micro_loop.py): one definition, inlined into both.
//
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kFmaScale = 1.000001f;  // the tools' c * 1.000001 + x

// K carries from x + s, each updated c = fma(c, 1.000001, x) once a trip
// for `niter` trips, then summed in order (acc = c0; acc += c_s).  The trip
// loop is not unrolled, so a trip holds K FFMAs and the loop's own
// instructions, as the tools' fori holds K (8, 128) fmas a trip.
template <int K>
__device__ __forceinline__ float fma_carries(float x, int niter) {
  float c[K];
#pragma unroll
  for (int s = 0; s < K; ++s) c[s] = x + (float)s;
#pragma unroll 1
  for (int i = 0; i < niter; ++i) {
#pragma unroll
    for (int s = 0; s < K; ++s) c[s] = fmaf(c[s], kFmaScale, x);
  }
  float acc = c[0];
#pragma unroll
  for (int s = 1; s < K; ++s) acc += c[s];
  return acc;
}

}  // namespace
