// Copies as the grid (sm_90a), shared by the micro-benchmarks that repeat
// one tile's work over CTAs to fill the card (csrc/anchor_rate.cu,
// csrc/micro_chunk.cu, csrc/micro_loop.cu, csrc/micro_roll.cu and
// csrc/micro_vpu.cu; csrc/mc_field.cu's zero fill and csrc/micro_dense.cu's
// dense_wmxu_blocked take fill_ctas): the CTA count that fills every SM at a
// kernel's occupancy, and the element a
// CTA of a repeated tile computes.  One definition, inlined into each.
//
// Nothing here is a kernel.

#pragma once

#include <cuda_runtime.h>

namespace {

// CTAs of `threads` threads with `smem` bytes of dynamic shared memory that
// fill every SM at the kernel's occupancy, 0 if a query fails.
template <typename K>
int fill_ctas(K kernel, int threads, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess) {
    return 0;
  }
  return sms * per_sm;
}

// The element thread t of CTA b computes where CTAs of THREADS threads repeat
// a tile of `copy_blocks` CTAs: (b mod copy_blocks) THREADS + t, so every CTA
// does a copy's work and none is dead.
template <int THREADS>
__device__ __forceinline__ int copy_element(int copy_blocks) {
  return (blockIdx.x % copy_blocks) * THREADS + threadIdx.x;
}

}  // namespace
