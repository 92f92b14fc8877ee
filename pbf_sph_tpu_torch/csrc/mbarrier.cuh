// Shared-memory barriers for the asynchronous copies (sm_90a), shared by
// csrc/micro_dense.cu (dense_scr's bulk copies) and csrc/micro_roll.cu
// (vpu_dma's cp.async copies): one definition, inlined into both.
//
// One thread inits the barrier for its arrivals and, after a __syncthreads,
// each arrives: with the bytes the copies complete on it (bulk copies), or
// when its own copies land (cp.async); every thread then waits for phase 0.
// A copy that never lands traps (a launch error) after ~1M tries rather
// than hanging the card.
//
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  for (int i = 0; !mbar_try_wait(bar, parity); ++i) {
    if (i > (1 << 20)) __trap();
  }
}

}  // namespace
