// Shared-memory barriers (sm_90a), shared by csrc/micro_dense.cu
// (dense_scr's bulk copies), csrc/micro_roll.cu (vpu_dma's cp.async copies)
// and csrc/micro_vpu.cu (the ring of producer and consumer slots of
// vpu_dot_spread and vpu_dot2_spread): one definition, inlined into each.
//
// One thread inits the barrier for its arrivals and, after a __syncthreads,
// each arrives: with the bytes the copies complete on it (bulk copies), when
// its own copies land (cp.async), or after its own stores (mbar_arrive); a
// waiter then waits for the phase's parity.  A phase that never completes
// traps (a launch error) after ~1M tries rather than hanging the card.
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

// A plain arrival, release at CTA scope: what the thread stored to shared
// memory before it is seen by a thread whose wait on the phase succeeds.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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
