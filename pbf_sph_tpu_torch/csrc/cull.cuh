// The pieces the cull kernels share (sm_90a): csrc/pbf_phases2.cu's
// lambda2/delta2 cull kernels and csrc/pbf_tiles.cu's tile cull kernels.
//
// * 16-byte cp.async into shared memory, its commit and its wait;
// * the keep tests' squared distance `test_r2`, rounded in PTX;
// * the AABB gap and the box test against the keep threshold hh_keep.
//
// Why a pair the keep tests drop has exact-zero terms is argued in each
// kernel's header comment; both rest on `test_r2` never being contracted
// and on its monotonicity in |dx|, |dy|, |dz|.
//
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The keep tests' squared distance (dx^2 + dy^2) + dz^2, each operation
// rounded to nearest in PTX: the compiler neither contracts it nor shares a
// product with the pair chain.  Monotone in |dx|, |dy|, |dz|.
__device__ __forceinline__ float test_r2(float dx, float dy, float dz) {
  float r;
  asm("{\n\t.reg .f32 x2, y2, z2;\n\t"
      "mul.rn.f32 x2, %1, %1;\n\t"
      "mul.rn.f32 y2, %2, %2;\n\t"
      "mul.rn.f32 z2, %3, %3;\n\t"
      "add.rn.f32 x2, x2, y2;\n\t"
      "add.rn.f32 %0, x2, z2;\n\t}"
      : "=f"(r)
      : "f"(dx), "f"(dy), "f"(dz));
  return r;
}

// An axis-aligned box; empty as (+inf, -inf), which every box test drops.
struct Box {
  float lx, ly, lz, hx, hy, hz;
};

// The gap between [glo, ghi] and [rlo, rhi], 0 where they overlap.  Each
// difference is rounded once, so the gap is at most the rounded |a - b| of
// any two points of the intervals.
__device__ __forceinline__ float gap(float glo, float ghi, float rlo, float rhi) {
  return fmaxf(fmaxf(glo - rhi, rlo - ghi), 0.f);
}

__device__ __forceinline__ bool box_near(const Box& g, const Box& r, float hh_keep) {
  return test_r2(gap(g.lx, g.hx, r.lx, r.hx), gap(g.ly, g.hy, r.ly, r.hy),
                 gap(g.lz, g.hz, r.lz, r.hz)) < hh_keep;
}

}  // namespace
