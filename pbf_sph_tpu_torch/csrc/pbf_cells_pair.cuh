// The λ and Δp pair terms of csrc/pbf_cells.cu (sm_90a), and the ends of its
// rows with the wrappers' mask and clamp.  The pair terms are the expressions of
// csrc/pbf_pair.cuh, term for term and in the same order, with rsqrt taken as
// rsqrt.approx.ftz.f32.  rsqrtf without -ftz adds a denormal guard (FSETP,
// FMUL, FSEL and a predicated FMUL around MUFU.RSQ) that r2c >= eps^2 = 1e-16
// never takes; for a normal argument both give the same bits.  The .ftz is on
// this one instruction, not the file: every other operation keeps denormals.
//
// pbf_pair.cuh stays as it is: the rate anchor and the micro-benchmarks
// inline it and measure the per-row kernels' code.  csrc/cells_staged.cu,
// the staged walk of tools/cells_staged.py, inlines this file.
//
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One λ pair: row (ax, ay, az) against candidate b; adds the density term to
// p6s and the gradient term to (gx, gy, gz).
__device__ __forceinline__ void cells_lambda_pair(float ax, float ay, float az, float4 b,
                                                  float h, float hh, float eps2, float& p6s,
                                                  float& gx, float& gy, float& gz) {
  const float dx = ax - b.x;
  const float dy = ay - b.y;
  const float dz = az - b.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d2p = fmaxf(hh - r2, 0.f);
  p6s += d2p * d2p * d2p;
  const float r2c = fmaxf(r2, eps2);
  const float u = rsqrt_ftz(r2c);
  const float tt = fmaxf(h - r2c * u, 0.f);
  const float sg = tt * tt * u;
  gx += dx * sg;
  gy += dy * sg;
  gz += dz * sg;
}

// One Δp pair: row (ax, ay, az) with multiplier alam against candidate b
// (x, y, z, λ); adds the position correction to (sx, sy, sz).
__device__ __forceinline__ void cells_delta_pair(float ax, float ay, float az, float alam,
                                                 float4 b, float h, float hh, float eps2,
                                                 float skf, float xqf, float corr_k,
                                                 float rho_recip, float& sx, float& sy,
                                                 float& sz) {
  const float dx = ax - b.x;
  const float dy = ay - b.y;
  const float dz = az - b.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d2p = fmaxf(hh - r2, 0.f);
  const float xq = d2p * d2p * d2p * xqf;
  const float x2 = xq * xq;
  const float corr = corr_k * x2 * x2;
  const float factor = (alam + b.w + corr) * rho_recip;
  const float r2c = fmaxf(r2, eps2);
  const float u = rsqrt_ftz(r2c);
  const float tt = fmaxf(h - r2c * u, 0.f);
  const float sg = (skf * (tt * tt) * u) * factor;
  sx += dx * sg;
  sy += dy * sg;
  sz += dz * sg;
}

// The end of a λ row from its sums: the constraint as csrc/pbf_pair.cuh's
// lambda_member ends it (lambda_nonmember for a row of no cell), 0 where the
// row is not fluid and alive.  ci's multiply-add is fused explicitly, as nvcc
// fuses it there (here it would share the multiply with the non-member
// branch and round twice).
__device__ __forceinline__ float cells_lambda_end(bool member, float mass, float p6s,
                                                  float gx, float gy, float gz, float p6f,
                                                  float c_grad, float rho_recip, float cfm,
                                                  bool fluid) {
  float lam;
  if (member) {
    const float rho = mass * (p6s * p6f);
    const float norm2 =
        (gx * c_grad) * (gx * c_grad) + (gy * c_grad) * (gy * c_grad) +
        (gz * c_grad) * (gz * c_grad);
    const float ci = __fmaf_rn(rho, rho_recip, -1.0f);
    lam = -ci / (norm2 + cfm);
  } else {
    lam = -(0.0f * rho_recip - 1.0f) / (0.0f + cfm);
  }
  return fluid ? lam : 0.f;
}

// The end of a Δp row: out[0:3] = clamp((p + dp) * scale, lo, hi) / scale in
// clamp_to_bounds' fp32 order where the row is fluid and alive, else p.
__device__ __forceinline__ void cells_delta_end(float4 p, float sx, float sy, float sz,
                                                bool fluid, const float* __restrict__ scale,
                                                const float* __restrict__ lo,
                                                const float* __restrict__ hi, float* out) {
  if (fluid) {
    const float sc = *scale;
    out[0] = fminf(fmaxf((p.x + sx) * sc, lo[0]), hi[0]) / sc;
    out[1] = fminf(fmaxf((p.y + sy) * sc, lo[1]), hi[1]) / sc;
    out[2] = fminf(fmaxf((p.z + sz) * sc, lo[2]), hi[2]) / sc;
  } else {
    out[0] = p.x;
    out[1] = p.y;
    out[2] = p.z;
  }
}

}  // namespace
