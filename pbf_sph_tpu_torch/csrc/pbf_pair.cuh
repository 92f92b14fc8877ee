// The λ and Δp pair terms and λ's row (sm_90a), shared by
// csrc/pbf_phases.cu (pbf_lambda, pbf_delta) and csrc/anchor_rate.cu (the
// body and row kernels of the rate anchor), so that the anchor measures the
// phase kernels' own code: one definition, inlined into both.
//
// Candidates are packed float4s: (x, y, z, mass) for λ, (x, y, z, λ) for Δp.
// Nothing here is a kernel; every function is inlined where it is called.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip_cell(int c, int ncells) {
  return min(max(c, 0), ncells);
}

// One λ pair: row (ax, ay, az) against candidate b; adds the density term to
// p6s and the gradient term to (gx, gy, gz).
__device__ __forceinline__ void lambda_pair(float ax, float ay, float az, float4 b,
                                            float h, float hh, float eps2, float& p6s,
                                            float& gx, float& gy, float& gz) {
  const float dx = ax - b.x;
  const float dy = ay - b.y;
  const float dz = az - b.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d2p = fmaxf(hh - r2, 0.f);
  p6s += d2p * d2p * d2p;
  const float r2c = fmaxf(r2, eps2);
  const float u = rsqrtf(r2c);
  const float tt = fmaxf(h - r2c * u, 0.f);
  const float sg = tt * tt * u;
  gx += dx * sg;
  gy += dy * sg;
  gz += dz * sg;
}

// One Δp pair: row (ax, ay, az) with multiplier alam against candidate b;
// adds the position correction to (sx, sy, sz).
__device__ __forceinline__ void delta_pair(float ax, float ay, float az, float alam,
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
  const float u = rsqrtf(r2c);
  const float tt = fmaxf(h - r2c * u, 0.f);
  const float sg = (skf * (tt * tt) * u) * factor;
  sx += dx * sg;
  sy += dy * sg;
  sz += dz * sg;
}

// λ of a row that is no member (key >= ncells): what a Pallas row with
// memberf = 0 gives, rho = 0 and |grad|^2 = 0, so lambda = 1 / CFM.
__device__ __forceinline__ float lambda_nonmember(float rho_recip, float cfm) {
  return -(0.0f * rho_recip - 1.0f) / (0.0f + cfm);
}

// λ of member row `row` in cell `lin`: the nine (dx, dy) ranges of its
// cell, each pair by lambda_pair, then the constraint.
__device__ __forceinline__ float lambda_member(const float4* __restrict__ cand,
                                               const int* __restrict__ table, int row,
                                               int lin, int ny, int nz, int ncells,
                                               float h, float hh, float eps2, float p6f,
                                               float c_grad, float rho_recip, float cfm) {
  const float4 a = cand[row];
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  const int nynz = ny * nz;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      const int base = lin + ox * nynz + oy * nz;
      const int lo = table[clip_cell(base - 1, ncells)];
      const int hi = table[clip_cell(base + 2, ncells)];
      for (int j = lo; j < hi; ++j) {
        lambda_pair(a.x, a.y, a.z, cand[j], h, hh, eps2, p6s, gx, gy, gz);
      }
    }
  }
  const float rho = a.w * (p6s * p6f);
  const float norm2 =
      (gx * c_grad) * (gx * c_grad) + (gy * c_grad) * (gy * c_grad) +
      (gz * c_grad) * (gz * c_grad);
  const float ci = rho * rho_recip - 1.0f;
  return -ci / (norm2 + cfm);
}

}  // namespace
