// Neighbour phases of one PBF frame on cell-sorted particles (sm_90a).
//
// Replaces the three Pallas TPU kernels of pbf_sph_tpu/ops/pallas_pbf.py:
//   pbf_lambda   <- make_lambda_call  (density-constraint multiplier)
//   pbf_delta    <- make_delta_call   (position correction)
//   pbf_diffuse  <- make_diffuse_call (neighbour colour sums and count)
// Each computes what its Pallas kernel computes on the same cell-sorted input;
// the mask, mix and clamp that the Pallas wrappers apply in XLA stay in the
// Python wrappers (pbf_sph_tpu_torch/ops/phases.py).
//
// Design: one thread per sorted row.  Particles are sorted by linear cell id
// (z fastest), so the 27-cell stencil of a row in cell `lin` is nine
// contiguous (dx, dy) ranges of the sorted array,
//   [table[clip(lin + off - 1)], table[clip(lin + off + 2)]),
//   off = dx*ny*nz + dy*nz, clip to [0, ncells].
// For one row the nine ranges are disjoint (nz >= 3), so nothing is visited
// twice and no dedup is needed.  A range reaching across a z- or y-wrap
// lands in cells more than h away: lambda and delta mask by geometry alone
// (max(h^2 - r^2, 0) and max(h - r, 0) are exactly 0 there), as the Pallas
// kernels do; diffuse has no distance cutoff and keeps the integer
// |dcell| <= 1 test per axis.  Non-member rows (key >= ncells) skip the walk
// and write what a Pallas row with memberf = 0 gives.
//
// What bounds it: reads of candidate positions, 16 bytes (a packed float4)
// for ~25 flops a pair, over the ~27 cells around each row.  Served from
// device memory every time, they would cap the kernel near 3.35 TB/s / 16 B
// = ~200 G pairs/s.  The design keeps them out of device memory: neighbouring
// threads of a warp are neighbouring rows of one or two cells and walk almost
// the same ranges, so a warp's candidate reads fall on the same lines, and
// the rows of neighbouring cells find those lines again in L1/L2.  Device
// memory then sees about one read of the candidate array per phase, and L1/L2
// bandwidth and instruction issue bound the kernel instead.  Shared-memory
// staging, TMA and wgmma are left for later work.
//
// The λ and Δp pair terms and λ's row are in csrc/pbf_pair.cuh, which the
// rate anchor (csrc/anchor_rate.cu) includes too.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pbf_pair.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void lambda_kernel(const float4* __restrict__ cand,  // x, y, z, mass
                              const int* __restrict__ key,
                              const int* __restrict__ table, int n, int ny,
                              int nz, int ncells, float h, float hh, float eps2,
                              float p6f, float c_grad, float rho_recip,
                              float cfm, float* __restrict__ lam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lin = key[i];
  if (lin >= ncells) {
    lam[i] = lambda_nonmember(rho_recip, cfm);
    return;
  }
  lam[i] = lambda_member(cand, table, i, lin, ny, nz, ncells, h, hh, eps2, p6f, c_grad,
                         rho_recip, cfm);
}

__global__ void delta_kernel(const float4* __restrict__ cand,  // x, y, z, lambda
                             const int* __restrict__ key,
                             const int* __restrict__ table, int n, int ny,
                             int nz, int ncells, float h, float hh, float eps2,
                             float skf, float xqf, float corr_k,
                             float rho_recip, float* __restrict__ dp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lin = key[i];
  if (lin >= ncells) {
    dp[i] = 0.f;
    dp[n + i] = 0.f;
    dp[2 * n + i] = 0.f;
    return;
  }
  const float4 a = cand[i];
  float sx = 0.f, sy = 0.f, sz = 0.f;
  const int nynz = ny * nz;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      const int base = lin + ox * nynz + oy * nz;
      const int lo = table[clip_cell(base - 1, ncells)];
      const int hi = table[clip_cell(base + 2, ncells)];
      for (int j = lo; j < hi; ++j) {
        delta_pair(a.x, a.y, a.z, a.w, cand[j], h, hh, eps2, skf, xqf, corr_k,
                   rho_recip, sx, sy, sz);
      }
    }
  }
  dp[i] = sx;
  dp[n + i] = sy;
  dp[2 * n + i] = sz;
}

__global__ void diffuse_kernel(const float4* __restrict__ colour,  // r, g, b, a
                               const float* __restrict__ nonobs,
                               const int* __restrict__ key,
                               const int* __restrict__ table, int n, int ny,
                               int nz, int ncells, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lin = key[i];
  float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f, cnt = 0.f;
  if (lin < ncells) {
    const int nynz = ny * nz;
    const int cx = lin / nynz;
    const int cy = (lin - cx * nynz) / nz;
    const int cz = lin - cx * nynz - cy * nz;
    for (int ox = -1; ox <= 1; ++ox) {
      for (int oy = -1; oy <= 1; ++oy) {
        const int base = lin + ox * nynz + oy * nz;
        const int lo = table[clip_cell(base - 1, ncells)];
        const int hi = table[clip_cell(base + 2, ncells)];
        for (int j = lo; j < hi; ++j) {
          // candidates in [lo, hi) are members, so their keys are cell ids
          const int lj = key[j];
          const int bx = lj / nynz;
          const int by = (lj - bx * nynz) / nz;
          const int bz = lj - bx * nynz - by * nz;
          const bool adj = abs(bx - cx) <= 1 && abs(by - cy) <= 1 &&
                           abs(bz - cz) <= 1;
          if (adj && nonobs[j] > 0.5f) {
            const float4 c = colour[j];
            sr += c.x;
            sg += c.y;
            sb += c.z;
            sa += c.w;
            cnt += 1.f;
          }
        }
      }
    }
  }
  out[i] = sr;
  out[n + i] = sg;
  out[2 * n + i] = sb;
  out[3 * n + i] = sa;
  out[4 * n + i] = cnt;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int pbf_lambda(const void* cand, const void* key, const void* table, int n,
               int ny, int nz, int ncells, float h, float hh, float eps2,
               float p6f, float c_grad, float rho_recip, float cfm, void* lam,
               void* stream) {
  if (n > 0) {
    lambda_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)cand, (const int*)key, (const int*)table, n, ny, nz,
        ncells, h, hh, eps2, p6f, c_grad, rho_recip, cfm, (float*)lam);
  }
  return (int)cudaGetLastError();
}

int pbf_delta(const void* cand, const void* key, const void* table, int n,
              int ny, int nz, int ncells, float h, float hh, float eps2,
              float skf, float xqf, float corr_k, float rho_recip, void* dp,
              void* stream) {
  if (n > 0) {
    delta_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)cand, (const int*)key, (const int*)table, n, ny, nz,
        ncells, h, hh, eps2, skf, xqf, corr_k, rho_recip, (float*)dp);
  }
  return (int)cudaGetLastError();
}

int pbf_diffuse(const void* colour, const void* nonobs, const void* key,
                const void* table, int n, int ny, int nz, int ncells, void* out,
                void* stream) {
  if (n > 0) {
    diffuse_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)colour, (const float*)nonobs, (const int*)key,
        (const int*)table, n, ny, nz, ncells, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
