// The λ and Δp phases of one PBF frame, redesigned for Hopper (sm_90a).
//
// On the solver's main path these replace the per-row kernels of
// csrc/pbf_phases.cu, which replace the Pallas TPU kernels of
// pbf_sph_tpu/ops/pallas_pbf.py:
//   pbf_lambda_cells <- make_lambda_call (:391) with the wrapper's fluid mask
//                       (:690-697)
//   pbf_delta_cells  <- make_delta_call (:491) with the wrapper's bounds clamp
//                       (:706-713)
// The two run on two persistent (C, 4) packs, in turns: pbf_lambda_cells reads
// A = (x, y, z, mass) and writes B = (x, y, z, λ) with λ already masked,
// where(fluid & alive, λ, 0); pbf_delta_cells reads B and writes into A's xyz
// the bounds-clamped pStar, clamp((p + dp) * scale, min, max) / scale in
// clamp_to_bounds' fp32 order for fluid rows and B's xyz for the others,
// leaving A's mass alone.  So the iterated solve needs no pack, mask or clamp
// outside the kernels.  scale and the bounds are read through device pointers.
// The pair terms (csrc/pbf_cells_pair.cuh) leave out rsqrtf's denormal guard:
// 18 fp32 instructions and one MUFU.RSQ a λ pair against pbf_lambda's 22.
//
// One thread a sorted row, as the per-row kernels, and each row walks its
// nine (dx, dy) ranges [table[lin + off - 1], table[lin + off + 2]) in their
// order, reading the candidates from the pack in device memory, so the sums
// are the per-row kernels' bit for bit.  Rows of one cell sit on adjacent
// lanes and read the same candidate in step, and the rows of neighbouring
// cells read the same lines, so L1 serves nearly every read.  Staging the
// candidates of a run of cells in shared memory instead
// (tools/cells_staged.py) was measured slower on the card (PERF.md): it adds
// the copy, two barriers a piece and the cut into runs, and takes shared
// memory that limits the CTAs resident, while L1 already served the reads it
// replaces.
//
// What bounds them: instruction issue in the pair loop, as for the per-row
// kernels.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pbf_cells_pair.cuh"

namespace {

constexpr int kRows = 128;  // rows of a CTA (one a thread)

// pair(b) for each candidate b of row `lin`'s nine ranges, in order.
template <typename Pair>
__device__ __forceinline__ void walk_direct(const float4* __restrict__ pack,
                                            const int* __restrict__ table, int lin, int ny,
                                            int nz, int ncells, Pair pair) {
  if (lin >= ncells) return;
  const int nynz = ny * nz;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      const int base = lin + ox * nynz + oy * nz;
      const int lo = table[min(max(base - 1, 0), ncells)];
      const int hi = table[min(max(base + 2, 0), ncells)];
      for (int j = lo; j < hi; ++j) pair(pack[j]);
    }
  }
}

__global__ void __launch_bounds__(kRows)
    lambda_cells_kernel(const float4* __restrict__ pack_a,  // x, y, z, mass
                        const int* __restrict__ key, const int* __restrict__ table,
                        const unsigned char* __restrict__ fluid, int n, int ny, int nz,
                        int ncells, float h, float hh, float eps2, float p6f, float c_grad,
                        float rho_recip, float cfm,
                        float4* __restrict__ pack_b) {  // x, y, z, masked λ
  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= n) return;
  const int lin = key[row];
  const float4 a = pack_a[row];
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  walk_direct(pack_a, table, lin, ny, nz, ncells, [&](float4 b) {
    cells_lambda_pair(a.x, a.y, a.z, b, h, hh, eps2, p6s, gx, gy, gz);
  });
  const float lam = cells_lambda_end(lin < ncells, a.w, p6s, gx, gy, gz, p6f, c_grad,
                                     rho_recip, cfm, fluid[row]);
  pack_b[row] = make_float4(a.x, a.y, a.z, lam);
}

__global__ void __launch_bounds__(kRows)
    delta_cells_kernel(const float4* __restrict__ pack_b,  // x, y, z, λ
                       const int* __restrict__ key, const int* __restrict__ table,
                       const unsigned char* __restrict__ fluid,
                       const float* __restrict__ scale, const float* __restrict__ lo_bound,
                       const float* __restrict__ hi_bound, int n, int ny, int nz, int ncells,
                       float h, float hh, float eps2, float skf, float xqf, float corr_k,
                       float rho_recip, float* __restrict__ pack_a) {  // xyz of (C, 4)
  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= n) return;
  const int lin = key[row];
  const float4 a = pack_b[row];
  float sx = 0.f, sy = 0.f, sz = 0.f;
  walk_direct(pack_b, table, lin, ny, nz, ncells, [&](float4 b) {
    cells_delta_pair(a.x, a.y, a.z, a.w, b, h, hh, eps2, skf, xqf, corr_k, rho_recip, sx,
                     sy, sz);
  });
  cells_delta_end(a, sx, sy, sz, fluid[row], scale, lo_bound, hi_bound, pack_a + 4 * row);
}

inline int ctas_for(int n) { return (n + kRows - 1) / kRows; }

}  // namespace

extern "C" {

int pbf_lambda_cells(const void* pack_a, const void* key, const void* table, const void* fluid,
                     int n, int ny, int nz, int ncells, float h, float hh, float eps2,
                     float p6f, float c_grad, float rho_recip, float cfm, void* pack_b,
                     void* stream) {
  if (n > 0) {
    lambda_cells_kernel<<<ctas_for(n), kRows, 0, (cudaStream_t)stream>>>(
        (const float4*)pack_a, (const int*)key, (const int*)table, (const unsigned char*)fluid,
        n, ny, nz, ncells, h, hh, eps2, p6f, c_grad, rho_recip, cfm, (float4*)pack_b);
  }
  return (int)cudaGetLastError();
}

int pbf_delta_cells(const void* pack_b, const void* key, const void* table, const void* fluid,
                    const void* scale, const void* lo_bound, const void* hi_bound, int n,
                    int ny, int nz, int ncells, float h, float hh, float eps2, float skf,
                    float xqf, float corr_k, float rho_recip, void* pack_a, void* stream) {
  if (n > 0) {
    delta_cells_kernel<<<ctas_for(n), kRows, 0, (cudaStream_t)stream>>>(
        (const float4*)pack_b, (const int*)key, (const int*)table, (const unsigned char*)fluid,
        (const float*)scale, (const float*)lo_bound, (const float*)hi_bound, n, ny, nz, ncells,
        h, hh, eps2, skf, xqf, corr_k, rho_recip, (float*)pack_a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
