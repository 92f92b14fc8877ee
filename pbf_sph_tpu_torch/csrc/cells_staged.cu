// The staged walk of the main path's λ and Δp (sm_90a): csrc/pbf_cells.cu's
// two kernels with the candidates read from shared memory instead of the pack
// in device memory.  A measurement of tools/cells_staged.py, off the solver's
// path: on the card it ran slower than the direct walk of pbf_cells.cu
// (PERF.md), which L1 already serves.
//
// One thread a sorted row, the same pair terms and row ends
// (csrc/pbf_cells_pair.cuh), and each row walks its own nine (dx, dy) ranges
// in pbf_cells.cu's order, so the sums are its bit for bit.  A CTA of kRows
// consecutive rows cuts its member rows into at most kSub runs where the cell
// id jumps by a column (nz) or more; for each (dx, dy) the candidates of a
// run whose cells are c0..c1 are one contiguous segment [table[c0 + off - 1],
// table[c1 + off + 2]).  The CTA stages the runs' segments laid end to end
// (the union) by 16-byte cp.async (no TMA tensor map: those faulted on the
// card's machine), kStage candidates at a time, piece by piece when the
// union is larger, and each row walks its own sub-ranges of the staged copy,
// clipped to the piece (never the union).  tools/cells_staged.py's plan_runs
// is the plain version of the cut.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "pbf_cells_pair.cuh"

// The CTA rows and the stage: tools/cells_staged.py ROWS and STAGE.
// tools/bench_cells.py --sweep builds this file with others to measure them.
#ifndef CELLS_STAGED_ROWS
#define CELLS_STAGED_ROWS 128
#endif
#ifndef CELLS_STAGED_STAGE
#define CELLS_STAGED_STAGE 2048
#endif

namespace {

constexpr int kRows = CELLS_STAGED_ROWS;    // rows of a CTA (one a thread)
constexpr int kStage = CELLS_STAGED_STAGE;  // candidates staged at once (16 bytes each)
constexpr int kSegs = 9;                    // (dx, dy) segments of a run
constexpr int kSub = 3;                     // runs a CTA (tools/cells_staged.py SUBRUNS)
constexpr int kWarps = kRows / 32;
static_assert(kSub * kSegs <= 32, "one warp scans the segment lengths");

// A CTA's runs: how many hold member rows, the first sorted row of each
// segment and each segment's first slot in the union (run-major, segment
// minor); start[nsub * kSegs] is the union's length.
struct Runs {
  int nsub;
  int seg[kSub * kSegs];
  int start[kSub * kSegs + 1];
  int c0[kSub], c1[kSub];  // each run's first and last cell
  int warp_breaks[kWarps];
};

__device__ __forceinline__ int cells_clip(int c, int ncells) {
  return min(max(c, 0), ncells);
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// The CTA's runs from the keys of its rows: `lin` is the thread's key (ncells
// for no member), `prev` the key of the row before it.  Fills `runs` (the
// segments of each run and their union slots) and returns the thread's run.
__device__ __forceinline__ int cut_runs(Runs& runs, const int* __restrict__ table, int lin,
                                        int prev, int ny, int nz, int ncells) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool member = lin < ncells;
  const unsigned breaks =
      __ballot_sync(0xffffffffu, member && t > 0 && lin - prev >= nz);
  if (lane == 0) runs.warp_breaks[w] = __popc(breaks);
  if (t < kSub) {
    runs.c0[t] = ncells;
    runs.c1[t] = -1;
  }
  if (t == 0) runs.nsub = 0;
  __syncthreads();
  int q = __popc(breaks & (0xffffffffu >> (31 - lane)));
  for (int i = 0; i < w; ++i) q += runs.warp_breaks[i];
  q = min(q, kSub - 1);  // later jumps stay inside the last run
  // each run's smallest and largest cell, a warp's lanes of one run at once
  const unsigned same = __match_any_sync(0xffffffffu, member ? q : -1);
  const int lo_cell = __reduce_min_sync(same, lin);
  const int hi_cell = __reduce_max_sync(same, lin);
  if (member && lane == __ffs(same) - 1) {
    atomicMin(&runs.c0[q], lo_cell);
    atomicMax(&runs.c1[q], hi_cell);
    atomicMax(&runs.nsub, q + 1);
  }
  __syncthreads();
  if (w == 0) {
    // warp 0: segment `lane` (run lane / 9, (dx, dy) lane % 9), its length,
    // and the lengths' scan into union slots
    int lo = 0, len = 0;
    if (lane < runs.nsub * kSegs) {
      const int r = lane / kSegs, s = lane % kSegs;
      const int off = (s / 3 - 1) * ny * nz + (s % 3 - 1) * nz;
      lo = table[cells_clip(runs.c0[r] + off - 1, ncells)];
      len = table[cells_clip(runs.c1[r] + off + 2, ncells)] - lo;
    }
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, len, d);
      if (lane >= d) len += up;
    }
    if (lane < kSub * kSegs) {
      runs.seg[lane] = lo;
      runs.start[lane + 1] = len;
    }
    if (lane == 0) runs.start[0] = 0;
  }
  __syncthreads();
  return q;
}

// Union slots [p0, p1) into stage[0, p1 - p0): each segment's part of the
// piece is a contiguous range of the pack.
__device__ __forceinline__ void stage_piece(float4* stage, const float4* __restrict__ pack,
                                            const Runs& runs, int p0, int p1) {
  __syncthreads();  // every row is done with the previous piece
#pragma unroll 1
  for (int s = 0; s < runs.nsub * kSegs; ++s) {
    const int u1 = min(runs.start[s + 1], p1);
    const int shift = runs.seg[s] - runs.start[s];
    for (int u = max(runs.start[s], p0) + (int)threadIdx.x; u < u1; u += kRows) {
      cp_async16(&stage[u - p0], &pack[u + shift]);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// The CTA's runs, its union staged piece by piece, and pair(b) for each
// staged candidate b of the row's nine ranges, in order.  Every thread of
// the CTA calls it.
template <typename Pair>
__device__ __forceinline__ void walk_staged(const float4* __restrict__ pack,
                                            const int* __restrict__ table, int lin, int prev,
                                            int ny, int nz, int ncells, Pair pair) {
  __shared__ Runs runs;
  __shared__ float4 stage[kStage];
  const int q = cut_runs(runs, table, lin, prev, ny, nz, ncells);
  const int len = runs.start[runs.nsub * kSegs];
  const int nynz = ny * nz;
  for (int p0 = 0; p0 < len; p0 += kStage) {
    const int p1 = min(p0 + kStage, len);
    stage_piece(stage, pack, runs, p0, p1);
    if (lin >= ncells) continue;
    int s = q * kSegs;
    for (int ox = -1; ox <= 1; ++ox) {
      for (int oy = -1; oy <= 1; ++oy, ++s) {
        const int base = lin + ox * nynz + oy * nz;
        const int shift = runs.start[s] - runs.seg[s];
        // the range in union slots, clipped to the piece
        const int lo = max(table[cells_clip(base - 1, ncells)] + shift, p0) - p0;
        const int hi = min(table[cells_clip(base + 2, ncells)] + shift, p1) - p0;
        for (int j = lo; j < hi; ++j) pair(stage[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kRows)
    lambda_staged_kernel(const float4* __restrict__ pack_a,  // x, y, z, mass
                         const int* __restrict__ key, const int* __restrict__ table,
                         const unsigned char* __restrict__ fluid, int n, int ny, int nz,
                         int ncells, float h, float hh, float eps2, float p6f, float c_grad,
                         float rho_recip, float cfm,
                         float4* __restrict__ pack_b) {  // x, y, z, masked λ
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool mine = row < n;
  const int lin = mine ? key[row] : ncells;
  const int prev = mine && threadIdx.x > 0 ? key[row - 1] : lin;
  const float4 a = mine ? pack_a[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  walk_staged(pack_a, table, lin, prev, ny, nz, ncells, [&](float4 b) {
    cells_lambda_pair(a.x, a.y, a.z, b, h, hh, eps2, p6s, gx, gy, gz);
  });
  if (!mine) return;
  const float lam = cells_lambda_end(lin < ncells, a.w, p6s, gx, gy, gz, p6f, c_grad,
                                     rho_recip, cfm, fluid[row]);
  pack_b[row] = make_float4(a.x, a.y, a.z, lam);
}

__global__ void __launch_bounds__(kRows)
    delta_staged_kernel(const float4* __restrict__ pack_b,  // x, y, z, λ
                        const int* __restrict__ key, const int* __restrict__ table,
                        const unsigned char* __restrict__ fluid,
                        const float* __restrict__ scale, const float* __restrict__ lo_bound,
                        const float* __restrict__ hi_bound, int n, int ny, int nz, int ncells,
                        float h, float hh, float eps2, float skf, float xqf, float corr_k,
                        float rho_recip, float* __restrict__ pack_a) {  // xyz of (C, 4)
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool mine = row < n;
  const int lin = mine ? key[row] : ncells;
  const int prev = mine && threadIdx.x > 0 ? key[row - 1] : lin;
  const float4 a = mine ? pack_b[row] : make_float4(0.f, 0.f, 0.f, 0.f);
  float sx = 0.f, sy = 0.f, sz = 0.f;
  walk_staged(pack_b, table, lin, prev, ny, nz, ncells, [&](float4 b) {
    cells_delta_pair(a.x, a.y, a.z, a.w, b, h, hh, eps2, skf, xqf, corr_k, rho_recip, sx,
                     sy, sz);
  });
  if (!mine) return;
  cells_delta_end(a, sx, sy, sz, fluid[row], scale, lo_bound, hi_bound, pack_a + 4 * row);
}

inline int ctas_for(int n) { return (n + kRows - 1) / kRows; }

}  // namespace

extern "C" {

// pbf_lambda_cells' and pbf_delta_cells' arguments, staged walk.
int pbf_lambda_cells_staged(const void* pack_a, const void* key, const void* table,
                            const void* fluid, int n, int ny, int nz, int ncells, float h,
                            float hh, float eps2, float p6f, float c_grad, float rho_recip,
                            float cfm, void* pack_b, void* stream) {
  if (n > 0) {
    lambda_staged_kernel<<<ctas_for(n), kRows, 0, (cudaStream_t)stream>>>(
        (const float4*)pack_a, (const int*)key, (const int*)table, (const unsigned char*)fluid,
        n, ny, nz, ncells, h, hh, eps2, p6f, c_grad, rho_recip, cfm, (float4*)pack_b);
  }
  return (int)cudaGetLastError();
}

int pbf_delta_cells_staged(const void* pack_b, const void* key, const void* table,
                           const void* fluid, const void* scale, const void* lo_bound,
                           const void* hi_bound, int n, int ny, int nz, int ncells, float h,
                           float hh, float eps2, float skf, float xqf, float corr_k,
                           float rho_recip, void* pack_a, void* stream) {
  if (n > 0) {
    delta_staged_kernel<<<ctas_for(n), kRows, 0, (cudaStream_t)stream>>>(
        (const float4*)pack_b, (const int*)key, (const int*)table, (const unsigned char*)fluid,
        (const float*)scale, (const float*)lo_bound, (const float*)hi_bound, n, ny, nz, ncells,
        h, hh, eps2, skf, xqf, corr_k, rho_recip, (float*)pack_a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
