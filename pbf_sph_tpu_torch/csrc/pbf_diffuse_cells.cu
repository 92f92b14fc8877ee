// Colour diffusion of one PBF frame, redesigned for Hopper (sm_90a).
//
// On the solver's main path these two replace the per-row kernel pbf_diffuse
// of csrc/pbf_phases.cu and the torch ops around it, which replace the Pallas
// TPU kernel of pbf_sph_tpu/ops/pallas_pbf.py:
//   pbf_diffuse_cell_sums + pbf_diffuse_cells <- make_diffuse_call (:578) with
//                                                the wrapper's mix and clamp
//                                                (:715-737)
//
// The Pallas kernel weights a candidate by its cell's adjacency to the row's
// cell (|cell_b - cell_a| <= 1 on each axis) and by nonobs alone: there is no
// distance cutoff.  So every row of one cell gets the same four colour sums
// and count, and the work splits in two:
//   pbf_diffuse_cell_sums  one thread a cell walks its run [table[c],
//                          table[c+1]) in row order and adds r, g, b, a and 1
//                          of each row with ptype != OBSTACLE and alive, from
//                          0.f, into a (ncells, 8) pack: (r, g, b, a) and
//                          (count, 0, 0, 0), two aligned float4 a cell.
//   pbf_diffuse_cells      one thread a sorted row: a member row decodes its
//                          cell once and adds the pack of the 27 cells around
//                          it, dx outer, then dy, then dz, from 0.f, skipping
//                          a cell off the grid on any axis (the grid has no
//                          wrap); then mix_colour's update in the kernel,
//                          rounded op by op as the torch ops round it, where
//                          FLUID & alive & count > 0.5.  Other rows keep their
//                          colour.  dt is read through a device pointer.
// No atomics: each sum has one thread and one order, the plain versions'
// (ops/diffuse_cells.py), and the two agree bit for bit.  Every add is a
// select (`if (w) s += c`), never `s += c * w`, which nvcc would contract
// into an FFMA; the mix's multiplies and adds are __fmul_rn/__fadd_rn/
// __fsub_rn for the same reason, and `/` is IEEE (no fast math).
//
// What bounds them: bytes.  The sums read colour, ptype, alive and the table
// once and write the pack (32 bytes a cell); the gather reads the key, the
// row's colour, ptype and alive and writes its colour.  Its 27 pack reads a
// row hit L1/L2: the pack of dam1m's 681,472 cells is 21.8 MB, inside the
// 50 MB L2, and the rows of one cell sit on adjacent lanes and read the same
// 27 cells, so a warp mostly broadcasts.  The per-row kernel instead walked
// ~168 candidates a row, each with a key load and two integer divides.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFluid = 0;     // core/types.py FLUID
constexpr int kObstacle = 1;  // core/types.py OBSTACLE

__global__ void __launch_bounds__(kThreads)
    cell_sums_kernel(const float* __restrict__ colour,  // (4, n) r, g, b, a
                     const int* __restrict__ ptype, const unsigned char* __restrict__ alive,
                     const int* __restrict__ table, int n, int ncells,
                     float4* __restrict__ pack) {  // (ncells, 2): (r, g, b, a), (count, 0...)
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= ncells) return;
  float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f, cnt = 0.f;
  const int hi = table[c + 1];
  for (int j = table[c]; j < hi; ++j) {
    if (ptype[j] != kObstacle && alive[j]) {
      sr += colour[j];
      sg += colour[n + j];
      sb += colour[2 * n + j];
      sa += colour[3 * n + j];
      cnt += 1.f;
    }
  }
  pack[2 * c] = make_float4(sr, sg, sb, sa);
  pack[2 * c + 1] = make_float4(cnt, 0.f, 0.f, 0.f);
}

// mix_colour's update of one channel (ops/phases.py), op by op.
__device__ __forceinline__ float mix(float col, float sum, float cnt_safe, float rate) {
  const float target = __fmul_rn(sum / cnt_safe, 1.33f);
  const float mixed = __fadd_rn(col, __fmul_rn(rate, __fsub_rn(target, col)));
  // torch.clamp(mixed, 0.03, 1.0), NaN passing through
  return mixed < 0.03f ? 0.03f : (mixed > 1.f ? 1.f : mixed);
}

__global__ void __launch_bounds__(kThreads)
    diffuse_cells_kernel(const float4* __restrict__ pack, const int* __restrict__ key,
                         const float* __restrict__ colour, const int* __restrict__ ptype,
                         const unsigned char* __restrict__ alive, const float* __restrict__ dt,
                         int n, int nx, int ny, int nz,
                         float* __restrict__ out) {  // (4, n)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int lin = key[i];
  float cr = colour[i], cg = colour[n + i], cb = colour[2 * n + i], ca = colour[3 * n + i];
  const int nynz = ny * nz;
  if (lin < nx * nynz && ptype[i] == kFluid && alive[i]) {
    const int cx = lin / nynz;
    const int cy = (lin - cx * nynz) / nz;
    const int cz = lin - cx * nynz - cy * nz;
    float sr = 0.f, sg = 0.f, sb = 0.f, sa = 0.f, cnt = 0.f;
    for (int dx = -1; dx <= 1; ++dx) {
      const int x = cx + dx;
      if (x < 0 || x >= nx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int y = cy + dy;
        if (y < 0 || y >= ny) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int z = cz + dz;
          if (z < 0 || z >= nz) continue;
          const int c = x * nynz + y * nz + z;
          const float4 s = pack[2 * c];
          sr += s.x;
          sg += s.y;
          sb += s.z;
          sa += s.w;
          cnt += reinterpret_cast<const float*>(pack + 2 * c + 1)[0];
        }
      }
    }
    if (cnt > 0.5f) {
      const float cnt_safe = fmaxf(cnt, 1.f);
      const float rate = *dt / 750.f;
      cr = mix(cr, sr, cnt_safe, rate);
      cg = mix(cg, sg, cnt_safe, rate);
      cb = mix(cb, sb, cnt_safe, rate);
      ca = mix(ca, sa, cnt_safe, rate);
    }
  }
  out[i] = cr;
  out[n + i] = cg;
  out[2 * n + i] = cb;
  out[3 * n + i] = ca;
}

inline int ctas_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int pbf_diffuse_cell_sums(const void* colour, const void* ptype, const void* alive,
                          const void* table, int n, int ncells, void* pack, void* stream) {
  if (ncells > 0) {
    cell_sums_kernel<<<ctas_for(ncells), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)colour, (const int*)ptype, (const unsigned char*)alive,
        (const int*)table, n, ncells, (float4*)pack);
  }
  return (int)cudaGetLastError();
}

int pbf_diffuse_cells(const void* pack, const void* key, const void* colour, const void* ptype,
                      const void* alive, const void* dt, int n, int nx, int ny, int nz,
                      void* out, void* stream) {
  if (n > 0) {
    diffuse_cells_kernel<<<ctas_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)pack, (const int*)key, (const float*)colour, (const int*)ptype,
        (const unsigned char*)alive, (const float*)dt, n, nx, ny, nz, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
