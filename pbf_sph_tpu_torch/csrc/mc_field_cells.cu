// Marching-cubes lattice field with its post-pass, one launch a call (sm_90a).
//
// Replaces the Pallas TPU kernel make_mc_field_call
// (pbf_sph_tpu/ops/pallas_mc.py:185) together with the post-pass of
// PallasMcField (pallas_mc.py:336-355): row 4b of the port's kernel table,
// the redesign of mc_field (csrc/mc_field.cu, row 4), which stays beside it
// off the main path.  Python: mc_field_cells_kernel / mc_field_cells_plain in
// pbf_sph_tpu_torch/ops/mc_field.py.
//
// Node i = (x*nyn + y)*nzn + z sits at world position
//   aw = (min_extent + node*step)*scale,  step = h/res,
// in grid cell c = trunc(node/res) (c may equal the extent).  Over the
// members of the 27 cells around c that are not obstacles and alive, and
// whose post-finalise position has 0 < d2 < (h*scale)^2, l = particle - node:
//   S0 = sum w,  S = sum l*w,  Csum = sum colour,  cnt = their number,
//   w = d2^(-infl/2).
// Output (8, L) fp32 in lattice order, rows [v, nx, ny, nz, cr, cg, cb, ca]:
//   v = size*S0,  n = -(S / |S|),  |S| = sqrt((Sx*Sx + Sy*Sy) + Sz*Sz),
//   c = Csum / cnt,
// each op rounded once (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so an
// empty node gets v 0 and NaN in n and c.  The far-corner node (c == extent
// on every axis) gets 0 in all 8 rows.
//
// Inputs, read as they are: position (3, n) and colour (4, n) in the cell
// order of the index, ptype (n,) int32 and alive (n,) bool (a candidate
// counts where ptype != OBSTACLE and alive, as csrc/pbf_diffuse_cells.cu
// tests it), the sort-time cell table (ncells + 1,), min_extent (3,) and the
// particle size as a 0-d tensor, all by device pointer.  Row 4's wrapper
// built two (C, 4) packs, a non-obstacle mask and a post-pass of ~13 torch
// ops around its kernel: 20 launches a call, which this one replaces.
//
// The ranges.  Particles are sorted by linear cell id (z fastest), so the
// cells (c.x+dx, c.y+dy, z), z in [c.z-1, c.z+1] inside the grid, are one
// contiguous run of the sorted arrays:
//   [table[base - (c.z > 0)], table[base + 1 + (c.z < ez)]),
//   base = lin(c.x+dx, c.y+dy, c.z),
// and a (dx, dy) column off the grid is skipped.  These are exactly the 27
// cells that row 4's key test admits (c.z + key - base inside [0, ez]), so
// no key is read.  The node position and d2 are rounded op by op
// (__fmul_rn, __fadd_rn, __fsub_rn) in the plain version's order, so the
// distance mask -- and with it cnt and the NaN pattern of c -- is exact.
//
// The work split.  A group of G lanes (kLanes, a power of two up to 32)
// walks one node, range by range: lane g starts range k at the node's list
// index of the ranges before it (candidate v of the node's list to lane v
// mod G), so a range's reads are G consecutive floats of each SoA row and
// the lanes stay within one trip of each other; a lane loads two candidates
// (j, j + G) before it tests them.  The node first reads its 18 range
// bounds at once and sums them; an empty node stops there, and a live one
// reads them again range by range (L1 hits), the next range's while it
// walks this one.  A candidate's ptype and alive are read only when it
// lies within h*scale, its colour only when it also counts.  Each lane sums
// its candidates in order; a fixed __shfl_xor_sync butterfly then adds the
// G partial sums (a + b and b + a agree bit for bit), skipped by a warp
// whose nodes are all empty; and the group's lanes share the post-pass, lane
// g writing rows g, g + G, ...  An empty node's n and c are written as NaN
// without a divide by 0.  The same input gives the same bits on every
// launch.
//
// What bounds it: the bytes -- position 12, colour 16, ptype 4 and alive 1
// a particle row, the table, and the (8, L) output written once -- ~8 MB at
// mc128k (0.0024 ms at 3.35 TB/s); its operations (10 a node-candidate pair,
// 14 more a hit, 14 a node) take less.  Row 4 walked a node per thread: a
// live node's chain of up to 216 dependent loads on one lane, 60 G pairs/s.
// Here the chain is 216/G trips on G times the lanes, but the node's
// decode, its 18 table reads and the loop control are paid by each of its G
// lanes, and 73% of mc128k's nodes are empty (PERF.md, row 4b).  G is the
// one build knob (-DMC_FIELD_CELLS_LANES, default 4, which
// ops/mc_field.py's CELLS_LANES mirrors): tools/micro_mc_field.py --sweep
// builds this file alone at other G and reads each in turns.

// The launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

#ifndef MC_FIELD_CELLS_LANES
#define MC_FIELD_CELLS_LANES 4
#endif

namespace {

// the lanes that walk a node (tools/micro_mc_field.py's sweep builds
// others) and the threads of a CTA
constexpr int kLanes = MC_FIELD_CELLS_LANES;
constexpr int kThreads = 256;
static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "a node's lane group is a power of two within a warp");
constexpr int kObstacle = 1;  // core/types.py OBSTACLE

struct Sums {
  float s0, sx, sy, sz, cr, cg, cb, ca, cnt;
};

// what a node's walk reads
struct Walk {
  const float* __restrict__ pos;     // (3, n)
  const float* __restrict__ colour;  // (4, n)
  const int* __restrict__ ptype;
  const unsigned char* __restrict__ alive;
  int n;
  float ax, ay, az, th2, k_log;
  bool half;
};

// candidate row j as read: l = particle - node and d2
struct Cand {
  float lx, ly, lz, d2;
};

__device__ __forceinline__ Cand load(const Walk& w, int j) {
  Cand c;
  c.lx = __fsub_rn(w.pos[j], w.ax);
  c.ly = __fsub_rn(w.pos[w.n + j], w.ay);
  c.lz = __fsub_rn(w.pos[2 * w.n + j], w.az);
  c.d2 = __fadd_rn(__fadd_rn(__fmul_rn(c.lx, c.lx), __fmul_rn(c.ly, c.ly)),
                   __fmul_rn(c.lz, c.lz));
  return c;
}

// candidate row j's distance test, then its flags and, on a hit, its terms
__device__ __forceinline__ void add(Sums& a, const Walk& w, int j, const Cand& c) {
  if (c.d2 < w.th2 && c.d2 > 0.f && w.ptype[j] != kObstacle && w.alive[j]) {
    const float wt = w.half ? sqrtf(rsqrtf(c.d2)) : expf(w.k_log * logf(c.d2));
    a.s0 += wt;
    a.sx += c.lx * wt;
    a.sy += c.ly * wt;
    a.sz += c.lz * wt;
    a.cr += w.colour[j];
    a.cg += w.colour[w.n + j];
    a.cb += w.colour[2 * w.n + j];
    a.ca += w.colour[3 * w.n + j];
    a.cnt += 1.f;
  }
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// row r of the post-pass: [v, nx, ny, nz, cr, cg, cb, ca]; an empty node
// (cnt 0, so S0 = S = 0) gets v = size*0 and NaN, without a divide by 0
__device__ __forceinline__ float post(const Sums& a, float size, int r) {
  if (r == 0) return __fmul_rn(size, a.s0);
  if (a.cnt == 0.f) return __int_as_float(0x7fffffff);
  if (r < 4) {
    const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.sx, a.sx),
                                                      __fmul_rn(a.sy, a.sy)),
                                            __fmul_rn(a.sz, a.sz)));
    return -__fdiv_rn(r == 1 ? a.sx : (r == 2 ? a.sy : a.sz), norm);
  }
  return __fdiv_rn(r == 4 ? a.cr : (r == 5 ? a.cg : (r == 6 ? a.cb : a.ca)), a.cnt);
}

__global__ void __launch_bounds__(kThreads)
    mc_field_cells_kernel(const float* __restrict__ pos,     // (3, n)
                          const float* __restrict__ colour,  // (4, n)
                          const int* __restrict__ ptype,
                          const unsigned char* __restrict__ alive,
                          const int* __restrict__ table,         // (ncells + 1,)
                          const float* __restrict__ min_extent,  // (3,)
                          const float* __restrict__ size,        // 0-d
                          int n, int nxn, int nyn, int nzn, int ex, int ey, int ez,
                          float res, float step, float scale, float th2, float infl,
                          float* __restrict__ out) {  // (8, L)
  const int n_nodes = nxn * nyn * nzn;
  const int i = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes);
  const int g = threadIdx.x & (kLanes - 1);
  // every lane of a warp stays to the shuffles; a lane past the lattice
  // walks nothing
  bool skip = i >= n_nodes;
  int x = 0, y = 0, z = 0, cx = 0, cy = 0, cz = 0;
  if (!skip) {
    const int nyz = nyn * nzn;
    x = i / nyz;
    y = (i - x * nyz) / nzn;
    z = i - x * nyz - y * nzn;
    cx = (int)truncf(__fdiv_rn((float)x, res));
    cy = (int)truncf(__fdiv_rn((float)y, res));
    cz = (int)truncf(__fdiv_rn((float)z, res));
    skip = cx == ex && cy == ey && cz == ez;
  }
  const int gny = ey + 1, gnz = ez + 1;
  const int below = cz > 0, above = cz < ez;
  // column k of the node's nine, (dx, dy) = (k / 3 - 1, k % 3 - 1): its
  // range [lo, hi) of the sorted rows, empty off the grid
  auto range = [&](int k, int& lo, int& hi) {
    const int bx = cx + k / 3 - 1, by = cy + k % 3 - 1;
    const int base = (bx * gny + by) * gnz + cz;
    const bool on = !skip && bx >= 0 && bx <= ex && by >= 0 && by <= ey;
    lo = on ? table[base - below] : 0;
    hi = on ? table[base + 1 + above] : 0;
  };
  Walk w;
  w.pos = pos;
  w.colour = colour;
  w.ptype = ptype;
  w.alive = alive;
  w.n = n;
  w.ax = __fmul_rn(__fadd_rn(min_extent[0], __fmul_rn((float)x, step)), scale);
  w.ay = __fmul_rn(__fadd_rn(min_extent[1], __fmul_rn((float)y, step)), scale);
  w.az = __fmul_rn(__fadd_rn(min_extent[2], __fmul_rn((float)z, step)), scale);
  w.th2 = th2;
  w.half = infl == 0.5f;
  w.k_log = -0.5f * infl;
  Sums a = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // The node's candidates: its 18 bounds read at once, so an empty node
  // (73% of mc128k's) waits on one round trip to the table.
  int total = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    int lo, hi;
    range(k, lo, hi);
    total += hi - lo;
  }
  // Range by range, the bounds read again (from L1 now), the next range's
  // while this one is walked.  Lane g starts range k at the list index of
  // the ranges before it (`done`), so each lane keeps one candidate in G of
  // the node's list and the lanes stay within one trip of each other.
  if (total > 0) {
    int done = 0, lo, hi;
    range(0, lo, hi);
    for (int k = 0; k < 9; ++k) {
      int next_lo = 0, next_hi = 0;
      if (k < 8) range(k + 1, next_lo, next_hi);
      // two candidates loaded before either is tested
      int j = lo + ((g - done) & (kLanes - 1));
      for (; j + kLanes < hi; j += 2 * kLanes) {
        const Cand c0 = load(w, j), c1 = load(w, j + kLanes);
        add(a, w, j, c0);
        add(a, w, j + kLanes, c1);
      }
      for (; j < hi; j += kLanes) add(a, w, j, load(w, j));
      done += hi - lo;
      lo = next_lo;
      hi = next_hi;
    }
  }
  // a warp whose nodes are all empty adds nothing
  if (__any_sync(0xffffffffu, total > 0)) {
    a.s0 = group_sum(a.s0);
    a.sx = group_sum(a.sx);
    a.sy = group_sum(a.sy);
    a.sz = group_sum(a.sz);
    a.cr = group_sum(a.cr);
    a.cg = group_sum(a.cg);
    a.cb = group_sum(a.cb);
    a.ca = group_sum(a.ca);
    a.cnt = group_sum(a.cnt);
  }
  if (i >= n_nodes) return;
  // the group's lanes write the 8 rows, lane g rows g, g + G, ...
  for (int r = g; r < 8; r += kLanes) out[r * n_nodes + i] = skip ? 0.f : post(a, size[0], r);
}

}  // namespace

extern "C" {

// This build's G, the lanes that walk a node (MC_FIELD_CELLS_LANES).
int mc_field_cells_lanes() { return kLanes; }

int mc_field_cells(const void* pos, const void* colour, const void* ptype, const void* alive,
                   const void* table, const void* min_extent, const void* size, int n, int nxn,
                   int nyn, int nzn, int ex, int ey, int ez, float res, float step, float scale,
                   float th2, float infl, void* out, void* stream) {
  const long long threads = (long long)nxn * nyn * nzn * kLanes;
  if (threads > 0) {
    mc_field_cells_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)colour, (const int*)ptype,
        (const unsigned char*)alive, (const int*)table, (const float*)min_extent,
        (const float*)size, n, nxn, nyn, nzn, ex, ey, ez, res, step, scale, th2, infl,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
