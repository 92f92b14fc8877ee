// Marching-cubes lattice field (sm_90a).
//
// Replaces the Pallas TPU kernel make_mc_field_call
// (pbf_sph_tpu/ops/pallas_mc.py:185): raw field sums per lattice node.  The
// post-pass (v = size*S0, n = -S/|S|, c = Csum/cnt, the skip node at 0) stays
// in the Python wrapper (pbf_sph_tpu_torch/ops/mc_field.py).
//
// Node i = (x*nyn + y)*nzn + z sits at world position
//   aw = (min_extent + node*step)*scale,  step = h/res,
// in grid cell c = trunc(node/res) (c may equal the extent).  Output (9, L)
// fp32, rows [S0, Sx, Sy, Sz, Cr, Cg, Cb, Ca, cnt]:
//   S0 = sum d2^(-infl/2),  S = sum l*d2^(-infl/2),  l = particle - node,
// over the non-obstacle members whose sort-time cell is one of the 27 cells
// around c and whose post-finalise position has 0 < d2 < (h*scale)^2.  The
// far-corner node (c == extent on every axis) sums nothing.
//
// Design: one thread per node, in lattice order.  Particles are sorted by
// linear cell id (z fastest), so the cells (c.x+dx, c.y+dy, c.z-1..c.z+1) are
// one contiguous range of the sorted array, [table[base-1], table[base+2]),
// base = lin(c.x+dx, c.y+dy, c.z).  A (dx, dy) column off the grid is skipped;
// inside the range a candidate whose key lies across a z-wrap
// (c.z + key - base outside [0, nz)) is skipped, so each of the 27 cells is
// visited exactly once (the exact 27-neighbourhood).  Nodes in empty space
// find nine empty ranges and write zeros.
//
// The node position and d2 are computed with explicit round-to-nearest
// multiplies and adds (no FMA contraction), in the plain version's order, so
// the distance mask -- and with it cnt -- is bit-identical to the plain
// PyTorch version.
//
// What bounds it: only the nodes near the fluid have candidates; each of
// those walks its 27 cells, reading a 16-byte position (w = the non-obstacle
// flag) per candidate and a 16-byte colour per candidate within h*scale.
// Neighbouring threads are neighbouring nodes along z, which share cells, so
// the reads hit L1/L2; device memory sees about one read of the particle
// arrays and one write of the (9, L) output, which bounds the work at a few
// microseconds (by bytes).  On an H100 at mc128k (3.5M node-candidate pairs)
// the kernel takes ~0.09 ms (chip_smoke.py): the few live threads walk their
// candidates serially and the dependent loads are not hidden.  A warp or
// several threads per node, shared-memory staging of a block's cells, or a
// compact list of live nodes are left for later work.
//
// The bisection bodies.  The kernel is a template on its body; the
// production launcher mc_field instantiates kFull.  The three reduced bodies
// replace the variants of tools/micro_mc_field.py's make_variant (:83, the
// Pallas call of pallas_pbf.py:301), each the JAX body's reduction applied to
// this kernel's traversal (not to the TPU's cell-sorted sub-blocks):
//   mc_field_noop  <- "noop":  launch and the (9, L) output, all zeros;
//   mc_field_rows  <- "rows":  + the node decode, its cell and world position;
//                     every row holds ((ax + ay) + az) + meta, meta = the
//                     cell's linear id, -1 for the skip node;
//   mc_field_loops <- "loops": + the nine-column walk, one 16-byte load of
//                     pos[j] a candidate and acc += p.x * ax; no key read, no
//                     z-wrap or obstacle test, no distance mask, no weight or
//                     colour; row 0 holds acc, rows 1-8 zeros.  ptxas narrows
//                     a 16-byte load of which only .x is used (inline PTX
//                     too), so y, z and w are xor-ed into a sink a candidate
//                     (integer ops, no fp32) and written to row 1 through a
//                     mask that is 0 for every th2 >= 0.
// Beside them, mc_field_zero_fill redesigns "noop" for this card (see its
// note below); mc_field_noop stays as the ladder's first rung, the MC-field
// launch's shape.
// pbf_sph_tpu_torch/tools/micro_mc_field.py holds their wrappers, plain
// versions and the SASS check (kFull's candidate loops keep the opcodes of the
// kernel before the template).  Each is bound by its bytes: the (9, L) output,
// and for loops the (C, 4) positions and the cell table.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_copies.cuh"

namespace {

constexpr int kThreads = 128;

enum McBody { kNoop = 0, kRows = 1, kLoops = 2, kFull = 3 };

template <int kBody>
__global__ void mc_field_kernel(const float4* __restrict__ pos,     // x, y, z, nonobs
                                const float4* __restrict__ colour,  // r, g, b, a
                                const int* __restrict__ key,
                                const int* __restrict__ table,
                                const float* __restrict__ min_extent,  // (3,)
                                int nxn, int nyn, int nzn, int ex, int ey,
                                int ez, float res, float step, float scale,
                                float th2, float infl,
                                float* __restrict__ out) {
  const int n_nodes = nxn * nyn * nzn;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_nodes) return;
  if (kBody == kNoop) {
    for (int r = 0; r < 9; ++r) out[r * n_nodes + i] = 0.f;
    return;
  }
  const int nyz = nyn * nzn;
  const int x = i / nyz;
  const int y = (i - x * nyz) / nzn;
  const int z = i - x * nyz - y * nzn;
  const int cx = (int)truncf(__fdiv_rn((float)x, res));
  const int cy = (int)truncf(__fdiv_rn((float)y, res));
  const int cz = (int)truncf(__fdiv_rn((float)z, res));
  const bool skip = cx == ex && cy == ey && cz == ez;
  if (kBody == kRows) {
    const float ax = __fmul_rn(__fadd_rn(min_extent[0], __fmul_rn((float)x, step)), scale);
    const float ay = __fmul_rn(__fadd_rn(min_extent[1], __fmul_rn((float)y, step)), scale);
    const float az = __fmul_rn(__fadd_rn(min_extent[2], __fmul_rn((float)z, step)), scale);
    const float meta = skip ? -1.f : (float)((cx * (ey + 1) + cy) * (ez + 1) + cz);
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(ax, ay), az), meta);
    for (int r = 0; r < 9; ++r) out[r * n_nodes + i] = v;
    return;
  }

  float s0 = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float cr = 0.f, cg = 0.f, cb = 0.f, ca = 0.f, cnt = 0.f;
  unsigned sink = 0u;  // loops: keeps each candidate's load 16 bytes wide
  if (!skip) {
    const float ax = __fmul_rn(__fadd_rn(min_extent[0], __fmul_rn((float)x, step)), scale);
    const float ay = __fmul_rn(__fadd_rn(min_extent[1], __fmul_rn((float)y, step)), scale);
    const float az = __fmul_rn(__fadd_rn(min_extent[2], __fmul_rn((float)z, step)), scale);
    const int gny = ey + 1, gnz = ez + 1;
    const int ncells = (ex + 1) * gny * gnz;
    const bool half = infl == 0.5f;
    const float k_log = -0.5f * infl;
    for (int bx = cx - 1; bx <= cx + 1; ++bx) {
      if (bx < 0 || bx > ex) continue;
      for (int by = cy - 1; by <= cy + 1; ++by) {
        if (by < 0 || by > ey) continue;
        const int base = (bx * gny + by) * gnz + cz;
        const int lo = table[max(base - 1, 0)];
        const int hi = table[min(base + 2, ncells)];
        for (int j = lo; j < hi; ++j) {
          if (kBody == kLoops) {
            const float4 p = pos[j];
            s0 += p.x * ax;
            sink ^= __float_as_uint(p.y) ^ __float_as_uint(p.z) ^ __float_as_uint(p.w);
            continue;
          }
          const int bz = cz + (key[j] - base);
          if (bz < 0 || bz > ez) continue;  // a cell across the z-wrap
          const float4 p = pos[j];
          if (p.w < 0.5f) continue;  // obstacle
          const float lx = __fsub_rn(p.x, ax);
          const float ly = __fsub_rn(p.y, ay);
          const float lz = __fsub_rn(p.z, az);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly)),
                                     __fmul_rn(lz, lz));
          if (d2 < th2 && d2 > 0.f) {
            const float w = half ? sqrtf(rsqrtf(d2)) : expf(k_log * logf(d2));
            s0 += w;
            sx += lx * w;
            sy += ly * w;
            sz += lz * w;
            const float4 c = colour[j];
            cr += c.x;
            cg += c.y;
            cb += c.z;
            ca += c.w;
            cnt += 1.f;
          }
        }
      }
    }
  }
  if (kBody == kLoops) sx = __uint_as_float(sink & (th2 < 0.f ? ~0u : 0u));
  out[i] = s0;
  out[n_nodes + i] = sx;
  out[2 * n_nodes + i] = sy;
  out[3 * n_nodes + i] = sz;
  out[4 * n_nodes + i] = cr;
  out[5 * n_nodes + i] = cg;
  out[6 * n_nodes + i] = cb;
  out[7 * n_nodes + i] = ca;
  out[8 * n_nodes + i] = cnt;
}

template <int kBody>
int launch(const void* pos, const void* colour, const void* key,
           const void* table, const void* min_extent, int nxn, int nyn,
           int nzn, int ex, int ey, int ez, float res, float step,
           float scale, float th2, float infl, void* out, void* stream) {
  const int n_nodes = nxn * nyn * nzn;
  if (n_nodes > 0) {
    mc_field_kernel<kBody><<<(n_nodes + kThreads - 1) / kThreads, kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const float4*)pos, (const float4*)colour, (const int*)key,
        (const int*)table, (const float*)min_extent, nxn, nyn, nzn, ex, ey, ez,
        res, step, scale, th2, infl, (float*)out);
  }
  return (int)cudaGetLastError();
}

// mc_field_zero_fill: make_variant(mcf, "noop")'s output, redesigned.
//
// Replaces the "noop" variant (tools/micro_mc_field.py:83) beside
// mc_field_noop: the same (9, L) zeros.  What bounds it: the output's bytes
// (0.0011 ms at mc128k, under a launch); mc_field_noop writes them one
// thread a node, nine 4-byte stores strided by L, and read 0.0025 ms in a
// CUDA graph against torch.zeros((9, L))'s 0.0021.  So this kernel writes
// them as 16-byte stores, consecutive threads on consecutive float4s, a
// thread kFillVecs of them a pass, over the card-filling grid (`fill_ctas`,
// a grid-stride loop; no more CTAs than one pass needs), and the n mod 4
// floats past the last float4 by scalar stores of CTA 0: at mc128k, 457
// CTAs of 128 threads.

// a CTA's threads and the float4 stores a thread makes a pass of the grid
constexpr int kFillThreads = 128, kFillVecs = 4;
constexpr int kFillPerCta = kFillThreads * kFillVecs;

__global__ void __launch_bounds__(kFillThreads)
    mc_field_zero_fill_kernel(float* __restrict__ out, int n) {
  const int n4 = n / 4, t = threadIdx.x;
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int base = blockIdx.x * kFillPerCta; base < n4; base += gridDim.x * kFillPerCta) {
#pragma unroll
    for (int j = 0; j < kFillVecs; ++j) {
      const int i = base + j * kFillThreads + t;
      if (i < n4) out4[i] = zero;
    }
  }
  if (blockIdx.x == 0 && t < n - 4 * n4) out[4 * n4 + t] = 0.0f;
}

}  // namespace

#define MC_FIELD_LAUNCHER(name, body)                                          \
  int name(const void* pos, const void* colour, const void* key,               \
           const void* table, const void* min_extent, int nxn, int nyn,        \
           int nzn, int ex, int ey, int ez, float res, float step,             \
           float scale, float th2, float infl, void* out, void* stream) {      \
    return launch<body>(pos, colour, key, table, min_extent, nxn, nyn, nzn,    \
                        ex, ey, ez, res, step, scale, th2, infl, out, stream); \
  }

extern "C" {

MC_FIELD_LAUNCHER(mc_field, kFull)
MC_FIELD_LAUNCHER(mc_field_noop, kNoop)
MC_FIELD_LAUNCHER(mc_field_rows, kRows)
MC_FIELD_LAUNCHER(mc_field_loops, kLoops)

// The card-filling CTA count of mc_field_zero_fill (0 if a query fails).
int mc_field_zero_fill_ctas() { return fill_ctas(mc_field_zero_fill_kernel, kFillThreads); }

// out: n floats, 16-byte aligned; nblocks >= 1 CTAs.
int mc_field_zero_fill(void* out, int n, int nblocks, void* stream) {
  if (n < 0 || nblocks < 1 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  // no more CTAs than the output has passes' worth of float4s
  const int grid = min(nblocks, max(1, (n / 4 + kFillPerCta - 1) / kFillPerCta));
  if (n > 0) {
    mc_field_zero_fill_kernel<<<grid, kFillThreads, 0, (cudaStream_t)stream>>>((float*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
