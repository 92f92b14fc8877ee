// C++/OpenMP oracle backend of the PyTorch/CUDA port (pbf_sph_tpu_torch).
//
// The port's own copy of pbf_sph_tpu/native/csrc/ompsph.cpp, built by
// pbf_sph_tpu_torch/native/build.py with the same flags, against an
// mc_tables.h generated from pbf_sph_tpu_torch/ops/mc_tables.py.
//
// A loop-faithful, sequential-accumulation re-expression of the reference
// pipeline (reference src/omp/ompsph.hpp:85-485) written from scratch against
// the same semantics: fp32 math, dense Morton grid table, 27-cell stencil
// neighbour walks in the reference's offset order, marching-cubes surface.
// Exposed as a C ABI for ctypes.
//
// Deliberate divergences (documented reference bugs):
//   * obstacles get pStar = position/scale and a real zIndex (OCL semantics,
//     reference src/ocl/oclsph.cpp:64-69), not the OMP backend's
//     default-initialized scratch record.
//   * triangle emission order is deterministic cube-major (no atomics).
//   * out-of-domain coordinates map to "no cell" instead of size_t-wrap UB.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#include "mc_tables.h"  // generated: TRI_TABLE/EDGE_TABLE/NUM_VERTS_TABLE/CUBE_OFFSETS/EDGE_CORNERS

// Scalar type: compiled twice — fp32 (`pbf_advance`) and fp64
// (`pbf_advance_f64`), mirroring the reference OMP backend's --fp64 switch
// (reference src/benchmark.cpp:159-165).  Literal constants go through
// real(...) so the double build uses full-precision constants like the
// reference's templated Solver<size_t, double>.
#ifndef SPH_REAL
#define SPH_REAL float
#endif
#ifndef PBF_ENTRY
#define PBF_ENTRY pbf_advance
#endif
using real = SPH_REAL;

namespace {

constexpr real VD = real(0.49);
constexpr real RHO = real(6378.0);
constexpr real RHO_RECIP = real(1.0) / RHO;
constexpr real EPS = real(1e-8);
constexpr real CFM_EPSILON = real(600.0);
constexpr real CORR_DELTA_Q = real(0.3);
constexpr real CORR_K = real(0.0001);
constexpr real CORR_N = real(4.0);

constexpr int FLUID = 0;
constexpr int OBSTACLE = 1;

constexpr int64_t KEY_BIG = int64_t(1) << 40;

struct V3 {
  real x = 0, y = 0, z = 0;
};
struct V4 {
  real x = 0, y = 0, z = 0, w = 0;
};

inline V3 v3(const real* p) { return {p[0], p[1], p[2]}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, real s) { return {a.x * s, a.y * s, a.z * s}; }
inline V3 operator/(V3 a, real s) { return {a.x / s, a.y / s, a.z / s}; }
inline V4 operator+(V4 a, V4 b) { return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w}; }
inline V4 operator-(V4 a, V4 b) { return {a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w}; }
inline V4 operator*(V4 a, real s) { return {a.x * s, a.y * s, a.z * s, a.w * s}; }
inline V4 operator/(V4 a, real s) { return {a.x / s, a.y / s, a.z / s, a.w / s}; }
inline real dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline real len(V3 a) { return std::sqrt(dot(a, a)); }
inline real clampf(real v, real lo, real hi) { return std::fmin(hi, std::fmax(lo, v)); }
inline V3 clamp3(V3 v, V3 lo, V3 hi) {
  return {clampf(v.x, lo.x, hi.x), clampf(v.y, lo.y, hi.y), clampf(v.z, lo.z, hi.z)};
}
inline V4 clamp4(V4 v, real lo, real hi) {
  return {clampf(v.x, lo, hi), clampf(v.y, lo, hi), clampf(v.z, lo, hi), clampf(v.w, lo, hi)};
}
inline V3 mix3(V3 a, V3 b, real t) { return a + (b - a) * t; }
inline V4 mix4(V4 a, V4 b, real t) { return a + (b - a) * t; }

// Morton 10-bit/axis interleave (semantics of reference src/curves.h:72-88).
inline int64_t spread(int64_t v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}
inline int64_t morton3(int64_t x, int64_t y, int64_t z) {
  return spread(x) | (spread(y) << 1) | (spread(z) << 2);
}

// cell code or KEY_BIG when outside the 10-bit domain
inline int64_t code_of(int64_t cx, int64_t cy, int64_t cz) {
  if (cx < 0 || cy < 0 || cz < 0 || cx > 1023 || cy > 1023 || cz > 1023) return KEY_BIG;
  return morton3(cx, cy, cz);
}

inline int64_t trunc_cell(real v) { return (int64_t)std::trunc(v); }

struct Particle {
  int32_t id;
  int32_t type;
  real mass;
  V3 pos, vel;
  V4 col;
  // scratch
  V3 pstar;
  int64_t cx, cy, cz;
  int64_t code, key;
  real lambda = 0;
};

inline real poly6(real r2, real h, real factor) {
  real hh = h * h;
  if (r2 <= hh) {
    real d = hh - r2;
    return factor * d * d * d;
  }
  return real(0.0);
}

inline V3 spiky_grad(V3 d, real r, real h, real factor) {
  if (r >= EPS && r <= h) {
    real s = factor * ((h - r) * (h - r) / r);
    return d * s;
  }
  return V3{};
}

// 27 stencil offsets, x fastest (reference src/sph.hpp:220-234 order).
struct Off {
  int dx, dy, dz;
};
static const Off STENCIL[27] = {
    {-1, -1, -1}, {0, -1, -1}, {1, -1, -1}, {-1, 0, -1}, {0, 0, -1}, {1, 0, -1},
    {-1, 1, -1},  {0, 1, -1},  {1, 1, -1},  {-1, -1, 0}, {0, -1, 0}, {1, -1, 0},
    {-1, 0, 0},   {0, 0, 0},   {1, 0, 0},   {-1, 1, 0},  {0, 1, 0},  {1, 1, 0},
    {-1, -1, 1},  {0, -1, 1},  {1, -1, 1},  {-1, 0, 1},  {0, 0, 1},  {1, 0, 1},
    {-1, 1, 1},   {0, 1, 1},   {1, 1, 1}};

// walk [start,end) of each valid stencil cell around (cx,cy,cz)
template <typename F>
inline void for_each_neighbour(const Particle& a, const std::vector<int64_t>& table,
                               int64_t maxz, const F& f) {
  if (a.key >= maxz) return;  // invalid centers gather nothing
  for (const Off& o : STENCIL) {
    int64_t z = code_of(a.cx + o.dx, a.cy + o.dy, a.cz + o.dz);
    if (z >= maxz) continue;  // reference skip rule (src/sph.hpp:207)
    int64_t start = table[(size_t)z];
    int64_t end = (z + 1 < maxz) ? table[(size_t)z + 1] : start;  // end-rule quirk
    for (int64_t b = start; b < end; ++b) f((size_t)b);
  }
}

template <typename F>
inline void for_each_in_cells(const int64_t* codes27, const std::vector<int64_t>& table,
                              int64_t maxz, const F& f) {
  for (int i = 0; i < 27; ++i) {
    int64_t z = codes27[i];
    if (z < 0 || z >= maxz) continue;
    int64_t start = table[(size_t)z];
    int64_t end = (z + 1 < maxz) ? table[(size_t)z + 1] : start;
    for (int64_t b = start; b < end; ++b) f((size_t)b);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 if output capacity exceeded.
int PBF_ENTRY(
    // config
    real h, real dt, real scale, int iteration, const real* constant_force,
    const real* min_bound_in, const real* max_bound_in,
    int surface_on, real mc_resolution, real mc_isolevel, real mc_particle_size,
    real mc_particle_influence,
    // scene
    int n_wells, const real* wells_centre, const real* wells_force,
    int n_sources, const real* src_centre, const real* src_velocity,
    const real* src_colour, const int32_t* src_tag, const real* src_rate,
    int n_drains, const real* drain_centre, const real* drain_width,
    int n_queries, const real* q_point,
    // particles in (SoA)
    int n_in, const int32_t* pid, const int32_t* ptype, const real* mass,
    const real* pos, const real* vel, const real* col,
    // particle outputs (capacity cap)
    int cap, int32_t* o_pid, int32_t* o_ptype, real* o_mass, real* o_pos,
    real* o_vel, real* o_col, int32_t* n_out,
    // mesh outputs (capacity tri_cap triangles)
    int tri_cap, real* o_vs, real* o_ns, real* o_cs, int32_t* n_tris,
    // query outputs (qcap slots per query)
    int qcap, int32_t* o_qids, int32_t* o_qcounts,
    // stats
    int32_t* max_occupancy,
    // optional per-phase wall-clock table (12 doubles, ms; nullable) — the
    // reference OMP backend prints a Stopwatch table per frame
    // (reference src/omp/ompsph.hpp:89-482); slots: 0 sources, 1 drains,
    // 2 advect, 3 sortz, 4 gridtable, 5 queries, 6 diffuse, 7 lambda_delta,
    // 8 finalise, 9 mc_field, 10 mc_emit, 11 writeback
    double* phase_ms) {
  auto t_last = std::chrono::steady_clock::now();
  auto mark = [&](int slot) {
    auto now = std::chrono::steady_clock::now();
    if (phase_ms)
      phase_ms[slot] =
          std::chrono::duration<double, std::milli>(now - t_last).count();
    t_last = now;
  };
  if (phase_ms)
    for (int i = 0; i < 12; ++i) phase_ms[i] = 0.0;
  const V3 min_bound = v3(min_bound_in);
  const V3 max_bound = v3(max_bound_in);
  const V3 g = v3(constant_force);

  std::vector<Particle> ps;
  ps.reserve((size_t)n_in + 64);
  for (int i = 0; i < n_in; ++i) {
    Particle p;
    p.id = pid[i];
    p.type = ptype[i];
    p.mass = mass[i];
    p.pos = v3(pos + 3 * i);
    p.vel = v3(vel + 3 * i);
    p.col = {col[4 * i], col[4 * i + 1], col[4 * i + 2], col[4 * i + 3]};
    ps.push_back(p);
  }

  // 1. sources (reference src/omp/ompsph.hpp:93-105)
  const real spacing = h * scale / real(2.0);
  for (int s = 0; s < n_sources; ++s) {
    real size = std::sqrt(src_rate[s]);
    int width = (int)std::floor(size);
    int depth = (int)std::ceil(size);
    V3 centre = v3(src_centre + 3 * s);
    V3 offset = centre - V3{(real)width, 0, (real)depth} * real(0.5) * spacing;
    for (int x = 0; x < width; ++x) {
      for (int z = 0; z < depth; ++z) {
        Particle p;
        p.id = src_tag[s];
        p.type = FLUID;
        p.mass = real(1.0);
        p.pos = offset + V3{(real)x, 0, (real)z} * spacing;
        p.vel = v3(src_velocity + 3 * s);
        p.col = {src_colour[4 * s], src_colour[4 * s + 1], src_colour[4 * s + 2],
                 src_colour[4 * s + 3]};
        ps.push_back(p);
      }
    }
  }

  mark(0);
  // 2. drains (reference src/omp/ompsph.hpp:107-118)
  if (n_drains > 0) {
    ps.erase(std::remove_if(ps.begin(), ps.end(),
                            [&](const Particle& p) {
                              if (p.type == OBSTACLE) return false;
                              for (int d = 0; d < n_drains; ++d) {
                                if (len(p.pos - v3(drain_centre + 3 * d)) < drain_width[d])
                                  return true;
                              }
                              return false;
                            }),
             ps.end());
  }
  const int n = (int)ps.size();
  *n_out = n;
  *n_tris = 0;
  *max_occupancy = 0;
  for (int q = 0; q < n_queries; ++q) o_qcounts[q] = 0;
  if (n == 0) return 0;  // "Particles depleted" (reference src/omp/ompsph.hpp:122-126)
  if (n > cap) return -1;

  mark(1);
  // 3. advect (reference src/omp/ompsph.hpp:130-155)
  const real padding = h * real(2.0);
  const V3 min_extent = min_bound / scale - V3{padding, padding, padding};
  const V3 max_extent = max_bound / scale + V3{padding, padding, padding};
  const int64_t ex = (int64_t)((max_extent.x - min_extent.x) / h);
  const int64_t ey = (int64_t)((max_extent.y - min_extent.y) / h);
  const int64_t ez = (int64_t)((max_extent.z - min_extent.z) / h);
  const int64_t maxz = morton3(ex, ey, ez);

#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    Particle& p = ps[i];
    if (p.type != OBSTACLE) {
      V3 force = g * p.mass;
      for (int w = 0; w < n_wells; ++w) {
        V3 centre = v3(wells_centre + 3 * w);
        real dist = len(p.pos - centre);
        if (dist < real(75.0)) {
          V3 rhat = (centre - p.pos) / dist;
          V3 fw = rhat * wells_force[w] * p.mass / (dist * dist);
          fw = clamp3(fw, V3{-10, -10, -10}, V3{10, 10, 10});
          force = force + fw;
        }
      }
      p.vel = force * dt + p.vel;
      p.pstar = p.vel * dt + p.pos / scale;
    } else {
      p.pstar = p.pos / scale;  // OCL semantics (src/ocl/oclsph.cpp:64-69)
    }
    p.cx = trunc_cell((p.pstar.x - min_extent.x) / h);
    p.cy = trunc_cell((p.pstar.y - min_extent.y) / h);
    p.cz = trunc_cell((p.pstar.z - min_extent.z) / h);
    p.code = code_of(p.cx, p.cy, p.cz);
    p.key = p.code < maxz ? p.code : KEY_BIG;
  }

  mark(2);
  // 4. sort by key
  std::stable_sort(ps.begin(), ps.end(),
                   [](const Particle& a, const Particle& b) { return a.key < b.key; });

  mark(3);
  // 5. dense grid table: table[z] = first index with key >= z
  std::vector<int64_t> table((size_t)maxz + 1);
  {
    int64_t gi = 0;
    for (int64_t z = 0; z <= maxz; ++z) {
      while (gi != n && ps[(size_t)gi].key < z) gi++;
      table[(size_t)z] = gi;
    }
    int64_t occ = 0;
    for (int64_t z = 0; z < maxz; ++z) occ = std::max(occ, table[(size_t)z + 1] - table[(size_t)z]);
    *max_occupancy = (int32_t)occ;
  }

  mark(4);
  // 6. queries, centre cell only (reference src/omp/ompsph.hpp:167-186)
  for (int q = 0; q < n_queries; ++q) {
    V3 scaled = v3(q_point + 3 * q) / scale - min_extent;
    int64_t z = code_of(trunc_cell(scaled.x / h), trunc_cell(scaled.y / h),
                        trunc_cell(scaled.z / h));
    int32_t cnt = 0;
    if (z < maxz && z + 1 < maxz) {
      for (int64_t b = table[(size_t)z]; b < table[(size_t)z + 1]; ++b) {
        if (ps[(size_t)b].type != FLUID) continue;
        if (cnt < qcap) o_qids[(size_t)q * qcap + cnt] = ps[(size_t)b].id;
        cnt++;
      }
    }
    o_qcounts[q] = std::min(cnt, (int32_t)qcap);
    for (int k = o_qcounts[q]; k < qcap; ++k) o_qids[(size_t)q * qcap + k] = -1;
  }

  mark(5);
  // 7. colour diffusion (reference src/omp/ompsph.hpp:188-207); reads old
  // colours, writes new (OCL-style separate buffer, no in-place race)
  std::vector<V4> new_col(n);
#pragma omp parallel for
  for (int a = 0; a < n; ++a) {
    new_col[a] = ps[a].col;
    if (ps[a].type == OBSTACLE) continue;
    int cnt = 0;
    V4 mixture{};
    for_each_neighbour(ps[a], table, maxz, [&](size_t b) {
      if (ps[b].type != OBSTACLE) {
        mixture = mixture + ps[b].col;
        cnt++;
      }
    });
    if (cnt != 0) {
      V4 out = mix4(ps[a].col, (mixture / (real)cnt) * real(1.33), dt / real(750.0));
      new_col[a] = clamp4(out, real(0.03), real(1.0));
    }
  }
  for (int a = 0; a < n; ++a) ps[a].col = new_col[a];

  mark(6);
  // 8. constraint solve (reference src/omp/ompsph.hpp:209-249)
  const real pi = std::acos(-real(1.0));
  const real p6f = real(315.0) / (real(64.0) * pi * std::pow(h, real(9.0)));
  const real skf = -(real(45.0) / (pi * std::pow(h, real(6.0))));
  const real cdq = CORR_DELTA_Q * h;
  const real p6dq = poly6(cdq * cdq, h, p6f);

  std::vector<V3> dp(n);
  for (int itr = 0; itr < iteration; ++itr) {
#pragma omp parallel for
    for (int a = 0; a < n; ++a) {
      if (ps[a].type == OBSTACLE) {
        ps[a].lambda = 0;
        continue;
      }
      V3 grad{};
      real p6sum = 0;
      for_each_neighbour(ps[a], table, maxz, [&](size_t b) {
        V3 d = ps[a].pstar - ps[b].pstar;
        real r = len(d);
        grad = grad + spiky_grad(d, r, h, skf) * RHO_RECIP;
        p6sum += poly6(r * r, h, p6f);
      });
      real rho = ps[a].mass * p6sum;
      real norm2 = dot(grad, grad);
      real ci = rho / RHO - real(1.0);
      ps[a].lambda = -ci / (norm2 + CFM_EPSILON);
    }

#pragma omp parallel for
    for (int a = 0; a < n; ++a) {
      if (ps[a].type == OBSTACLE) continue;
      V3 acc{};
      for_each_neighbour(ps[a], table, maxz, [&](size_t b) {
        V3 d = ps[a].pstar - ps[b].pstar;
        real r = len(d);
        real p6 = poly6(r * r, h, p6f);
        real x = p6 / p6dq;
        real corr = -CORR_K * (x * x) * (x * x);  // x^CORR_N, CORR_N = 4
        real factor = (ps[a].lambda + ps[b].lambda + corr) * RHO_RECIP;
        acc = acc + spiky_grad(d, r, h, skf) * factor;
      });
      dp[a] = acc;
    }
#pragma omp parallel for
    for (int a = 0; a < n; ++a) {
      if (ps[a].type == OBSTACLE) continue;
      V3 moved = clamp3((ps[a].pstar + dp[a]) * scale, min_bound, max_bound);
      ps[a].pstar = moved / scale;
    }
  }

  mark(7);
  // 9. finalise (reference src/omp/ompsph.hpp:252-264)
#pragma omp parallel for
  for (int a = 0; a < n; ++a) {
    if (ps[a].type == OBSTACLE) continue;
    V3 dx = ps[a].pstar - ps[a].pos / scale;
    ps[a].pos = ps[a].pstar * scale;
    ps[a].vel = (dx * (real(1.0) / dt) + ps[a].vel) * VD;
  }

  mark(8);
  // 10. marching cubes (reference src/omp/ompsph.hpp:277-477)
  if (surface_on) {
    const real res = mc_resolution;
    const real step = h / res;
    const real iso = mc_isolevel;
    const real psize = mc_particle_size;
    const real pinfl = mc_particle_influence;
    const int64_t sx = (int64_t)std::floor((real)ex * res) + 1;
    const int64_t sy = (int64_t)std::floor((real)ey * res) + 1;
    const int64_t sz = (int64_t)std::floor((real)ez * res) + 1;
    const int64_t L = sx * sy * sz;
    std::vector<real> lat_v((size_t)L, real(0.0));
    std::vector<V3> lat_n((size_t)L);
    std::vector<V4> lat_c((size_t)L);
    const real threshold = h * scale;

#pragma omp parallel for collapse(3)
    for (int64_t x = 0; x < sx; ++x) {
      for (int64_t y = 0; y < sy; ++y) {
        for (int64_t z = 0; z < sz; ++z) {
          const V3 a = (min_extent + V3{(real)x, (real)y, (real)z} * step) * scale;
          const int64_t zx = (int64_t)((real)x / res);
          const int64_t zy = (int64_t)((real)y / res);
          const int64_t zz = (int64_t)((real)z / res);
          if (zx == ex && zy == ey && zz == ez) continue;  // far-corner node
          auto cl = [](int64_t v, int64_t lo, int64_t hi) {
            return std::max(lo, std::min(hi, v));
          };
          const int64_t xl = cl(zx - 1, 0, ex - 1), xr = cl(zx + 1, 0, ex - 1);
          const int64_t yl = cl(zy - 1, 0, ey - 1), yr = cl(zy + 1, 0, ey - 1);
          const int64_t zl = cl(zz - 1, 0, ez - 1), zr = cl(zz + 1, 0, ez - 1);
          const int64_t xs3[3] = {xl, zx, xr}, ys3[3] = {yl, zy, yr}, zs3[3] = {zl, zz, zr};
          int64_t codes27[27];
          int k = 0;
          for (int kz = 0; kz < 3; ++kz)
            for (int ky = 0; ky < 3; ++ky)
              for (int kx = 0; kx < 3; ++kx)
                codes27[k++] = code_of(xs3[kx], ys3[ky], zs3[kz]);
          real v = 0;
          V3 normal{};
          V4 colsum{};
          int cnt = 0;
          for_each_in_cells(codes27, table, maxz, [&](size_t b) {
            if (ps[b].type == OBSTACLE) return;
            V3 l = ps[b].pos - a;
            real d = len(l);
            if (d < threshold) {
              real denom = std::pow(d, pinfl);
              v += psize / denom;
              normal = normal + (l / denom) * (-pinfl * psize);
              colsum = colsum + ps[b].col;
              cnt++;
            }
          });
          real nl = len(normal);
          const size_t idx = (size_t)(x * sy * sz + y * sz + z);
          lat_v[idx] = v;
          lat_n[idx] = normal / nl;          // NaN when empty (reference parity)
          lat_c[idx] = colsum / (real)cnt;  // NaN when cnt == 0 (parity)
        }
      }
    }

    mark(9);
    // classify + deterministic emission
    const int64_t mx = sx - 1, my = sy - 1, mz = sz - 1;
    const int64_t M = mx * my * mz;
    std::atomic<int> overflow{0};
    std::vector<int32_t> ntris((size_t)M);
    std::vector<int32_t> cases((size_t)M);
#pragma omp parallel for
    for (int64_t i = 0; i < M; ++i) {
      const int64_t cx = i / (my * mz);
      const int64_t rem = i - cx * my * mz;
      const int64_t cy = rem / mz;
      const int64_t cz = rem - cy * mz;
      int ci = 0;
      for (int c = 0; c < 8; ++c) {
        const int64_t ox = cx + CUBE_OFFSETS[c][0];
        const int64_t oy = cy + CUBE_OFFSETS[c][1];
        const int64_t oz = cz + CUBE_OFFSETS[c][2];
        const real val = lat_v[(size_t)(ox * sy * sz + oy * sz + oz)];
        if (val < iso) ci |= 1 << c;
      }
      cases[(size_t)i] = ci;
      ntris[(size_t)i] = EDGE_TABLE[ci] == 0 ? 0 : NUM_VERTS_TABLE[ci] / 3;
    }
    std::vector<int64_t> offs((size_t)M);
    int64_t total = 0;
    for (int64_t i = 0; i < M; ++i) {
      offs[(size_t)i] = total;
      total += ntris[(size_t)i];
    }
    *n_tris = (int32_t)total;
    if (total > tri_cap) return -1;

#pragma omp parallel for
    for (int64_t i = 0; i < M; ++i) {
      if (ntris[(size_t)i] == 0) continue;
      const int64_t cx = i / (my * mz);
      const int64_t rem = i - cx * my * mz;
      const int64_t cy = rem / mz;
      const int64_t cz = rem - cy * mz;
      const int ci = cases[(size_t)i];
      real vals[8];
      V3 cpos[8], cn[8];
      V4 cc[8];
      for (int c = 0; c < 8; ++c) {
        const int64_t ox = cx + CUBE_OFFSETS[c][0];
        const int64_t oy = cy + CUBE_OFFSETS[c][1];
        const int64_t oz = cz + CUBE_OFFSETS[c][2];
        const size_t li = (size_t)(ox * sy * sz + oy * sz + oz);
        vals[c] = lat_v[li];
        cpos[c] = (min_extent + V3{(real)ox, (real)oy, (real)oz} * step) * scale;
        cn[c] = lat_n[li];
        cc[c] = lat_c[li];
      }
      V3 ev[12], en[12];
      V4 ec[12];
      for (int e = 0; e < 12; ++e) {
        if (!(EDGE_TABLE[ci] & (1 << e))) continue;
        const int f = EDGE_CORNERS[e][0], t = EDGE_CORNERS[e][1];
        const real tt = (iso - vals[f]) / (vals[t] - vals[f]);
        ev[e] = mix3(cpos[f], cpos[t], tt);
        en[e] = mix3(cn[f], cn[t], tt);
        ec[e] = mix4(cc[f], cc[t], tt);
      }
      int64_t tri = offs[(size_t)i];
      for (int t = 0; TRI_TABLE[ci][t] != -1; t += 3, ++tri) {
        for (int k = 0; k < 3; ++k) {
          const int e = TRI_TABLE[ci][t + k];
          const size_t row = (size_t)(tri * 3 + k);
          o_vs[row * 3 + 0] = ev[e].x;
          o_vs[row * 3 + 1] = ev[e].y;
          o_vs[row * 3 + 2] = ev[e].z;
          o_ns[row * 3 + 0] = en[e].x;
          o_ns[row * 3 + 1] = en[e].y;
          o_ns[row * 3 + 2] = en[e].z;
          o_cs[row * 4 + 0] = ec[e].x;
          o_cs[row * 4 + 1] = ec[e].y;
          o_cs[row * 4 + 2] = ec[e].z;
          o_cs[row * 4 + 3] = ec[e].w;
        }
      }
    }
    (void)overflow;
  }

  mark(10);
  // 11. writeback in sorted order (reference src/omp/ompsph.hpp:480)
  for (int a = 0; a < n; ++a) {
    o_pid[a] = ps[a].id;
    o_ptype[a] = ps[a].type;
    o_mass[a] = ps[a].mass;
    o_pos[3 * a + 0] = ps[a].pos.x;
    o_pos[3 * a + 1] = ps[a].pos.y;
    o_pos[3 * a + 2] = ps[a].pos.z;
    o_vel[3 * a + 0] = ps[a].vel.x;
    o_vel[3 * a + 1] = ps[a].vel.y;
    o_vel[3 * a + 2] = ps[a].vel.z;
    o_col[4 * a + 0] = ps[a].col.x;
    o_col[4 * a + 1] = ps[a].col.y;
    o_col[4 * a + 2] = ps[a].col.z;
    o_col[4 * a + 3] = ps[a].col.w;
  }
  mark(11);
  return 0;
}

}  // extern "C"
