// The v2 compacted-candidate neighbour phases (sm_90a).
//
// Replaces the four Pallas TPU kernels of tools/pallas_pbf2.py:
//   pbf_compact   <- make_compact_call  (:323)  slab chunk gather
//   pbf_lambda2   <- make_lambda2_call  (:474, on _dense_phase :422)
//   pbf_delta2    <- make_delta2_call   (:547)
//   pbf_diffuse2  <- make_diffuse2_call (:612)
// and redesigns three of them (the kernels PbfPhases2 launches):
//   pbf_lambda2_cull  <- make_lambda2_call  (:474)  lambda2 over the kept pairs
//   pbf_delta2_cull   <- make_delta2_call   (:547)  delta2 over the kept pairs
//   pbf_diffuse2_cull <- make_diffuse2_call (:612)  diffuse2 over the kept slots
// Each computes what its Pallas kernel computes from the same plan
// (pbf_sph_tpu_torch/tools/phases2.py: plan_compact) and slabs; the masks,
// clamp and mix of the Pallas wrappers stay in the Python wrappers
// (PbfPhases2).
//
// Layout.  A sub-block is 32 consecutive sorted rows; sub-block t owns slab
// columns [t*wcap, (t+1)*wcap) of every field, in chunks of 128 columns.
// nchunk[t] chunks hold candidates, [nchunk, nchunkp) hold SENTINEL, and
// nchunkp is a multiple of 4, so the dense kernels walk whole 512-column
// groups with no masks.  Columns past nchunkp*128 are never written or read.
//
// pbf_compact: one warp per slab chunk (t, j); lane l copies columns
// 4l..4l+3 of every field as one float4, read straight from the packed
// fields by absolute column sstart[t/32][strip] + src*128.  Bound by bytes:
// every slab byte is written once and its source read once (mostly from L2,
// since neighbouring sub-blocks take the same chunks).  The TPU's strip
// DMAs, their double buffer and the loop grouping are not carried over.
//
// pbf_lambda2 / pbf_delta2 / pbf_diffuse2: one warp per sub-block, one lane
// per row.  The warp stages each 512-column group of its slab fields in
// shared memory with coalesced float4 loads (four per lane per field), then
// every lane walks the group, reading the same address as the other lanes
// (broadcast, no bank conflicts).  Bound by operations: every row meets
// every slab column, 9.8x the pairs of the per-row kernels of
// pbf_phases.cu at the settled 1M dam break (tools/bench_phases.py), for 26
// (lambda2), 34 (delta2) and 19 (diffuse2) fp32 operations a pair as
// written below.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <climits>

#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kSubPerBlock = 32;   // NSUB: sub-blocks per 1024-row block (strip starts)
constexpr int kChunk = 128;        // WCOL: columns per slab chunk
constexpr int kGroup = 4 * kChunk; // UNROLL chunks: one staged group
constexpr int kGroup4 = kGroup / 4;
constexpr int kCompactThreads = 256;
constexpr int kDenseWarps = 2;     // sub-blocks per CTA of the dense kernels
constexpr float kSentinel = 1.0e9f;

__global__ void compact_kernel(const float* __restrict__ packed, int nf, int n,
                               const int* __restrict__ sstart,  // (nblocks, 3)
                               const int* __restrict__ meta,    // (nsub, nj)
                               const int* __restrict__ nchunk,
                               const int* __restrict__ nchunkp, int nsub, int nj,
                               float* __restrict__ out) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (w >= (long long)nsub * nj) return;
  const int t = (int)(w / nj);
  const int j = (int)(w - (long long)t * nj);
  if (j >= nchunkp[t]) return;  // left unwritten, as the Pallas kernel leaves it
  const long long slab = (long long)nsub * nj * kChunk;
  const long long dst = w * kChunk + 4 * lane;
  if (j < nchunk[t]) {
    const int m = meta[w];
    const int st = m / 8192;
    const long long col = (long long)sstart[(t / kSubPerBlock) * 3 + st] +
                          (long long)(m - st * 8192) * kChunk + 4 * lane;
    for (int f = 0; f < nf; ++f) {
      *reinterpret_cast<float4*>(out + f * slab + dst) =
          *reinterpret_cast<const float4*>(packed + (long long)f * n + col);
    }
  } else {
    const float4 s = make_float4(kSentinel, kSentinel, kSentinel, kSentinel);
    for (int f = 0; f < nf; ++f) {
      *reinterpret_cast<float4*>(out + f * slab + dst) = s;
    }
  }
}

// One 512-column group of one slab field into shared memory.
__device__ __forceinline__ void stage(float4* __restrict__ dst,
                                      const float* __restrict__ src, int lane) {
  const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int k = 0; k < kGroup4 / kWarp; ++k) dst[k * kWarp + lane] = s[k * kWarp + lane];
}

struct Lambda2Pair {
  float ax, ay, az, h, hh, eps2;
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  // 26 operations: 3 differences, r2 (5) and its clamp, rsqrt, poly6 term
  // (2) and sum (3), spiky factor (3) and sg (2), three gradient sums (6)
  __device__ __forceinline__ void operator()(float bx, float by, float bz) {
    const float dx = ax - bx;
    const float dy = ay - by;
    const float dz = az - bz;
    const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, eps2);
    const float u = rsqrtf(r2);
    const float tt = fmaxf(hh - r2, 0.f);
    p6s += tt * tt * tt;
    const float t2 = fmaxf(h - r2 * u, 0.f);
    const float sg = t2 * t2 * u;
    gx += dx * sg;
    gy += dy * sg;
    gz += dz * sg;
  }
};

// A row's raw lambda from its pair sums, each operation rounded as written
// (the contractions the compiler chose for the dense kernel, pinned), so
// lambda2_kernel and lambda2_cull_kernel agree bit for bit.
__device__ __forceinline__ float lambda_of(const Lambda2Pair& p, float mass, float p6f,
                                           float c_grad, float rho_recip, float cfm) {
  const float rho = __fmul_rn(mass, __fmul_rn(p.p6s, p6f));
  const float cx = __fmul_rn(p.gx, c_grad);
  const float cy = __fmul_rn(p.gy, c_grad);
  const float cz = __fmul_rn(p.gz, c_grad);
  const float norm2 = __fmaf_rn(cz, cz, __fmaf_rn(cy, cy, __fmul_rn(cx, cx)));
  const float ci = __fmaf_rn(rho, rho_recip, -1.0f);
  return __fdiv_rn(-ci, __fadd_rn(norm2, cfm));
}

__global__ void __launch_bounds__(kDenseWarps * kWarp)
    lambda2_kernel(const float4* __restrict__ rows,  // (C,) x, y, z, mass
                   const float* __restrict__ cands,  // (4, S) 1, x, y, z
                   const int* __restrict__ nchunkp, int nsub, int wcap, float h,
                   float hh, float eps2, float p6f, float c_grad, float rho_recip,
                   float cfm, float* __restrict__ lam) {
  __shared__ float4 sx[kDenseWarps][kGroup4];
  __shared__ float4 sy[kDenseWarps][kGroup4];
  __shared__ float4 sz[kDenseWarps][kGroup4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kDenseWarps + warp;
  if (t >= nsub) return;  // whole warps only; the kernel has no block barrier
  const long long slab = (long long)nsub * wcap;
  const long long base = (long long)t * wcap;
  const float4 a = rows[t * kWarp + lane];
  Lambda2Pair p{a.x, a.y, a.z, h, hh, eps2};
  const int ncols = nchunkp[t] * kChunk;
  for (int g = 0; g < ncols; g += kGroup) {
    stage(sx[warp], cands + slab + base + g, lane);
    stage(sy[warp], cands + 2 * slab + base + g, lane);
    stage(sz[warp], cands + 3 * slab + base + g, lane);
    __syncwarp();
    for (int c = 0; c < kGroup4; ++c) {
      const float4 bx = sx[warp][c], by = sy[warp][c], bz = sz[warp][c];
      p(bx.x, by.x, bz.x);
      p(bx.y, by.y, bz.y);
      p(bx.z, by.z, bz.z);
      p(bx.w, by.w, bz.w);
    }
    __syncwarp();
  }
  lam[t * kWarp + lane] = lambda_of(p, a.w, p6f, c_grad, rho_recip, cfm);
}

struct Delta2Pair {
  float ax, ay, az, alam, h, hh, eps2, skf, xqf, corr_k, rho_recip;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  // 34 operations: 3 differences, r2 (5) and its clamp, rsqrt, poly6 term
  // (2), xq (3) and x2 (1), factor (5), spiky factor (3), sg (4), three sums
  // (6)
  __device__ __forceinline__ void operator()(float bx, float by, float bz,
                                             float blam) {
    const float dx = ax - bx;
    const float dy = ay - by;
    const float dz = az - bz;
    const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, eps2);
    const float u = rsqrtf(r2);
    const float tt = fmaxf(hh - r2, 0.f);
    const float xq = (tt * tt * tt) * xqf;
    const float x2 = xq * xq;
    const float factor = (alam + blam + corr_k * (x2 * x2)) * rho_recip;
    const float t2 = fmaxf(h - r2 * u, 0.f);
    const float sg = (t2 * t2 * u) * skf * factor;
    sx += dx * sg;
    sy += dy * sg;
    sz += dz * sg;
  }
};

__global__ void __launch_bounds__(kDenseWarps * kWarp)
    delta2_kernel(const float4* __restrict__ rows,  // (C,) x, y, z, lambda
                  const float* __restrict__ cands,  // (4, S) 1, x, y, z
                  const float* __restrict__ lamc,   // (1, S)
                  const int* __restrict__ nchunkp, int nsub, int wcap, float h,
                  float hh, float eps2, float skf, float xqf, float corr_k,
                  float rho_recip, float* __restrict__ dp) {
  __shared__ float4 sx[kDenseWarps][kGroup4];
  __shared__ float4 sy[kDenseWarps][kGroup4];
  __shared__ float4 sz[kDenseWarps][kGroup4];
  __shared__ float4 sl[kDenseWarps][kGroup4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kDenseWarps + warp;
  if (t >= nsub) return;
  const long long slab = (long long)nsub * wcap;
  const long long base = (long long)t * wcap;
  const float4 a = rows[t * kWarp + lane];
  Delta2Pair p{a.x, a.y, a.z, a.w, h, hh, eps2, skf, xqf, corr_k, rho_recip};
  const int ncols = nchunkp[t] * kChunk;
  for (int g = 0; g < ncols; g += kGroup) {
    stage(sx[warp], cands + slab + base + g, lane);
    stage(sy[warp], cands + 2 * slab + base + g, lane);
    stage(sz[warp], cands + 3 * slab + base + g, lane);
    stage(sl[warp], lamc + base + g, lane);
    __syncwarp();
    for (int c = 0; c < kGroup4; ++c) {
      const float4 bx = sx[warp][c], by = sy[warp][c], bz = sz[warp][c];
      const float4 bl = sl[warp][c];
      p(bx.x, by.x, bz.x, bl.x);
      p(bx.y, by.y, bz.y, bl.y);
      p(bx.z, by.z, bz.z, bl.z);
      p(bx.w, by.w, bz.w, bl.w);
    }
    __syncwarp();
  }
  const long long n = (long long)nsub * kWarp;
  const int i = t * kWarp + lane;
  dp[i] = p.sx;
  dp[n + i] = p.sy;
  dp[2 * n + i] = p.sz;
}

struct Diffuse2Pair {
  float acl, nynz, nz;
  float r = 0.f, g = 0.f, b = 0.f, a = 0.f, cnt = 0.f;
  // 19 operations: the band test e = |bcl - acl|, g1 = min(|e - nynz|, e),
  // g2 = min(|g1 - nz|, g1) (8), the compare and select (2), the count (1)
  // and four weighted colour sums (8).  Exact on fp32 integers < 2^24.  The
  // sums round each operation as written (one fused multiply-add a colour),
  // so diffuse2_kernel and diffuse2_cull_kernel agree bit for bit.
  __device__ __forceinline__ void operator()(float w, float bcl, float cr,
                                             float cg, float cb, float ca) {
    const float e = fabsf(bcl - acl);
    const float g1 = fminf(fabsf(e - nynz), e);
    const float g2 = fminf(fabsf(g1 - nz), g1);
    const float ww = g2 <= 1.f ? w : 0.f;
    cnt = __fadd_rn(cnt, ww);
    r = __fmaf_rn(ww, cr, r);
    g = __fmaf_rn(ww, cg, g);
    b = __fmaf_rn(ww, cb, b);
    a = __fmaf_rn(ww, ca, a);
  }
};

__global__ void __launch_bounds__(kDenseWarps * kWarp)
    diffuse2_kernel(const float* __restrict__ acl,      // (C,) linear cell ids
                    const float* __restrict__ cands_c,  // (4, S) r, g, b, a
                    const float* __restrict__ cands_w,  // (2, S) w, bcl
                    const int* __restrict__ nchunkp, int nsub, int wcap,
                    float nynz, float nz, float* __restrict__ out) {
  __shared__ float4 sw[kDenseWarps][kGroup4];
  __shared__ float4 sc[kDenseWarps][kGroup4];
  __shared__ float4 cr[kDenseWarps][kGroup4];
  __shared__ float4 cg[kDenseWarps][kGroup4];
  __shared__ float4 cb[kDenseWarps][kGroup4];
  __shared__ float4 ca[kDenseWarps][kGroup4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kDenseWarps + warp;
  if (t >= nsub) return;
  const long long slab = (long long)nsub * wcap;
  const long long base = (long long)t * wcap;
  const int i = t * kWarp + lane;
  Diffuse2Pair p{acl[i], nynz, nz};
  const int ncols = nchunkp[t] * kChunk;
  for (int g = 0; g < ncols; g += kGroup) {
    stage(sw[warp], cands_w + base + g, lane);
    stage(sc[warp], cands_w + slab + base + g, lane);
    stage(cr[warp], cands_c + base + g, lane);
    stage(cg[warp], cands_c + slab + base + g, lane);
    stage(cb[warp], cands_c + 2 * slab + base + g, lane);
    stage(ca[warp], cands_c + 3 * slab + base + g, lane);
    __syncwarp();
    for (int c = 0; c < kGroup4; ++c) {
      const float4 w = sw[warp][c], bcl = sc[warp][c];
      const float4 r = cr[warp][c], gg = cg[warp][c], b = cb[warp][c], al = ca[warp][c];
      p(w.x, bcl.x, r.x, gg.x, b.x, al.x);
      p(w.y, bcl.y, r.y, gg.y, b.y, al.y);
      p(w.z, bcl.z, r.z, gg.z, b.z, al.z);
      p(w.w, bcl.w, r.w, gg.w, b.w, al.w);
    }
    __syncwarp();
  }
  const long long n = (long long)nsub * kWarp;
  out[i] = p.r;
  out[n + i] = p.g;
  out[2 * n + i] = p.b;
  out[3 * n + i] = p.a;
  out[4 * n + i] = p.cnt;
}

inline int dense_blocks(int nsub) { return (nsub + kDenseWarps - 1) / kDenseWarps; }

// ---------------------------------------------------------------------------
// pbf_lambda2_cull / pbf_delta2_cull: lambda2 and delta2 over the slab pairs
// that can contribute.
//
// The dense kernels above spend their time on pairs whose terms are exact
// zeros: at the 1M dam break ~11% of the slab columns lie within h of some
// row of their sub-block.  These kernels give the same raw lambda and delta
// on every member row, bit for bit, by skipping only pairs whose terms are
// +-0 and summing the rest in the dense kernels' order with the same pair
// structs.  Per warp (one sub-block, one lane a row):
//   1. the AABB of the warp's member rows, by shuffles (no member: empty);
//   2. the group test: a group is the 4 columns of one staged float4 slot, a
//      lane's own; the warp ballots each slot's AABB against the row AABB
//      and skips, warp-uniform, the slots whose squared gap is >= hh_keep.
//      SENTINEL columns (x = 1e9) and the spilled interval lanes drop out;
//   3. the vote: in a kept slot, each column's squared distance to every
//      member row and one __any_sync; only a column some member row has
//      within hh_keep runs the pair chain;
//   4. the slab is staged 256 columns at a time by 16-byte cp.async into two
//      shared buffers, the next stage in flight while one is walked; delta
//      stages the lambda slab of a stage only for its kept slots.
// The tests' squared distances are three products and two sums rounded in
// PTX (`test_r2`): never contracted and sharing no product with the pair
// chain, whose contractions stay those of the dense kernels.  The gap is <=
// |dx|, |dy|, |dz| component by component, so a column the vote keeps is
// never in a skipped slot, and `cull_keep_plain` (tools/phases2.py) repeats
// the keep mask.  Groups of 1, 8, 16 and 32 columns were no faster at the 1M
// dam break (PERF.md): a slot's AABB comes from the float4s the lane loads,
// with no shuffle and one ballot for 4 columns.
//
// Why a skipped pair's terms are zero: hh_keep = hh (1 + 2^-19), rounded up.
// The test's r2 and the chain's (any contraction) are both within 3 roundings
// of |d|^2, so a skipped pair has chain r2 >= hh (1 + 2^-19) (1 - 6u), u =
// 2^-24: tt = max(hh - r2, 0) = 0.  With rsqrtf within 2 ulp (2^-22) and one
// more rounding of r2 * u, r2 * rsqrtf(r2) >= sqrt(r2) (1 - 1.25 * 2^-22),
// and hh is f32(h*h) >= h^2 (1 - 3u) of the fp32 h: the spiky factor
// max(h - r2 * u, 0) is 0 too.  A zero spiky factor makes the lambda gradient
// terms and the delta term +-0 (lambda and the lambda slab are finite), and
// adding +-0 to a sum that starts at +0 changes no bit.
//
// Bound: the slab read (3 fields, 4 for delta) and ~11 instructions a
// column for the vote in the kept slots; the pair chain runs on the voted
// ~11%.

constexpr int kStage = 2 * kChunk;          // columns a stage copies
constexpr int kStage4 = kStage / 4;         // float4s of a field in a stage
constexpr int kStageK = kStage4 / kWarp;    // float4s of a field a lane copies
constexpr int kCullWarps = 4;               // sub-blocks per CTA
constexpr unsigned kFull = 0xffffffffu;

// One stage of the x, y, z slab fields into shared memory (no wait).
__device__ __forceinline__ void stage_xyz(float4 (*dst)[kStage4], const float* fx,
                                          const float* fy, const float* fz, int g,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < kStageK; ++k) {
    const int i = k * kWarp + lane;
    cp_async16(&dst[0][i], fx + g + 4 * i);
    cp_async16(&dst[1][i], fy + g + 4 * i);
    cp_async16(&dst[2][i], fz + g + 4 * i);
  }
}

// The AABB of the warp's member rows; empty (+inf, -inf) with none.
__device__ __forceinline__ Box row_box(float4 a, bool in) {
  const float inf = __int_as_float(0x7f800000);
  Box b{in ? a.x : inf, in ? a.y : inf, in ? a.z : inf,
        in ? a.x : -inf, in ? a.y : -inf, in ? a.z : -inf};
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    b.lx = fminf(b.lx, __shfl_xor_sync(kFull, b.lx, o));
    b.ly = fminf(b.ly, __shfl_xor_sync(kFull, b.ly, o));
    b.lz = fminf(b.lz, __shfl_xor_sync(kFull, b.lz, o));
    b.hx = fmaxf(b.hx, __shfl_xor_sync(kFull, b.hx, o));
    b.hy = fmaxf(b.hy, __shfl_xor_sync(kFull, b.hy, o));
    b.hz = fmaxf(b.hz, __shfl_xor_sync(kFull, b.hz, o));
  }
  return b;
}

// The group test over one stage (buf: its x, y, z fields), warp-uniform:
// bit `lane` of keep[k] is set when float4 slot k*32 + lane is kept.
__device__ __forceinline__ void stage_masks(float4 (*buf)[kStage4], int lane,
                                            const Box& r, float hh_keep,
                                            unsigned (&keep)[kStageK]) {
#pragma unroll
  for (int k = 0; k < kStageK; ++k) {
    const int i = k * kWarp + lane;
    const float4 x = buf[0][i], y = buf[1][i], z = buf[2][i];
    const Box g{fminf(fminf(x.x, x.y), fminf(x.z, x.w)),
                fminf(fminf(y.x, y.y), fminf(y.z, y.w)),
                fminf(fminf(z.x, z.y), fminf(z.z, z.w)),
                fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)),
                fmaxf(fmaxf(y.x, y.y), fmaxf(y.z, y.w)),
                fmaxf(fmaxf(z.x, z.y), fmaxf(z.z, z.w))};
    keep[k] = __ballot_sync(kFull, box_near(g, r, hh_keep));
  }
}

// Whether this lane's row is a member within hh_keep of the column.
__device__ __forceinline__ bool near(float4 a, bool in, float bx, float by, float bz,
                                     float hh_keep) {
  return in && test_r2(a.x - bx, a.y - by, a.z - bz) < hh_keep;
}

// The vote: visit(c, x, y, z) for every column c of the kept slots of a
// stage that some member row of the warp has within hh_keep, in column
// order, with the column's coordinates.  Warp-uniform.
template <class Visit>
__device__ __forceinline__ void walk(float4 (*buf)[kStage4], const unsigned (&keep)[kStageK],
                                     float4 a, bool in, float hh_keep, Visit visit) {
#pragma unroll
  for (int k = 0; k < kStageK; ++k) {
    for (unsigned b = keep[k]; b; b &= b - 1) {
      const int i = k * kWarp + __ffs(b) - 1;
      const float4 x = buf[0][i], y = buf[1][i], z = buf[2][i];
      if (__any_sync(kFull, near(a, in, x.x, y.x, z.x, hh_keep)))
        visit(4 * i, x.x, y.x, z.x);
      if (__any_sync(kFull, near(a, in, x.y, y.y, z.y, hh_keep)))
        visit(4 * i + 1, x.y, y.y, z.y);
      if (__any_sync(kFull, near(a, in, x.z, y.z, z.z, hh_keep)))
        visit(4 * i + 2, x.z, y.z, z.z);
      if (__any_sync(kFull, near(a, in, x.w, y.w, z.w, hh_keep)))
        visit(4 * i + 3, x.w, y.w, z.w);
    }
  }
}

__global__ void __launch_bounds__(kCullWarps * kWarp)
    lambda2_cull_kernel(const float4* __restrict__ rows,   // (C,) x, y, z, mass
                        const float* __restrict__ cands,   // (4, S) 1, x, y, z
                        const unsigned char* __restrict__ member,  // (C,)
                        const int* __restrict__ nchunkp, int nsub, int wcap, float h,
                        float hh, float hh_keep, float eps2, float p6f, float c_grad,
                        float rho_recip, float cfm, float* __restrict__ lam) {
  __shared__ float4 buf[kCullWarps][2][3][kStage4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kCullWarps + warp;
  if (t >= nsub) return;  // whole warps only; the kernel has no block barrier
  const long long slab = (long long)nsub * wcap;
  const float* fx = cands + slab + (long long)t * wcap;
  const float* fy = fx + slab;
  const float* fz = fy + slab;
  const float4 a = rows[t * kWarp + lane];
  const bool in = member[t * kWarp + lane] != 0;
  const Box box = row_box(a, in);
  Lambda2Pair p{a.x, a.y, a.z, h, hh, eps2};
  const int nst = nchunkp[t] * kChunk / kStage;
  if (nst > 0) {
    stage_xyz(buf[warp][0], fx, fy, fz, 0, lane);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<0>();
    __syncwarp();
    if (s + 1 < nst) {
      stage_xyz(buf[warp][(s + 1) & 1], fx, fy, fz, (s + 1) * kStage, lane);
      cp_async_commit();
    }
    unsigned keep[kStageK];
    stage_masks(buf[warp][s & 1], lane, box, hh_keep, keep);
    walk(buf[warp][s & 1], keep, a, in, hh_keep,
         [&](int, float bx, float by, float bz) { p(bx, by, bz); });
    __syncwarp();
  }
  lam[t * kWarp + lane] = lambda_of(p, a.w, p6f, c_grad, rho_recip, cfm);
}

__global__ void __launch_bounds__(kCullWarps * kWarp)
    delta2_cull_kernel(const float4* __restrict__ rows,   // (C,) x, y, z, lambda
                       const float* __restrict__ cands,   // (4, S) 1, x, y, z
                       const float* __restrict__ lamc,    // (1, S)
                       const unsigned char* __restrict__ member,  // (C,)
                       const int* __restrict__ nchunkp, int nsub, int wcap, float h,
                       float hh, float hh_keep, float eps2, float skf, float xqf,
                       float corr_k, float rho_recip, float* __restrict__ dp) {
  __shared__ float4 buf[kCullWarps][2][3][kStage4];
  __shared__ float4 lbuf[kCullWarps][kStage4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kCullWarps + warp;
  if (t >= nsub) return;
  const long long slab = (long long)nsub * wcap;
  const float* fl = lamc + (long long)t * wcap;
  const float* fx = cands + slab + (long long)t * wcap;
  const float* fy = fx + slab;
  const float* fz = fy + slab;
  const float4 a = rows[t * kWarp + lane];
  const bool in = member[t * kWarp + lane] != 0;
  const Box box = row_box(a, in);
  Delta2Pair p{a.x, a.y, a.z, a.w, h, hh, eps2, skf, xqf, corr_k, rho_recip};
  const float* sl = reinterpret_cast<const float*>(lbuf[warp]);
  const int nst = nchunkp[t] * kChunk / kStage;
  if (nst > 0) {
    stage_xyz(buf[warp][0], fx, fy, fz, 0, lane);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<0>();
    __syncwarp();
    unsigned keep[kStageK];
    stage_masks(buf[warp][s & 1], lane, box, hh_keep, keep);
    // this lane's float4s of the lambda slab, where the slot is kept
#pragma unroll
    for (int k = 0; k < kStageK; ++k) {
      if ((keep[k] >> lane) & 1u) {
        const int i = k * kWarp + lane;
        cp_async16(&lbuf[warp][i], fl + s * kStage + 4 * i);
      }
    }
    cp_async_commit();
    if (s + 1 < nst) {
      stage_xyz(buf[warp][(s + 1) & 1], fx, fy, fz, (s + 1) * kStage, lane);
      cp_async_commit();
      cp_async_wait<1>();  // the lambda slab of this stage, not the next stage
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    walk(buf[warp][s & 1], keep, a, in, hh_keep,
         [&](int c, float bx, float by, float bz) { p(bx, by, bz, sl[c]); });
    __syncwarp();
  }
  const long long n = (long long)nsub * kWarp;
  const int i = t * kWarp + lane;
  dp[i] = p.sx;
  dp[n + i] = p.sy;
  dp[2 * n + i] = p.sz;
}

// ---------------------------------------------------------------------------
// pbf_diffuse2_cull: diffuse2 over the slab slots that can contribute.
//
// diffuse2_kernel runs the band test of every row against every slab
// column, ~96% of its time issuing the 19 operations of pairs that add 0:
// only a row's 27 cells count, ~10% of the slab pairs at the 1M dam break.
// This kernel gives the same five sums on every member row, bit for bit, by
// skipping only columns that add +0 to each member row's sums, and summing
// the rest in the dense kernel's order with the same pair struct.  Per warp
// (one sub-block, one lane a row):
//   1. the row band [amin, amax] of the warp's member rows' cell ids, by
//      shuffles; a warp with no member row walks nothing (its sums stay 0);
//   2. the slot test: a slot is the 4 columns of one staged float4 of
//      [w, bcl], a lane's own; it is kept when [bmin, bmax], the cell ids of
//      its columns with w != 0, meets one of the nine intervals
//      [amin + o - 1, amax + o + 1], o = dx*ny*nz + dy*nz (dx, dy in
//      {-1, 0, 1}), tested in integers; the warp ballots the slots and walks
//      the kept ones, warp-uniform, in column order;
//   3. [w, bcl] is staged 256 columns at a time by 16-byte cp.async into two
//      shared buffers, the next stage in flight while one is walked; the four
//      colour fields of a stage are staged for its kept slots only.
//
// Why a skipped column adds nothing: with cell ids fp32 integers below 2^24
// (and SENTINEL for non-members) the band test is exact, and it passes for
// (a, b) iff b - a = o + d with o one of the nine offsets and d in {-1, 0,
// 1}: g2 <= 1 means g1 within 1 of 0 or nz, and g1 is e or |e - ny*nz|.  A
// member row a lies in [amin, amax], so a column it accepts lies in one of
// the intervals, and a slot none of whose w != 0 columns does is skipped
// only when every member row gives each of its columns ww = +0 (the test
// fails, or w = 0).  Then each sum would take cnt + 0 and fma(+0, c, s) = s
// for finite c: the same bits as not adding.  The sums are pinned
// (`Diffuse2Pair`), so the kept columns add as in the dense kernel.
// `diffuse_keep_plain` (tools/phases2.py) repeats the keep mask.
//
// Bound: the [w, bcl] read, the kept slots' colour read and the sums of the
// kept slots' columns; at the 1M dam break the slot test keeps ~26% of the
// slots.  A per-column warp vote in the kept slots would skip ~1% of their
// columns and was measured slower, so the kernel has none (PERF.md).

// The warp's member rows' band of cell ids and the nine band offsets.
struct RowBand {
  int amin, amax;
  int off[9];
};

__device__ __forceinline__ RowBand row_band(float acl, bool in, float nynz, float nz) {
  const int a = __float2int_rn(acl);
  RowBand band{in ? a : INT_MAX, in ? a : INT_MIN, {}};
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    band.amin = min(band.amin, __shfl_xor_sync(kFull, band.amin, o));
    band.amax = max(band.amax, __shfl_xor_sync(kFull, band.amax, o));
  }
  const int iynz = __float2int_rn(nynz), iz = __float2int_rn(nz);
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) band.off[(dx + 1) * 3 + dy + 1] = dx * iynz + dy * iz;
  return band;
}

// Whether a slot (its w and cell ids) has a column with w != 0 in one of the
// band's nine intervals.  Call only for a warp with a member row.
__device__ __forceinline__ bool slot_near(const RowBand& band, float4 w, float4 b) {
  int bmin = INT_MAX, bmax = INT_MIN;
  const float ws[4] = {w.x, w.y, w.z, w.w}, bs[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (ws[c] != 0.f) {
      const int v = __float2int_rn(bs[c]);
      bmin = min(bmin, v);
      bmax = max(bmax, v);
    }
  }
  if (bmin > bmax) return false;  // every w is 0
  // [bmin, bmax] meets [amin + o - 1, amax + o + 1] iff lo <= o <= hi
  const int lo = bmin - band.amax - 1;
  const unsigned span = (unsigned)(bmax - band.amin + 1 - lo);
  bool hit = false;
#pragma unroll
  for (int k = 0; k < 9; ++k) hit |= (unsigned)(band.off[k] - lo) <= span;
  return hit;
}

// One stage of the w and bcl slab fields into shared memory (no wait).
__device__ __forceinline__ void stage_wb(float4 (*dst)[kStage4], const float* fw,
                                         const float* fb, int g, int lane) {
#pragma unroll
  for (int k = 0; k < kStageK; ++k) {
    const int i = k * kWarp + lane;
    cp_async16(&dst[0][i], fw + g + 4 * i);
    cp_async16(&dst[1][i], fb + g + 4 * i);
  }
}

__global__ void __launch_bounds__(kCullWarps * kWarp)
    diffuse2_cull_kernel(const float* __restrict__ acl,      // (C,) linear cell ids
                         const float* __restrict__ cands_c,  // (4, S) r, g, b, a
                         const float* __restrict__ cands_w,  // (2, S) w, bcl
                         const unsigned char* __restrict__ member,  // (C,)
                         const int* __restrict__ nchunkp, int nsub, int wcap,
                         float nynz, float nz, float* __restrict__ out) {
  __shared__ float4 wb[kCullWarps][2][2][kStage4];
  __shared__ float4 cbuf[kCullWarps][4][kStage4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kCullWarps + warp;
  if (t >= nsub) return;  // whole warps only; the kernel has no block barrier
  const long long slab = (long long)nsub * wcap;
  const float* fw = cands_w + (long long)t * wcap;
  const float* fb = fw + slab;
  const float* fc = cands_c + (long long)t * wcap;
  const int i = t * kWarp + lane;
  const bool in = member[i] != 0;
  Diffuse2Pair p{acl[i], nynz, nz};
  const RowBand band = row_band(p.acl, in, nynz, nz);
  const int nst = __any_sync(kFull, in) ? nchunkp[t] * kChunk / kStage : 0;
  if (nst > 0) {
    stage_wb(wb[warp][0], fw, fb, 0, lane);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<0>();
    __syncwarp();
    float4 (*cur)[kStage4] = wb[warp][s & 1];
    unsigned keep[kStageK];
#pragma unroll
    for (int k = 0; k < kStageK; ++k) {
      const int j = k * kWarp + lane;
      const bool near = slot_near(band, cur[0][j], cur[1][j]);
      keep[k] = __ballot_sync(kFull, near);
      if (near) {  // this lane's float4s of the colour slab
#pragma unroll
        for (int f = 0; f < 4; ++f)
          cp_async16(&cbuf[warp][f][j], fc + f * slab + s * kStage + 4 * j);
      }
    }
    cp_async_commit();
    if (s + 1 < nst) {
      stage_wb(wb[warp][(s + 1) & 1], fw, fb, (s + 1) * kStage, lane);
      cp_async_commit();
      cp_async_wait<1>();  // the colours of this stage, not the next stage
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kStageK; ++k) {
      for (unsigned bits = keep[k]; bits; bits &= bits - 1) {
        const int j = k * kWarp + __ffs(bits) - 1;
        const float4 w = cur[0][j], bcl = cur[1][j];
        const float4 r = cbuf[warp][0][j], g = cbuf[warp][1][j];
        const float4 b = cbuf[warp][2][j], al = cbuf[warp][3][j];
        p(w.x, bcl.x, r.x, g.x, b.x, al.x);
        p(w.y, bcl.y, r.y, g.y, b.y, al.y);
        p(w.z, bcl.z, r.z, g.z, b.z, al.z);
        p(w.w, bcl.w, r.w, g.w, b.w, al.w);
      }
    }
    __syncwarp();
  }
  const long long n = (long long)nsub * kWarp;
  out[i] = p.r;
  out[n + i] = p.g;
  out[2 * n + i] = p.b;
  out[3 * n + i] = p.a;
  out[4 * n + i] = p.cnt;
}

inline int cull_blocks(int nsub) { return (nsub + kCullWarps - 1) / kCullWarps; }

}  // namespace

extern "C" {

int pbf_compact(const void* packed, int nf, int n, const void* sstart,
                const void* meta, const void* nchunk, const void* nchunkp,
                int nsub, int nj, void* out, void* stream) {
  const long long threads = (long long)nsub * nj * kWarp;
  if (threads > 0) {
    const int blocks = (int)((threads + kCompactThreads - 1) / kCompactThreads);
    compact_kernel<<<blocks, kCompactThreads, 0, (cudaStream_t)stream>>>(
        (const float*)packed, nf, n, (const int*)sstart, (const int*)meta,
        (const int*)nchunk, (const int*)nchunkp, nsub, nj, (float*)out);
  }
  return (int)cudaGetLastError();
}

int pbf_lambda2(const void* rows, const void* cands, const void* nchunkp,
                int nsub, int wcap, float h, float hh, float eps2, float p6f,
                float c_grad, float rho_recip, float cfm, void* lam,
                void* stream) {
  if (nsub > 0) {
    lambda2_kernel<<<dense_blocks(nsub), kDenseWarps * kWarp, 0,
                     (cudaStream_t)stream>>>(
        (const float4*)rows, (const float*)cands, (const int*)nchunkp, nsub,
        wcap, h, hh, eps2, p6f, c_grad, rho_recip, cfm, (float*)lam);
  }
  return (int)cudaGetLastError();
}

int pbf_delta2(const void* rows, const void* cands, const void* lamc,
               const void* nchunkp, int nsub, int wcap, float h, float hh,
               float eps2, float skf, float xqf, float corr_k, float rho_recip,
               void* dp, void* stream) {
  if (nsub > 0) {
    delta2_kernel<<<dense_blocks(nsub), kDenseWarps * kWarp, 0,
                    (cudaStream_t)stream>>>(
        (const float4*)rows, (const float*)cands, (const float*)lamc,
        (const int*)nchunkp, nsub, wcap, h, hh, eps2, skf, xqf, corr_k,
        rho_recip, (float*)dp);
  }
  return (int)cudaGetLastError();
}

int pbf_lambda2_cull(const void* rows, const void* cands, const void* member,
                     const void* nchunkp, int nsub, int wcap, float h, float hh,
                     float hh_keep, float eps2, float p6f, float c_grad,
                     float rho_recip, float cfm, void* lam, void* stream) {
  if (nsub > 0) {
    lambda2_cull_kernel<<<cull_blocks(nsub), kCullWarps * kWarp, 0,
                          (cudaStream_t)stream>>>(
        (const float4*)rows, (const float*)cands, (const unsigned char*)member,
        (const int*)nchunkp, nsub, wcap, h, hh, hh_keep, eps2, p6f, c_grad, rho_recip,
        cfm, (float*)lam);
  }
  return (int)cudaGetLastError();
}

int pbf_delta2_cull(const void* rows, const void* cands, const void* lamc,
                    const void* member, const void* nchunkp, int nsub, int wcap,
                    float h, float hh, float hh_keep, float eps2, float skf, float xqf,
                    float corr_k, float rho_recip, void* dp, void* stream) {
  if (nsub > 0) {
    delta2_cull_kernel<<<cull_blocks(nsub), kCullWarps * kWarp, 0,
                         (cudaStream_t)stream>>>(
        (const float4*)rows, (const float*)cands, (const float*)lamc,
        (const unsigned char*)member, (const int*)nchunkp, nsub, wcap, h, hh, hh_keep,
        eps2, skf, xqf, corr_k, rho_recip, (float*)dp);
  }
  return (int)cudaGetLastError();
}

int pbf_diffuse2(const void* acl, const void* cands_c, const void* cands_w,
                 const void* nchunkp, int nsub, int wcap, float nynz, float nz,
                 void* out, void* stream) {
  if (nsub > 0) {
    diffuse2_kernel<<<dense_blocks(nsub), kDenseWarps * kWarp, 0,
                      (cudaStream_t)stream>>>(
        (const float*)acl, (const float*)cands_c, (const float*)cands_w,
        (const int*)nchunkp, nsub, wcap, nynz, nz, (float*)out);
  }
  return (int)cudaGetLastError();
}

int pbf_diffuse2_cull(const void* acl, const void* cands_c, const void* cands_w,
                      const void* member, const void* nchunkp, int nsub, int wcap,
                      float nynz, float nz, void* out, void* stream) {
  if (nsub > 0) {
    diffuse2_cull_kernel<<<cull_blocks(nsub), kCullWarps * kWarp, 0,
                           (cudaStream_t)stream>>>(
        (const float*)acl, (const float*)cands_c, (const float*)cands_w,
        (const unsigned char*)member, (const int*)nchunkp, nsub, wcap, nynz, nz,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
