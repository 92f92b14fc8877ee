// The v2 compacted-candidate neighbour phases (sm_90a).
//
// Replaces the four Pallas TPU kernels of tools/pallas_pbf2.py:
//   pbf_compact   <- make_compact_call  (:323)  slab chunk gather
//   pbf_lambda2   <- make_lambda2_call  (:474, on _dense_phase :422)
//   pbf_delta2    <- make_delta2_call   (:547)
//   pbf_diffuse2  <- make_diffuse2_call (:612)
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
// every slab column, ~15x the pairs of the per-row kernels of
// pbf_phases.cu at the 1M dam break, for 26 (lambda2), 34 (delta2) and 19
// (diffuse2) fp32 operations a pair as written below.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>

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
  const float rho = a.w * (p.p6s * p6f);
  const float cx = p.gx * c_grad, cy = p.gy * c_grad, cz = p.gz * c_grad;
  const float norm2 = cx * cx + cy * cy + cz * cz;
  const float ci = rho * rho_recip - 1.0f;
  lam[t * kWarp + lane] = -ci / (norm2 + cfm);
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
  // and four weighted colour sums (8).  Exact on fp32 integers < 2^24.
  __device__ __forceinline__ void operator()(float w, float bcl, float cr,
                                             float cg, float cb, float ca) {
    const float e = fabsf(bcl - acl);
    const float g1 = fminf(fabsf(e - nynz), e);
    const float g2 = fminf(fabsf(g1 - nz), g1);
    const float ww = g2 <= 1.f ? w : 0.f;
    cnt += ww;
    r += ww * cr;
    g += ww * cg;
    b += ww * cb;
    a += ww * ca;
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

}  // extern "C"
