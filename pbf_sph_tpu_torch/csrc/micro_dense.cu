// Dense-λ inner-loop micro-benchmark on Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of tools/micro_dense.py:
//   dense_loop <- run(kernel_fn, ...) (:56), the nine FPU bodies: a) dynamic
//                 trip (:101), b) static trip (:126), c) unrolled (:150), e)
//                 dynamic x2 (:230), f) 512-wide dynamic (:259), h) full
//                 slab (:337), i) two sub-blocks interleaved (:358), j) i)
//                 with two chunks a trip (:390), l) v1 mask math (:461)
//   dense_mxu  <- k_mxu (:219, d): r2 = A2 (32, 5) @ B2 (5, 128) a chunk,
//                 then sg (32, WCAP) @ [1; bx; by; bz]^T
//   dense_mxu  <- k_wmxu (:326, g): the same at 512-wide chunks
//   dense_scr  <- k_scr (:445, k): c)'s body, the candidates staged by DMA
// pbf_sph_tpu_torch/tools/micro_dense.py holds the wrappers, the plain
// versions and the SASS check of every kernel here.
//
// What each computes: out (nrep, nsub, 32, 4) = per row a of sub-block t,
// [sum p6, sum dx*sg, sum dy*sg, sum dz*sg] over the sub-block's WCAP = 2560
// candidates (its first nch[t] chunks of 128 for the dynamic bodies), with
// chunk_math (:65-76): r2 = max(|a - b|^2, eps2), u = rsqrt(r2), p6 =
// max(hh - r2, 0)^3, sg = max(hf - r2*u, 0)^2 * u, which is lambda_pair of
// csrc/pbf_pair.cuh, so the bodies time the λ phase kernels' own pair code
// (lambda_pair takes p6 from the unclamped r2: below eps2 = 1e-16 both give
// hh in fp32); l) the v1 mask math (:477-488, sqrt and divide under masks).  d)/g) compute what k_mxu/k_wmxu
// compute: A2 = [ax, ay, az, a2, 1] and B2 = [-2bx, -2by, -2bz, b2, 1], so
// their "r2" is a2*b2 + 1 - 2 a.b, not |a - b|^2; the port keeps it.
//
// Geometry: one CTA of 1024 threads a (copy, sub-block), two sub-blocks for
// i)/j); warp a is row a, lane l takes columns l, l+32, l+64, l+96 of each
// chunk of 128 (16 columns of a chunk of 512) and keeps one carry (p6s, gx,
// gy, gz) a row; the finish is a warp-shuffle sum of the lanes' carries.
// The sub-block's candidates are staged once a CTA in shared memory, 40 KB
// as float4 (x, y, z, 0): the VMEM counterpart.  The JAX kernels' REP loop
// recomputes the same pure values, so REP is the grid's y: CTA (t, r) writes
// copy r.  For a reading at one grid step (32 CTAs) a CTA runs `npass`
// passes over its candidates on the same carries; pass p reads them at p *
// pass_stride, which is 0 at run time but unknown to nvcc, so no pass can
// be hoisted, and the passes add no fp32 instruction.
//
// What bounds it: instruction issue (fp32 and MUFU) for the FPU bodies.
// d)/g) put r2 and the reduce on the FP64 tensor cores, 2 x WC mma a chunk
// (8 or 32 a warp), and keep the epilogue (u, p6, sg) on the fp32 pipes; sg
// goes through shared memory to the reduce's operand layout (the sg_scr
// counterpart, one chunk at a time: the TPU kernel's (32, 2560) scratch is
// 320 KB, above what a block can have).  k) stages by one TMA bulk
// copy a field (cp.async.bulk completed on an mbarrier) into x, y, z arrays
// of 10 KB each, so k) against c) isolates the staging.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// body or width it has no instantiation for, or a geometry it cannot run).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma.cuh"
#include "mbarrier.cuh"
#include "pbf_pair.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSub = 32;              // rows of a sub-block: one a warp
constexpr int kW = 128;               // columns of a chunk
constexpr int kNch = 20;              // chunks of a sub-block
constexpr int kWcap = kNch * kW;      // 2560 candidates of a sub-block
constexpr int kWide = 512;            // columns of f)'s and g)'s chunks
constexpr int kRowW = 8;              // floats of a row: rows (nsub, 32, 8)

// the bodies of dense_loop (Body.code in tools/micro_dense.py)
enum Body { kDyn = 0, kStatic = 1, kUnrolled = 2, kDyn2 = 3, kWideDyn = 4, kSlab = 5,
            kIl2 = 6, kIl2u2 = 7, kV1 = 8 };

struct DenseConsts {
  float hh, hf, eps2, eps;  // h^2, h, the r2 clamp, l)'s r floor
};

struct Carry {
  float p6s, gx, gy, gz;
};

// l)'s v1 mask math (:477-488) for one pair, masks as selects (the Pallas
// body computes both sides of every where); IEEE sqrtf and divide.
__device__ __forceinline__ void v1_math(float ax, float ay, float az, float acl, float4 b,
                                        const DenseConsts& k, Carry& c) {
  const float bcl = b.x + b.y;
  const bool m = fabsf(bcl - acl) <= 1.0f;
  const float dx = ax - b.x;
  const float dy = ay - b.y;
  const float dz = az - b.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float t = k.hh - r2;
  const float cube = t * t * t;
  const float p6 = (m & (r2 <= k.hh)) ? cube : 0.0f;
  const float rr = sqrtf(r2);
  const bool ok = m & (rr >= k.eps) & (rr <= k.hf);
  const float rs = ok ? rr : 1.0f;
  const float q = k.hf - rs;
  const float v = q * q / rs;
  const float sg = ok ? v : 0.0f;
  c.p6s += p6;
  c.gx += dx * sg;
  c.gy += dy * sg;
  c.gz += dz * sg;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// finish (:93-98): the row's four sums, written by lane 0 of its warp.
__device__ __forceinline__ void finish(const Carry& c, float4* out) {
  const float4 s = make_float4(warp_sum(c.p6s), warp_sum(c.gx), warp_sum(c.gy),
                               warp_sum(c.gz));
  if ((threadIdx.x & 31) == 0) *out = s;
}

// Sub-block t's candidates as float4 (x, y, z, 0) in shared memory.
__device__ __forceinline__ void stage(float4* dst, const float* cands, int ncols, int t) {
  const float* x = cands + t * kWcap;
  const float* y = x + ncols;
  const float* z = y + ncols;
  for (int col = threadIdx.x; col < kWcap; col += kThreads) {
    dst[col] = make_float4(x[col], y[col], z[col], 0.0f);
  }
}

// One chunk of 128 of sub-block q: the lane's 4 pairs.
__device__ __forceinline__ void chunk128(const float4* cb, int o, float ax, float ay, float az,
                                         const DenseConsts& k, Carry& c) {
#pragma unroll
  for (int j = 0; j < kW; j += 32) {
    lambda_pair(ax, ay, az, cb[o + j], k.hf, k.hh, k.eps2, c.p6s, c.gx, c.gy, c.gz);
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    dense_loop_kernel(const float* __restrict__ rows, const float* __restrict__ cands,
                      const int* __restrict__ nch, DenseConsts k, int nsub, int npass,
                      int pass_stride, float* __restrict__ out) {
  constexpr int S = (B == kIl2 || B == kIl2u2) ? 2 : 1;  // sub-blocks a CTA
  extern __shared__ float4 cbuf[];  // S x kWcap candidates
  const int t0 = blockIdx.x * S;
#pragma unroll
  for (int q = 0; q < S; ++q) stage(cbuf + q * kWcap, cands, nsub * kWcap, t0 + q);
  __syncthreads();
  const int a = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  float ax[S], ay[S], az[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const float* r = rows + ((t0 + q) * kSub + a) * kRowW;
    ax[q] = r[0];
    ay[q] = r[1];
    az[q] = r[2];
  }
  const float acl = rows[(t0 * kSub + a) * kRowW + 3];
  // the dynamic trip: sub-block t0's nch, at most the sub-block's chunks
  const int n = min(nch[t0], kNch);
  Carry c[S];
#pragma unroll
  for (int q = 0; q < S; ++q) c[q] = Carry{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int p = 0; p < npass; ++p) {
    const float4* cb = cbuf + l + p * pass_stride;
    if constexpr (B == kDyn) {
#pragma unroll 1
      for (int ch = 0; ch < n; ++ch) chunk128(cb, ch * kW, ax[0], ay[0], az[0], k, c[0]);
    } else if constexpr (B == kStatic) {
#pragma unroll 1
      for (int ch = 0; ch < kNch; ++ch) chunk128(cb, ch * kW, ax[0], ay[0], az[0], k, c[0]);
    } else if constexpr (B == kUnrolled) {
#pragma unroll
      for (int ch = 0; ch < kNch; ++ch) chunk128(cb, ch * kW, ax[0], ay[0], az[0], k, c[0]);
    } else if constexpr (B == kDyn2) {
#pragma unroll 1
      for (int ch = 0; ch < n / 2; ++ch) {
        chunk128(cb, (2 * ch) * kW, ax[0], ay[0], az[0], k, c[0]);
        chunk128(cb, (2 * ch + 1) * kW, ax[0], ay[0], az[0], k, c[0]);
      }
    } else if constexpr (B == kWideDyn) {
#pragma unroll 1
      for (int ch = 0; ch < n * kW / kWide; ++ch) {
#pragma unroll
        for (int j = 0; j < kWide; j += 32) {
          lambda_pair(ax[0], ay[0], az[0], cb[ch * kWide + j], k.hf, k.hh, k.eps2, c[0].p6s,
                      c[0].gx, c[0].gy, c[0].gz);
        }
      }
    } else if constexpr (B == kSlab) {
#pragma unroll
      for (int j = 0; j < kWcap; j += 32) {
        lambda_pair(ax[0], ay[0], az[0], cb[j], k.hf, k.hh, k.eps2, c[0].p6s, c[0].gx, c[0].gy,
                    c[0].gz);
      }
    } else if constexpr (B == kIl2) {
#pragma unroll 1
      for (int ch = 0; ch < n; ++ch) {
#pragma unroll
        for (int q = 0; q < 2; ++q) chunk128(cb, q * kWcap + ch * kW, ax[q], ay[q], az[q], k, c[q]);
      }
    } else if constexpr (B == kIl2u2) {
#pragma unroll 1
      for (int ch = 0; ch < n / 2; ++ch) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            chunk128(cb, q * kWcap + (2 * ch + u) * kW, ax[q], ay[q], az[q], k, c[q]);
          }
        }
      }
    } else if constexpr (B == kV1) {
#pragma unroll
      for (int j = 0; j < kWcap; j += 32) v1_math(ax[0], ay[0], az[0], acl, cb[j], k, c[0]);
    }
  }
  float4* o = reinterpret_cast<float4*>(out) + (blockIdx.y * nsub + t0) * kSub + a;
#pragma unroll
  for (int q = 0; q < S; ++q) finish(c[q], o + q * kSub);
}

// ---------------------------------------------------------------------------
// k): c)'s body on candidates staged by TMA bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bulk_stage(float* dst, const float* cands, int ncols, int t,
                                           uint64_t* bar) {
  constexpr uint32_t kBytes = kWcap * sizeof(float);  // 10 KB a field
  const uint32_t b = smem_u32(bar);
  if (threadIdx.x == 0) mbar_init(b, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, 3 * kBytes);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(smem_u32(dst + f * kWcap)),
          "l"(cands + f * ncols + t * kWcap), "r"(kBytes), "r"(b)
          : "memory");
    }
  }
  mbar_wait_or_trap(b, 0u);  // every thread, for phase 0
}

__global__ void __launch_bounds__(kThreads)
    dense_scr_kernel(const float* __restrict__ rows, const float* __restrict__ cands,
                     DenseConsts k, int nsub, int npass, int pass_stride,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) float cxyz[];  // x, y, z: kWcap each
  __shared__ uint64_t bar;
  const int t = blockIdx.x;
  bulk_stage(cxyz, cands, nsub * kWcap, t, &bar);
  const int a = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const float* r = rows + (t * kSub + a) * kRowW;
  const float ax = r[0], ay = r[1], az = r[2];
  Carry c{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int p = 0; p < npass; ++p) {
    const float* bx = cxyz + l + p * pass_stride;
    const float* by = bx + kWcap;
    const float* bz = by + kWcap;
#pragma unroll
    for (int j = 0; j < kWcap; j += 32) {
      lambda_pair(ax, ay, az, make_float4(bx[j], by[j], bz[j], 0.0f), k.hf, k.hh, k.eps2, c.p6s,
                  c.gx, c.gy, c.gz);
    }
  }
  finish(c, reinterpret_cast<float4*>(out) + (blockIdx.y * nsub + t) * kSub + a);
}

// ---------------------------------------------------------------------------
// d) / g): r2 and the reduce-dot on the FP64 tensor cores
// ---------------------------------------------------------------------------
//
// Warp w takes row block rb = w % 4 (rows 8rb..8rb+7) and column group
// grp = w / 4.  A chunk of WC columns: r2 of its 8 x 8 blocks (rb, cb) with
// cb = grp + 8i, K = 5 padded to 8 as two mma k-steps (A2's pad is 0), each
// rounded once to fp32; the epilogue (u, p6, sg) on the accumulator fragment;
// sg to shared memory; then the reduce sg (8 x WC) . [1; bx; by; bz]^T of the
// row block over k-steps grp*WC/32 .. on a fp64 accumulator that runs over
// every chunk; at the end the 8 groups' sums in a fixed order, rounded once.

template <int WC>
__global__ void __launch_bounds__(kThreads)
    dense_mxu_kernel(const float* __restrict__ rows, const float* __restrict__ b2,
                     DenseConsts k, int nsub, int npass, int pass_stride,
                     float* __restrict__ out) {
  constexpr int kChunks = kWcap / WC;
  constexpr int kLd = kWcap + 8;           // b2 row stride: the 4 k rows on other banks
  constexpr int kSgLd = WC + 4;            // sg row stride: the 8 rows on other banks
  constexpr int kBlocks = WC / 8 / 8;      // r2 blocks of a warp a chunk: 2 or 8
  constexpr int kKsteps = WC / 4 / 8;      // reduce k-steps of a warp a chunk: 4 or 16
  extern __shared__ float smem[];
  float* bs = smem;                        // b2's 8 rows of the sub-block
  float* sgs = smem + 8 * kLd;             // sg of one chunk (32, WC)
  __shared__ float p6red[8][kSub];
  __shared__ double redsm[8][kSub][4];

  const int t = blockIdx.x;
  const int ncols = nsub * kWcap;
  for (int i = threadIdx.x; i < 8 * kWcap; i += kThreads) {
    const int f = i / kWcap, col = i - f * kWcap;
    bs[f * kLd + col] = b2[f * ncols + t * kWcap + col];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rb = warp & 3, grp = warp >> 2;
  const int row = rb * 8 + g;
  const float* rp = rows + (t * kSub + row) * kRowW;
  const float ax = rp[0], ay = rp[1], az = rp[2];
  // a2 rounded once from its exact value (the squares are exact in fp64),
  // so no contraction choice moves it: the r2 below cancels to ~1e-2 and
  // would carry a2's last bit ~1e-5 into it
  const float a2 = __double2float_rn((double)ax * ax + (double)ay * ay + (double)az * az);
  // A2 = [ax, ay, az, a2 | 1, 0, 0, 0]: A[g][tq] of the two k-steps
  const double afrag0 = tq == 0 ? ax : (tq == 1 ? ay : (tq == 2 ? az : a2));
  const double afrag1 = tq == 0 ? 1.0 : 0.0;
  // B4 = b2 rows 4..7 = [1, bx, by, bz]: B[k][n] = B4[n][k] for n < 4, else 0
  const float* b4 = bs + (4 + (g < 4 ? g : 0)) * kLd;
  const bool live = g < 4;
  float p6s = 0.0f;
  double red0 = 0.0, red1 = 0.0;

#pragma unroll 1
  for (int p = 0; p < npass; ++p) {
#pragma unroll 1
    for (int ch = 0; ch < kChunks; ++ch) {
      const int col0 = ch * WC + p * pass_stride;
#pragma unroll
      for (int i = 0; i < kBlocks; ++i) {
        const int cb = grp + 8 * i;
        const int col = col0 + cb * 8 + g;
        double d0, d1;
        dmma_m8n8k4(afrag0, (double)bs[tq * kLd + col], d0, d1);
        dmma_m8n8k4_acc(afrag1, (double)bs[(4 + tq) * kLd + col], d0, d1);
        float sg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float r2 = fmaxf(__double2float_rn(e == 0 ? d0 : d1), k.eps2);
          const float u = rsqrtf(r2);
          const float tt = fmaxf(k.hh - r2, 0.0f);
          p6s += tt * tt * tt;
          const float t2 = fmaxf(fmaf(-r2, u, k.hf), 0.0f);
          sg[e] = t2 * t2 * u;
        }
        *reinterpret_cast<float2*>(sgs + row * kSgLd + cb * 8 + 2 * tq) =
            make_float2(sg[0], sg[1]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kKsteps; ++j) {
        const int kk = (grp * kKsteps + j) * 4 + tq;
        const float bv = b4[col0 + kk];
        dmma_m8n8k4_acc((double)sgs[row * kSgLd + kk], live ? (double)bv : 0.0, red0, red1);
      }
      __syncthreads();  // sg consumed before the next chunk writes it
    }
  }

  // the p6 sums of the row's four lanes, then of the 8 groups; red of lanes
  // tq 0, 1: (sum sg, sum bx*sg), (sum by*sg, sum bz*sg)
  p6s += __shfl_xor_sync(0xffffffffu, p6s, 1);
  p6s += __shfl_xor_sync(0xffffffffu, p6s, 2);
  if (tq == 0) p6red[grp][row] = p6s;
  if (tq < 2) {
    redsm[grp][row][2 * tq] = red0;
    redsm[grp][row][2 * tq + 1] = red1;
  }
  __syncthreads();
  if (threadIdx.x < kSub) {
    const int a = threadIdx.x;
    float p6 = 0.0f;
    double r[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      p6 += p6red[s][a];
#pragma unroll
      for (int m = 0; m < 4; ++m) r[m] += redsm[s][a][m];
    }
    // red rounded to fp32 as the TPU's dot gives it; a * sum sg - red, which
    // cancels, rounded once (the product is exact in fp64)
    const float* ra = rows + (t * kSub + a) * kRowW;
    const double gsum = __double2float_rn(r[0]);
    float g[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      g[m] = __double2float_rn((double)ra[m] * gsum - (double)__double2float_rn(r[m + 1]));
    }
    reinterpret_cast<float4*>(out)[(blockIdx.y * nsub + t) * kSub + a] =
        make_float4(p6, g[0], g[1], g[2]);
  }
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

using LoopFn = void (*)(const float*, const float*, const int*, DenseConsts, int, int, int,
                        float*);
using MxuFn = void (*)(const float*, const float*, DenseConsts, int, int, int, float*);

LoopFn find_loop(int body) {
  switch (body) {
    case kDyn: return dense_loop_kernel<kDyn>;
    case kStatic: return dense_loop_kernel<kStatic>;
    case kUnrolled: return dense_loop_kernel<kUnrolled>;
    case kDyn2: return dense_loop_kernel<kDyn2>;
    case kWideDyn: return dense_loop_kernel<kWideDyn>;
    case kSlab: return dense_loop_kernel<kSlab>;
    case kIl2: return dense_loop_kernel<kIl2>;
    case kIl2u2: return dense_loop_kernel<kIl2u2>;
    case kV1: return dense_loop_kernel<kV1>;
  }
  return nullptr;
}

MxuFn find_mxu(int width) {
  switch (width) {
    case kW: return dense_mxu_kernel<kW>;
    case kWide: return dense_mxu_kernel<kWide>;
  }
  return nullptr;
}

constexpr size_t mxu_smem(int width) {
  return (size_t)(8 * (kWcap + 8) + kSub * (width + 4)) * sizeof(float);
}

template <typename K>
cudaError_t launch_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_geometry(int nsub, int subs, int nrep, int npass) {
  return nsub <= 0 || nsub % subs != 0 || nrep <= 0 || nrep > 65535 || npass <= 0;
}

}  // namespace

extern "C" {

// rows (nsub, 32, 8); cands (3, nsub * 2560); nch (nsub) int32; out
// (nrep, nsub, 32, 4).  body: a Body id above.
int dense_loop(const void* rows, const void* cands, const void* nch, int body, int nsub,
               int nrep, int npass, int pass_stride, float hh, float hf, float eps2, float eps,
               void* out, void* stream) {
  LoopFn fn = find_loop(body);
  const int subs = (body == kIl2 || body == kIl2u2) ? 2 : 1;
  if (fn == nullptr || bad_geometry(nsub, subs, nrep, npass)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)subs * kWcap * sizeof(float4);
  cudaError_t err = launch_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const DenseConsts k{hh, hf, eps2, eps};
  fn<<<dim3(nsub / subs, nrep), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)cands, (const int*)nch, k, nsub, npass, pass_stride,
      (float*)out);
  return (int)cudaGetLastError();
}

// rows (nsub, 32, 8); b2 (8, nsub * 2560): -2bx, -2by, -2bz, b2, 1, bx, by,
// bz; width 128 (d) or 512 (g); out (nrep, nsub, 32, 4).
int dense_mxu(const void* rows, const void* b2, int width, int nsub, int nrep, int npass,
              int pass_stride, float hh, float hf, float eps2, void* out, void* stream) {
  MxuFn fn = find_mxu(width);
  if (fn == nullptr || bad_geometry(nsub, 1, nrep, npass)) return (int)cudaErrorInvalidValue;
  const size_t smem = mxu_smem(width);
  cudaError_t err = launch_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const DenseConsts k{hh, hf, eps2, 0.0f};
  fn<<<dim3(nsub, nrep), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)b2, k, nsub, npass, pass_stride, (float*)out);
  return (int)cudaGetLastError();
}

// rows (nsub, 32, 8); cands (3, nsub * 2560), 16-byte aligned; out (nrep,
// nsub, 32, 4).
int dense_scr(const void* rows, const void* cands, int nsub, int nrep, int npass,
              int pass_stride, float hh, float hf, float eps2, void* out, void* stream) {
  if (bad_geometry(nsub, 1, nrep, npass) || ((uintptr_t)cands & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 3 * kWcap * sizeof(float);
  const DenseConsts k{hh, hf, eps2, 0.0f};
  dense_scr_kernel<<<dim3(nsub, nrep), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)cands, k, nsub, npass, pass_stride, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
