// Pair-chunk micro-benchmark of the λ pair forms on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of tools/micro_chunk.py:
//   chunk_bench <- make_bench(body, interleave) (:115): CHUNKS chunks of the
//                  λ chunk body against a 32-chunk strip, `interleave` (1, 2,
//                  4) chunks a trip on separate carries; the body is
//                  chunk_old (:45-60: sqrt, divide, separate window and
//                  cell-adjacency masks) or chunk_new (:63-80: r2-space
//                  tests, fused masks, (h-r)^2/r = u*(h^2 + r^2) - 2h with
//                  u = rsqrt(r^2))
//   chunk_fma   <- fma_ceiling(streams) (:142): `streams` carries
//                  c*1.000001 + x (fma_carries of csrc/micro_fma.cuh)
// pbf_sph_tpu_torch/tools/micro_chunk.py holds the wrappers, the plain
// versions and the SASS check of every kernel here.
//
// Geometry: CTAs of 1024 threads, one thread an element of the JAX (64, 128)
// output, 8 CTAs a copy of it; CTA b computes elements (b mod 8) * 1024 + t
// and writes out[b * 1024 + t], so `nblocks` CTAs give nblocks / 8 copies and
// no copy is dead.  nblocks 8 is the JAX tool's size (8 of 132 SMs: the
// latency and ILP reading); the tool also fills the card (occupancy x SMs,
// micro_chunk_fill) for the issue-rate reading.
//
// chunk_bench: thread (a, j) runs chunk c against column ((c mod 32) * 128 +
// j) of the strip, staged once a CTA in shared memory as float4 (x, y, z,
// cell): 64 KB, the VMEM counterpart; a warp reads 32 neighbouring columns.
// The window test is o + j in [lo, hi) with o = (c mod 32) * 128.  What
// bounds it: instruction issue; the pair body is branch-free selects, as the
// Pallas body computes both sides of every mask: the tool's own inputs mask
// every pair out, and a branch would skip all its math.  chunk_old's IEEE
// sqrt and divide keep their slow-path guard branches (no -ftz or fast math
// in the build flags), which no input here takes.
//
// The compiler must not fold what is measured: off, lo and hi are run-time
// arguments (as constants, o + j < hi folds away); the JAX output drops gy
// and gz of every stream k >= 1, so nvcc would delete their FFMAs and an
// interleaved body would issue fewer instructions a pair: those carries are
// xor-ed into an integer sink, stored through `sinkmask`, which is 0 at run
// time, so the output is the JAX output bit for bit.  The wrapper checks the
// SASS (cuobjdump): equal fp32 instructions a pair-slot at every interleave.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// combination it has no instantiation for).

#include <cuda_runtime.h>

#include "grid_copies.cuh"
#include "micro_fma.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSub = 64;                   // rows a of the output
constexpr int kWcol = 128;                 // lanes j of the output, columns a chunk
constexpr int kStripChunks = 32;           // chunks of the strip
constexpr int kCols = kStripChunks * kWcol;
constexpr int kCopyBlocks = kSub * kWcol / kThreads;  // 8 CTAs a (64, 128) copy

enum ChunkBody { kOld = 0, kNew = 1 };

struct ChunkConsts {
  float off;  // the cell offset of the adjacency test
  int lo, hi; // the window [lo, hi)
  float hh, hf, eps, eps2, hf2, two_hf;  // h^2, h, eps, eps^2, h^2, 2h
};

struct Carry {
  float p6s, gx, gy, gz;
};

// One pair-slot of chunk_old or chunk_new, masks as selects.
template <int BODY>
__device__ __forceinline__ void chunk_pair(float ax, float ay, float az, float acl, float4 b,
                                           int g, const ChunkConsts& k, Carry& c) {
  const bool win = (g >= k.lo) & (g < k.hi);
  const bool adj = fabsf(b.w - (acl + k.off)) <= 1.0f;
  const float dx = ax - b.x;
  const float dy = ay - b.y;
  const float dz = az - b.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  float p6, sg;
  if constexpr (BODY == kOld) {
    const bool m = win & adj;
    const float t = k.hh - r2;
    const float cube = t * t * t;
    p6 = (m & (r2 <= k.hh)) ? cube : 0.0f;
    const float r = sqrtf(r2);
    const bool ok = m & (r >= k.eps) & (r <= k.hf);
    const float rs = ok ? r : 1.0f;
    const float q = k.hf - rs;
    const float v = q * q / rs;
    sg = ok ? v : 0.0f;
  } else {
    const bool q = win & adj & (r2 <= k.hh);
    const float t = q ? k.hh - r2 : 0.0f;
    p6 = t * t * t;
    const bool ok = q & (r2 >= k.eps2);
    const float u = rsqrtf(ok ? r2 : 1.0f);
    const float v = u * (k.hf2 + r2) - k.two_hf;
    sg = ok ? v : 0.0f;
  }
  c.p6s += p6;
  c.gx += dx * sg;
  c.gy += dy * sg;
  c.gz += dz * sg;
}

template <int BODY, int IL>
__global__ void __launch_bounds__(kThreads)
    chunk_bench_kernel(const float* __restrict__ s, const float* __restrict__ rows,
                       ChunkConsts k, int ntrips, unsigned sinkmask, float* __restrict__ out) {
  extern __shared__ float4 strip[];  // kCols columns of (x, y, z, cell)
  for (int col = threadIdx.x; col < kCols; col += blockDim.x) {
    strip[col] = make_float4(s[col], s[kCols + col], s[2 * kCols + col], s[3 * kCols + col]);
  }
  __syncthreads();
  const int e = copy_element<kThreads>(kCopyBlocks);
  const int a = e / kWcol;
  const int j = e % kWcol;
  const float ax = rows[a], ay = rows[kSub + a], az = rows[2 * kSub + a];
  const float acl = rows[3 * kSub + a];
  Carry c[IL];
#pragma unroll
  for (int q = 0; q < IL; ++q) c[q] = Carry{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int i = 0; i < ntrips; ++i) {
#pragma unroll
    for (int q = 0; q < IL; ++q) {
      const int o = ((i * IL + q) % kStripChunks) * kWcol;
      chunk_pair<BODY>(ax, ay, az, acl, strip[o + j], o + j, k, c[q]);
    }
  }
  // the JAX output: stream 0's four carries, p6s + gx of every other stream
  float acc = c[0].p6s + c[0].gx + c[0].gy + c[0].gz;
  unsigned sink = 0u;
#pragma unroll
  for (int q = 1; q < IL; ++q) {
    acc = acc + c[q].p6s + c[q].gx;
    sink ^= __float_as_uint(c[q].gy) ^ __float_as_uint(c[q].gz);
  }
  out[blockIdx.x * kThreads + threadIdx.x] = __uint_as_float(__float_as_uint(acc) ^
                                                             (sink & sinkmask));
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    chunk_fma_kernel(const float* __restrict__ x, int niter, float* __restrict__ out) {
  const int e = copy_element<kThreads>(kCopyBlocks);
  out[blockIdx.x * kThreads + threadIdx.x] = fma_carries<S>(x[e], niter);
}

using BenchFn = void (*)(const float*, const float*, ChunkConsts, int, unsigned, float*);
using FmaFn = void (*)(const float*, int, float*);

template <int BODY>
BenchFn bench_of(int interleave) {
  switch (interleave) {
    case 1: return chunk_bench_kernel<BODY, 1>;
    case 2: return chunk_bench_kernel<BODY, 2>;
    case 4: return chunk_bench_kernel<BODY, 4>;
  }
  return nullptr;
}

BenchFn find_bench(int body, int interleave) {
  if (body == kOld) return bench_of<kOld>(interleave);
  if (body == kNew) return bench_of<kNew>(interleave);
  return nullptr;
}

FmaFn find_fma(int streams) {
  switch (streams) {
    case 1: return chunk_fma_kernel<1>;
    case 2: return chunk_fma_kernel<2>;
    case 4: return chunk_fma_kernel<4>;
    case 8: return chunk_fma_kernel<8>;
  }
  return nullptr;
}

constexpr size_t kStripBytes = (size_t)kCols * sizeof(float4);  // 64 KB

cudaError_t allow_strip(BenchFn fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kStripBytes);
}

}  // namespace

extern "C" {

// kernel 0: chunk_bench (body, interleave); 1: chunk_fma (streams in
// `interleave`).  The card-filling CTA count, or -1 for a combination with
// no instantiation.
int micro_chunk_fill(int kernel, int body, int interleave) {
  if (kernel == 0) {
    BenchFn fn = find_bench(body, interleave);
    if (fn == nullptr || allow_strip(fn) != cudaSuccess) return -1;
    return fill_ctas(fn, kThreads, kStripBytes);
  }
  if (kernel == 1) {
    FmaFn fn = find_fma(interleave);
    return fn ? fill_ctas(fn, kThreads) : -1;
  }
  return -1;
}

// s (4, 4096): x, y, z, cell of the strip; rows (4, 64) of the rows; out
// nblocks * 1024 floats; nchunks a multiple of interleave; nblocks >= 8.
int chunk_bench(const void* s, const void* rows, int body, int interleave, float off, int lo,
                int hi, int nchunks, float hh, float hf, float eps, float eps2, float hf2,
                float two_hf, int sinkmask, int nblocks, void* out, void* stream) {
  BenchFn fn = find_bench(body, interleave);
  if (fn == nullptr || nchunks < 0 || nchunks % interleave != 0 || nblocks < kCopyBlocks) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_strip(fn);
  if (err != cudaSuccess) return (int)err;
  const ChunkConsts k{off, lo, hi, hh, hf, eps, eps2, hf2, two_hf};
  fn<<<nblocks, kThreads, kStripBytes, (cudaStream_t)stream>>>(
      (const float*)s, (const float*)rows, k, nchunks / interleave, (unsigned)sinkmask,
      (float*)out);
  return (int)cudaGetLastError();
}

// x (64, 128); out nblocks * 1024 floats; nblocks >= 8.
int chunk_fma(const void* x, int streams, int niter, int nblocks, void* out, void* stream) {
  FmaFn fn = find_fma(streams);
  if (fn == nullptr || niter < 0 || nblocks < kCopyBlocks) return (int)cudaErrorInvalidValue;
  fn<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>((const float*)x, niter, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
