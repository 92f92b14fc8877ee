// Op streams, fp32 dots and a lane->sublane reshape on Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of tools/micro_vpu.py that
// csrc/micro_roll.cu (its rot, unal and dma probes) leaves:
//   vpu_streams <- bench_streams (:60-99, pallas_call :91): `nstreams`
//                  carries from x + s, NITER trips of one op on each (fma
//                  c*1.000001 + x, mul, cmp_where, rsqrt, sqrt(c) + x,
//                  x / c; op_carries of csrc/micro_fma.cuh, which
//                  micro_loop's loop_op shares), summed in order;
//   vpu_dot     <- dot_kernel (:184-192, :196): acc(64, 8) += (a s_i) b^T,
//                  a (64, 128), b (8, 128);
//   vpu_dot2    <- dot2_kernel (:210-215, :219): acc(64, 128) += (a s_i) b,
//                  a (64, 8), b (8, 128);
//   vpu_tr      <- tr_kernel (:233-237, :240): acc(64, 1) += x[0, 0:64] s_i,
//                  in two bodies: direct (thread t reads x[0, t] once) and
//                  restage (the row passes through shared memory each trip,
//                  a store, a barrier and a load, as dense_mxu restages).
// s_i = 1 + 1e-9 i in fp32, each op rounded, as JAX's weak typing computes
// it.  pbf_sph_tpu_torch/tools/micro_vpu.py holds the wrappers, the plain
// versions and the SASS check of every kernel here.
//
// The dots are fp32 FFMA chains, not tensor-core products: a TF32 mma would
// round each scaled operand to 10 mantissa bits, where s_i - 1 < 2.1e-6
// vanishes, and an H100's FP64 tensor-core peak is the fp32 pipe's
// (67 TFLOP/s).  scale4 and fma4 are the one FFMA body of both: each trip rounds
// a s_i to fp32 first (the scale is not hoisted out of the product), sums k
// in order from 0 by fmaf, and adds the trip's d to acc by a separate FADD:
// the model that the interpreted dot2_kernel matches bit for bit.  A thread
// computes several outputs of one row and scales the row's a once (vpu_dot
// the function's M K multiplies; vpu_dot2 16 x them, once in each of a
// row's 16 threads), and keeps what it reuses in registers: vpu_dot its row
// of a (128 floats) and vpu_dot2 its 8 columns of b (64), loaded once; the
// other operand is staged once a CTA in shared memory and read every trip.
// Fewer outputs a thread ran slower with the card filled: one an output
// (512 threads a copy, both operands read every trip) was bound by its
// shared-memory reads; 2 or 4 (b read by 4 or 2 rows a warp) by bank
// conflicts and the repeated scale multiplies.
//
// What bounds them: streams and dots instruction issue (the MUFU pipe for
// rsqrt) with the card filled, and the dependent chain of each carry at one
// copy; tr the chain of NITER dependent FFMAs a thread, so latency.  Every
// trip loop is `#pragma unroll 1` with the trip count an argument, so a trip
// holds one trip's work; repeats of the same work are the grid (streams:
// `nblocks` CTAs of 1024 threads, CTA b computing element (b mod (nelem /
// 1024)) * 1024 + t; dots and tr: CTA r computes copy r).
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// combination it has no instantiation for).

#include <cuda_runtime.h>

#include "grid_copies.cuh"
#include "micro_fma.cuh"

namespace {

constexpr int kStreamThreads = 1024;  // an (8, 128) tile a CTA
constexpr float kScaleStep = 1e-9f;
// vpu_dot: a (64, 128), b (8, 128), out (64, 8): 64 threads a copy, thread
// m row m of a in registers (loaded once) and its 8 outputs, b in shared
// memory (every thread reads the same float4 of it: a broadcast)
constexpr int kDotM = 64, kDotN = 8, kDotK = 128;
// vpu_dot2: a (64, 8), b (8, 128), out (64, 128): 512 threads a copy,
// thread t columns 8 (t mod 16) + c, c < 8, of rows t / 16 and t / 16 + 32;
// its 64 floats of b in registers (loaded once), a in shared memory
constexpr int kDot2M = 64, kDot2N = 128, kDot2K = 8;
constexpr int kDot2Threads = 512, kDot2Cols = 8, kDot2Groups = kDot2N / kDot2Cols;
constexpr int kDot2Half = kDot2M / 2;
constexpr int kTrRows = 64;           // vpu_tr: x[0, 0:64], one thread each

enum TrBody { kTrDirect = 0, kTrRestage = 1 };

// s_i, each op rounded once: never contracted into an FFMA.
__device__ __forceinline__ float trip_scale(int i) {
  return __fadd_rn(1.0f, __fmul_rn(kScaleStep, (float)i));
}

// The one FFMA body of both dots.  scale4: four a_k s, each rounded to
// fp32 (the scale is not hoisted out of the product); fma4: four k of one
// output's trip, d = fma(as_k, b_k, d) in k order.
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

__device__ __forceinline__ float fma4(float4 as, float4 b, float d) {
  d = fmaf(as.x, b.x, d);
  d = fmaf(as.y, b.y, d);
  d = fmaf(as.z, b.z, d);
  return fmaf(as.w, b.w, d);
}

template <int OP, int K>
__global__ void __launch_bounds__(kStreamThreads)
    vpu_streams_kernel(const float* __restrict__ x, int nelem, int niter,
                       float* __restrict__ out) {
  out[blockIdx.x * kStreamThreads + threadIdx.x] =
      op_carries<OP, K>(x[copy_element<kStreamThreads>(nelem / kStreamThreads)], niter);
}

__global__ void __launch_bounds__(kDotM)
    vpu_dot_kernel(const float* __restrict__ a, const float* __restrict__ b, int niter,
                   float* __restrict__ out) {
  __shared__ __align__(16) float4 sb[kDotN][kDotK / 4];
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int e = threadIdx.x; e < kDotN * kDotK / 4; e += kDotM) sb[e / 32][e % 32] = b4[e];
  const int m = threadIdx.x;
  float4 ar[kDotK / 4];
#pragma unroll
  for (int q = 0; q < kDotK / 4; ++q) ar[q] = reinterpret_cast<const float4*>(a)[m * 32 + q];
  __syncthreads();
  float acc[kDotN];
#pragma unroll
  for (int n = 0; n < kDotN; ++n) acc[n] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < niter; ++i) {
    // a compiler fence: each trip reads b from shared memory (without one,
    // nvcc hoisted a dot's operands into registers and spilled them)
    asm volatile("" ::: "memory");
    const float s = trip_scale(i);
    float d[kDotN];
#pragma unroll
    for (int n = 0; n < kDotN; ++n) d[n] = 0.0f;
#pragma unroll
    for (int q = 0; q < kDotK / 4; ++q) {
      const float4 as = scale4(ar[q], s);
#pragma unroll
      for (int n = 0; n < kDotN; ++n) d[n] = fma4(as, sb[n][q], d[n]);
    }
#pragma unroll
    for (int n = 0; n < kDotN; ++n) acc[n] = __fadd_rn(acc[n], d[n]);
  }
#pragma unroll
  for (int n = 0; n < kDotN; ++n) out[(blockIdx.x * kDotM + m) * kDotN + n] = acc[n];
}

__global__ void __launch_bounds__(kDot2Threads)
    vpu_dot2_kernel(const float* __restrict__ a, const float* __restrict__ b, int niter,
                    float* __restrict__ out) {
  __shared__ __align__(16) float4 sa[kDot2M][kDot2K / 4];
  if (threadIdx.x < kDot2M * kDot2K / 4) {
    sa[threadIdx.x / 2][threadIdx.x % 2] = reinterpret_cast<const float4*>(a)[threadIdx.x];
  }
  const int n0 = (threadIdx.x % kDot2Groups) * kDot2Cols, m0 = threadIdx.x / kDot2Groups;
  // the thread's 8 columns of b, k 0-3 and 4-7 of each
  float4 lo[kDot2Cols], hi[kDot2Cols];
#pragma unroll
  for (int c = 0; c < kDot2Cols; ++c) {
    const float* col = b + n0 + c;
    lo[c] = make_float4(col[0], col[kDot2N], col[2 * kDot2N], col[3 * kDot2N]);
    hi[c] = make_float4(col[4 * kDot2N], col[5 * kDot2N], col[6 * kDot2N], col[7 * kDot2N]);
  }
  __syncthreads();
  float acc[2][kDot2Cols];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < kDot2Cols; ++c) acc[r][c] = 0.0f;
  }
#pragma unroll 1
  for (int i = 0; i < niter; ++i) {
    asm volatile("" ::: "memory");  // a from shared memory every trip, as vpu_dot's b
    const float s = trip_scale(i);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 as0 = scale4(sa[m0 + r * kDot2Half][0], s);
      const float4 as1 = scale4(sa[m0 + r * kDot2Half][1], s);
#pragma unroll
      for (int c = 0; c < kDot2Cols; ++c) {
        acc[r][c] = __fadd_rn(acc[r][c], fma4(as1, hi[c], fma4(as0, lo[c], 0.0f)));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < kDot2Cols; ++c) {
      out[(blockIdx.x * kDot2M + m0 + r * kDot2Half) * kDot2N + n0 + c] = acc[r][c];
    }
  }
}

template <int BODY>
__global__ void __launch_bounds__(kTrRows)
    vpu_tr_kernel(const float* __restrict__ x, int niter, float* __restrict__ out) {
  const int t = threadIdx.x;
  const float v = x[t];
  float acc = 0.0f;
  if constexpr (BODY == kTrDirect) {
#pragma unroll 1
    for (int i = 0; i < niter; ++i) acc = fmaf(v, trip_scale(i), acc);
    out[blockIdx.x * kTrRows + t] = acc;
  } else {
    // thread t stores x[0, t] and takes x[0, t ^ 32], the other warp's:
    // a real exchange, double-buffered so one barrier a trip suffices
    __shared__ float row[2][kTrRows];
    const int r = t ^ 32;
#pragma unroll 1
    for (int i = 0; i < niter; ++i) {
      row[i & 1][t] = v;
      __syncthreads();
      acc = fmaf(row[i & 1][r], trip_scale(i), acc);
    }
    out[blockIdx.x * kTrRows + r] = acc;
  }
}

using StreamFn = void (*)(const float*, int, int, float*);
using PairFn = void (*)(const float*, const float*, int, float*);
using TrFn = void (*)(const float*, int, float*);

template <int OP>
StreamFn find_streams_k(int k) {
  switch (k) {
    case 1: return vpu_streams_kernel<OP, 1>;
    case 2: return vpu_streams_kernel<OP, 2>;
    case 4: return vpu_streams_kernel<OP, 4>;
    case 8: return vpu_streams_kernel<OP, 8>;
  }
  return nullptr;
}

StreamFn find_streams(int op, int k) {
  switch (op) {
    case kFma: return find_streams_k<kFma>(k);
    case kMul: return find_streams_k<kMul>(k);
    case kCmpWhere: return find_streams_k<kCmpWhere>(k);
    case kRsqrt: return find_streams_k<kRsqrt>(k);
    case kSqrtAdd: return find_streams_k<kSqrtAdd>(k);
    case kDiv: return find_streams_k<kDiv>(k);
  }
  return nullptr;
}

TrFn find_tr(int body) {
  if (body == kTrDirect) return vpu_tr_kernel<kTrDirect>;
  if (body == kTrRestage) return vpu_tr_kernel<kTrRestage>;
  return nullptr;
}

}  // namespace

extern "C" {

// The card-filling CTA count (copies) of kernel `kernel` (0 streams at op
// `a`, nstreams `b`; 1 dot; 2 dot2; 3 tr at body `a`), or -1 for a
// combination with no instantiation.
int micro_vpu_fill(int kernel, int a, int b) {
  if (kernel == 0 && find_streams(a, b) != nullptr) {
    return fill_ctas(find_streams(a, b), kStreamThreads);
  }
  if (kernel == 1) return fill_ctas(vpu_dot_kernel, kDotM);
  if (kernel == 2) return fill_ctas(vpu_dot2_kernel, kDot2Threads);
  if (kernel == 3 && find_tr(a) != nullptr) return fill_ctas(find_tr(a), kTrRows);
  return -1;
}

// x holds nelem floats, a positive multiple of 1024; out nblocks * 1024;
// nblocks >= nelem / 1024.
int vpu_streams(const void* x, int nelem, int op, int nstreams, int niter, int nblocks,
                void* out, void* stream) {
  StreamFn fn = find_streams(op, nstreams);
  if (fn == nullptr || nelem <= 0 || nelem % kStreamThreads || niter < 0 ||
      nblocks < nelem / kStreamThreads) {
    return (int)cudaErrorInvalidValue;
  }
  fn<<<nblocks, kStreamThreads, 0, (cudaStream_t)stream>>>((const float*)x, nelem, niter,
                                                           (float*)out);
  return (int)cudaGetLastError();
}

// a (64, 128), b (8, 128); out (ncopies, 64, 8).
int vpu_dot(const void* a, const void* b, int niter, int ncopies, void* out, void* stream) {
  if (niter < 0 || ncopies <= 0) return (int)cudaErrorInvalidValue;
  vpu_dot_kernel<<<ncopies, kDotM, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, niter, (float*)out);
  return (int)cudaGetLastError();
}

// a (64, 8), b (8, 128); out (ncopies, 64, 128).
int vpu_dot2(const void* a, const void* b, int niter, int ncopies, void* out, void* stream) {
  if (niter < 0 || ncopies <= 0) return (int)cudaErrorInvalidValue;
  vpu_dot2_kernel<<<ncopies, kDot2Threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, niter, (float*)out);
  return (int)cudaGetLastError();
}

// x (8, 128) (its first 64 floats are read); out (ncopies, 64, 1).
int vpu_tr(const void* x, int body, int niter, int ncopies, void* out, void* stream) {
  TrFn fn = find_tr(body);
  if (fn == nullptr || niter < 0 || ncopies <= 0) return (int)cudaErrorInvalidValue;
  fn<<<ncopies, kTrRows, 0, (cudaStream_t)stream>>>((const float*)x, niter, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
