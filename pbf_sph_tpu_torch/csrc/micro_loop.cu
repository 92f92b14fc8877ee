// Loop-overhead, ILP, latency and op-rate probes on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels that tools/micro_loop.py's `run` (:34)
// launches, the 16 bodies of its `main` (:48-117):
//   loop_fma   <- a) one carry c*1.000001 + x, b) 2-32 independent carries,
//                 d) 1-4 carries on the (64, 128) tile (fma_carries of
//                 csrc/micro_fma.cuh, shared with chunk_fma)
//   loop_chain <- c) a serial chain of K FMAs a trip on one carry
//   loop_op    <- e) 8 carries of one op a trip: rsqrt(c + x),
//                 where(c > x, c, x) + 1e-7, c*1.000001, c + x,
//                 where(|c - x| <= 1, c + x, x) (op_carries and op_round
//                 of csrc/micro_fma.cuh, shared with vpu_streams)
// pbf_sph_tpu_torch/tools/micro_loop.py holds the wrappers, the plain
// versions and the SASS check of every kernel here.
//
// Geometry: CTAs of 1024 threads, one thread an element of the JAX output
// ((8, 128) = one CTA, or (64, 128) = 8 CTAs, `nelem` 1024 or 8192); CTA b
// computes elements (b mod (nelem / 1024)) * 1024 + t and writes
// out[b * 1024 + t], so no copy is dead.  One copy is the JAX tool's size
// (1 or 8 of 132 SMs: the latency and ILP reading); the tool also fills the
// card (occupancy x SMs, micro_loop_fill) for the issue-rate reading.
//
// What bounds them: instruction issue, or the MUFU pipe for rsqrt, by
// construction.  Every trip loop is `#pragma unroll 1`, so a trip holds the
// tool's ops once and the loop's own instructions: a) measures those.  Trip
// counts are run-time arguments, so a check can run fewer trips than a
// reading.  where(c > x, c, x) is written as the select it is; the card
// computes it as it will (FSETP + FSEL, or FMNMX), and the SASS check counts
// what it finds.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// combination it has no instantiation for).

#include <cuda_runtime.h>

#include "grid_copies.cuh"
#include "micro_fma.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kOpCarries = 8;  // e)'s carries

__device__ __forceinline__ int element(int nelem) {
  return copy_element<kThreads>(nelem / kThreads);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    loop_fma_kernel(const float* __restrict__ x, int nelem, int niter, float* __restrict__ out) {
  out[blockIdx.x * kThreads + threadIdx.x] = fma_carries<K>(x[element(nelem)], niter);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    loop_chain_kernel(const float* __restrict__ x, int nelem, int niter,
                      float* __restrict__ out) {
  const float xv = x[element(nelem)];
  float c = xv;
#pragma unroll 1
  for (int i = 0; i < niter; ++i) {
#pragma unroll
    for (int q = 0; q < K; ++q) c = fmaf(c, kFmaScale, xv);
  }
  out[blockIdx.x * kThreads + threadIdx.x] = c;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
    loop_op_kernel(const float* __restrict__ x, int nelem, int niter, float* __restrict__ out) {
  out[blockIdx.x * kThreads + threadIdx.x] =
      op_carries<OP, kOpCarries>(x[element(nelem)], niter);
}

using LoopFn = void (*)(const float*, int, int, float*);

LoopFn find_fma(int carries) {
  switch (carries) {
    case 1: return loop_fma_kernel<1>;
    case 2: return loop_fma_kernel<2>;
    case 4: return loop_fma_kernel<4>;
    case 8: return loop_fma_kernel<8>;
    case 16: return loop_fma_kernel<16>;
    case 32: return loop_fma_kernel<32>;
  }
  return nullptr;
}

LoopFn find_chain(int k) {
  switch (k) {
    case 4: return loop_chain_kernel<4>;
    case 16: return loop_chain_kernel<16>;
  }
  return nullptr;
}

LoopFn find_op(int op) {
  switch (op) {
    case kRsqrtAdd: return loop_op_kernel<kRsqrtAdd>;
    case kWhereAdd: return loop_op_kernel<kWhereAdd>;
    case kMul: return loop_op_kernel<kMul>;
    case kAdd: return loop_op_kernel<kAdd>;
    case kSubAbsCmp: return loop_op_kernel<kSubAbsCmp>;
  }
  return nullptr;
}

// kernel 0 loop_fma (carries), 1 loop_chain (k), 2 loop_op (op)
LoopFn find_loop(int kernel, int variant) {
  if (kernel == 0) return find_fma(variant);
  if (kernel == 1) return find_chain(variant);
  if (kernel == 2) return find_op(variant);
  return nullptr;
}

int launch(int kernel, int variant, const void* x, int nelem, int niter, int nblocks,
           void* out, void* stream) {
  LoopFn fn = find_loop(kernel, variant);
  if (fn == nullptr || (nelem != kThreads && nelem != 8 * kThreads) || niter < 0 ||
      nblocks < nelem / kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  fn<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>((const float*)x, nelem, niter,
                                                     (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The card-filling CTA count of loop kernel `kernel` (0 fma, 1 chain, 2 op)
// at `variant`, or -1 for a combination with no instantiation.
int micro_loop_fill(int kernel, int variant) {
  LoopFn fn = find_loop(kernel, variant);
  return fn == nullptr ? -1 : fill_ctas(fn, kThreads);
}

// x holds nelem (1024 or 8192) floats; out nblocks * 1024; nblocks >=
// nelem / 1024.
int loop_fma(const void* x, int nelem, int carries, int niter, int nblocks, void* out,
             void* stream) {
  return launch(0, carries, x, nelem, niter, nblocks, out, stream);
}

int loop_chain(const void* x, int nelem, int k, int niter, int nblocks, void* out,
               void* stream) {
  return launch(1, k, x, nelem, niter, nblocks, out, stream);
}

int loop_op(const void* x, int nelem, int op, int niter, int nblocks, void* out,
            void* stream) {
  return launch(2, op, x, nelem, niter, nblocks, out, stream);
}

}  // extern "C"
