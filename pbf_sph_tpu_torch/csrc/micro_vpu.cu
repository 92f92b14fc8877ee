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
// and two redesigns of the same TPU kernels for this card, beside them:
//   vpu_dot_spread <- dot_kernel: vpu_dot's function bit for bit, one copy
//                  spread over 128 CTAs (see its note below);
//   vpu_tr_split   <- tr_kernel: tr's sum over the trips in P parts and a
//                  fixed tree (see its note below).
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
#include "mbarrier.cuh"
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
// vpu_dot_spread: CTA (blockIdx.x, blockIdx.y) = (row m and group of kSpreadCols
// columns, copy); kSpreadWarps producer warps of kSpreadTrips trips a thread
// fill a tile of kSpreadTile trips into one of kSpreadSlots ring slots, and
// lanes 0-3 of the consumer warp (warp 11: the fourth scheduler's, which
// holds two producer warps where the other three hold three) add it to acc
// in trip order, kSpreadRead trips a read-in.  A ring row is an output's tile,
// padded by a read-in (the read ahead past the tile's end stays in its row)
// and by 4 floats (the 4 consumer lanes' float4 reads fall in 4 bank
// groups).
#ifndef MICRO_VPU_SPREAD_WARPS
#define MICRO_VPU_SPREAD_WARPS 11
#endif
#ifndef MICRO_VPU_SPREAD_TRIPS
#define MICRO_VPU_SPREAD_TRIPS 3
#endif
#ifndef MICRO_VPU_SPREAD_SLOTS
#define MICRO_VPU_SPREAD_SLOTS 2
#endif
// what a sweep build keeps of the kernel: 0 all of it; 1 the producers (the
// consumer adds one trip of each tile); 2 the chain (the producers store 0)
#ifndef MICRO_VPU_SPREAD_PART
#define MICRO_VPU_SPREAD_PART 0
#endif
constexpr int kSpreadCols = 4, kSpreadColGroups = kDotN / kSpreadCols;
constexpr int kSpreadWarps = MICRO_VPU_SPREAD_WARPS, kSpreadTrips = MICRO_VPU_SPREAD_TRIPS;
constexpr int kSpreadProducers = 32 * kSpreadWarps;
constexpr int kSpreadThreads = kSpreadProducers + 32;
constexpr int kSpreadTile = kSpreadProducers * kSpreadTrips;
constexpr int kSpreadSlots = MICRO_VPU_SPREAD_SLOTS, kSpreadRead = 32;
constexpr int kSpreadPart = MICRO_VPU_SPREAD_PART;
constexpr int kSpreadStride = kSpreadTile + kSpreadRead + 4;
// vpu_tr_split: a thread a (row, part), up to kTrSplitThreads a CTA; the
// chain's trip loop unrolled kTrSplitUnroll times, so the scales of the
// next trips are computed while the FFMAs of these wait on each other
constexpr int kTrSplitThreads = 256, kTrSplitMaxParts = 256, kTrSplitUnroll = 4;

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

// vpu_dot_spread's consumer: one read-in of kSpreadRead trips of a ring
// row (float4 g holds trips 4g to 4g + 3), and its adds in trip order.
__device__ __forceinline__ void spread_read(float4 (&q)[kSpreadRead / 4], const float4* row4,
                                            int group) {
#pragma unroll
  for (int g = 0; g < kSpreadRead / 4; ++g) q[g] = row4[group * (kSpreadRead / 4) + g];
}

__device__ __forceinline__ float spread_chain(float acc, const float4 (&q)[kSpreadRead / 4]) {
#pragma unroll
  for (int g = 0; g < kSpreadRead / 4; ++g) {
    acc = __fadd_rn(acc, q[g].x);
    acc = __fadd_rn(acc, q[g].y);
    acc = __fadd_rn(acc, q[g].z);
    acc = __fadd_rn(acc, q[g].w);
  }
  return acc;
}

// vpu_dot_spread: vpu_dot's function, one copy over the card.
//
// Replaces dot_kernel (tools/micro_vpu.py:184-192, pallas_call :196) as
// vpu_dot does, bit for bit the same sums: every output is the chain
// acc = fadd(acc, d_i) over the trips in order from 0, and each d_i the
// chain d = fma(fl(a_k s_i), b_k, d) over k in order from 0.  What bounds
// it: vpu_dot runs a copy as one CTA of 64 threads (one SM of 132), 2.45 us
// a trip; the function's own floor is its chain of 8192 dependent FADDs an
// output (~4 cycles each, 0.017 ms), about its flop bound.  But the d_i are
// independent across trips, and only the adds into acc are ordered.  So a
// CTA takes one row m and 4 columns for all trips (128 CTAs a copy, one an
// SM): 11 producer warps compute the d of a tile of 1056 trips at once, a
// thread 3 trips (each broadcast float4 read of b's 4 columns, k-major in
// shared memory, feeds 12 FFMAs and 3 scale FMULs; the row of a in
// registers, loaded once), into a ring of 2 slots; one consumer warp's
// lanes 0-3 run the 4 chains over the tile in trip order, reading ahead,
// while the producers fill the next.  Full and empty mbarriers order the
// handoff (the arrive releases the stores before it, the wait acquires
// them).  A trip costs the producers 21.3 warp instructions, 5.8 cycles of
// the busiest of an SM's 4 schedulers (3 producer warps each; the
// consumer's holds 2), and the chain ~4.4 cycles, so the producers bound the
// kernel: they issue at ~3/4 of that, ~7.7 cycles a trip, held back by the
// latencies that 3 warps a scheduler do not hide; more warps a scheduler
// slow the consumer's chain, which shares one (`micro_vpu --sweep` reads
// the producers alone and the chain alone, MICRO_VPU_SPREAD_PART 1 and 2,
// and other warps, trips and slots).  The scale stays in every trip's
// products (no (sum s_i) a b^T): that work is what the probe measures.
__global__ void __launch_bounds__(kSpreadThreads, 1)
    vpu_dot_spread_kernel(const float* __restrict__ a, const float* __restrict__ b, int niter,
                          float* __restrict__ out) {
  __shared__ __align__(16) float4 sb[kDotK];  // b's kSpreadCols columns at k
  __shared__ __align__(16) float ring[kSpreadSlots][kSpreadCols][kSpreadStride];
  __shared__ __align__(8) uint64_t full[kSpreadSlots], empty[kSpreadSlots];
  const int m = blockIdx.x / kSpreadColGroups;
  const int n0 = (blockIdx.x % kSpreadColGroups) * kSpreadCols;
  const int t = threadIdx.x;
  if (t < kDotK) {
    sb[t] = make_float4(b[n0 * kDotK + t], b[(n0 + 1) * kDotK + t], b[(n0 + 2) * kDotK + t],
                        b[(n0 + 3) * kDotK + t]);
  }
  if (t == 0) {
    for (int s = 0; s < kSpreadSlots; ++s) {
      mbar_init(smem_u32(&full[s]), kSpreadProducers);
      mbar_init(smem_u32(&empty[s]), kSpreadCols);
    }
  }
  __syncthreads();
  const int ntiles = (niter + kSpreadTile - 1) / kSpreadTile;
  if (t < kSpreadProducers) {
    float4 ar[kDotK / 4];
#pragma unroll
    for (int q = 0; q < kDotK / 4; ++q) ar[q] = reinterpret_cast<const float4*>(a)[m * 32 + q];
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      // a compiler fence: each tile reads b from shared memory (hoisted, the
      // 512 floats of b's columns would not fit in registers)
      asm volatile("" ::: "memory");
      const int slot = tile % kSpreadSlots, use = tile / kSpreadSlots;
      // thread t's trips: positions t + h kSpreadProducers of the tile, h <
      // kSpreadTrips; a trip past niter is computed and stored but never read
      float s[kSpreadTrips], d[kSpreadTrips][kSpreadCols];
#pragma unroll
      for (int h = 0; h < kSpreadTrips; ++h) {
        s[h] = trip_scale(tile * kSpreadTile + h * kSpreadProducers + t);
#pragma unroll
        for (int c = 0; c < kSpreadCols; ++c) d[h][c] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < (kSpreadPart == 2 ? 0 : kDotK / 4); ++q) {
        const float ak[4] = {ar[q].x, ar[q].y, ar[q].z, ar[q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 bk = sb[4 * q + e];
#pragma unroll
          for (int h = 0; h < kSpreadTrips; ++h) {
            const float as = __fmul_rn(ak[e], s[h]);
            d[h][0] = fmaf(as, bk.x, d[h][0]);
            d[h][1] = fmaf(as, bk.y, d[h][1]);
            d[h][2] = fmaf(as, bk.z, d[h][2]);
            d[h][3] = fmaf(as, bk.w, d[h][3]);
          }
        }
      }
      // the slot is free once the consumer has read its previous tile (the
      // first use passes at once: the parity of the phase before phase 0)
      mbar_wait_or_trap(smem_u32(&empty[slot]), (use & 1) ^ 1);
#pragma unroll
      for (int h = 0; h < kSpreadTrips; ++h) {
#pragma unroll
        for (int c = 0; c < kSpreadCols; ++c) ring[slot][c][h * kSpreadProducers + t] = d[h][c];
      }
      mbar_arrive(smem_u32(&full[slot]));
    }
  } else if (t < kSpreadProducers + kSpreadCols) {
    const int c = t - kSpreadProducers;
    float acc = 0.0f;
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      const int slot = tile % kSpreadSlots, use = tile / kSpreadSlots;
      const int count = min(kSpreadTile, niter - tile * kSpreadTile);
      mbar_wait_or_trap(smem_u32(&full[slot]), use & 1);
      const float* row = ring[slot][c];
      const float4* row4 = reinterpret_cast<const float4*>(row);
      // read-ins of kSpreadRead trips in two buffers: one is read while the
      // other's adds wait on each other (a read past the tile's count stays
      // in the row's padding and is never added)
      const int groups = kSpreadPart == 1 ? 0 : count / kSpreadRead;
      float4 qa[kSpreadRead / 4], qb[kSpreadRead / 4];
      spread_read(qa, row4, 0);
      int gi = 0;
#pragma unroll 1
      for (; gi + 1 < groups; gi += 2) {
        spread_read(qb, row4, gi + 1);
        acc = spread_chain(acc, qa);
        spread_read(qa, row4, gi + 2);
        acc = spread_chain(acc, qb);
      }
      if (gi < groups) acc = spread_chain(acc, qa);
#pragma unroll 1
      for (int j = groups * kSpreadRead; j < (kSpreadPart == 1 ? 1 : count); ++j) {
        acc = __fadd_rn(acc, row[j]);
      }
      mbar_arrive(smem_u32(&empty[slot]));
    }
    out[(blockIdx.y * kDotM + m) * kDotN + n0 + c] = acc;
  }
}

// vpu_tr_split: tr's function, sum_i v_j s_i, in a fixed other order.
//
// Replaces tr_kernel (tools/micro_vpu.py:233-237, pallas_call :240) beside
// vpu_tr.  What bounds it: the function is 0.5 M FFMAs, 16 ns of issue, far
// under a launch; vpu_tr's one chain of 8192 dependent FFMAs a row (each
// trip's scale, I2F + FMUL + FADD, in the same unroll-1 loop) takes 0.127
// ms, and even at FFMA latency the chain is 0.017 ms, over torch.mv's
// 0.007: no order-keeping design beats the call.  So each row's trips go to
// `parts` contiguous parts of len = ceil(niter / parts) trips (the last may
// be short or empty), a thread a (row, part) runs acc = fma(v, s_i, acc)
// from 0 in trip order, its loop unrolled so the next trips' scales are
// computed off the chain, and the parts' partials meet in a fixed tree:
// x[p] += x[p + w] for w = parts / 2, ..., 1 (shared memory while w >= 32,
// then shuffles), no atomics, so the sum is deterministic.  At 64 parts the
// chain is 128 FFMAs and the kernel is launch bound.
__global__ void __launch_bounds__(kTrSplitThreads)
    vpu_tr_split_kernel(const float* __restrict__ x, int niter, int parts, int len,
                        float* __restrict__ out) {
  __shared__ float part_sum[kTrSplitThreads];
  const int t = threadIdx.x, g = blockIdx.x * blockDim.x + t;
  const int j = g / parts, p = g % parts;
  const float v = x[j];
  const int lo = min(p * len, niter), hi = min(lo + len, niter);
  float acc = 0.0f;
#pragma unroll kTrSplitUnroll
  for (int i = lo; i < hi; ++i) acc = fmaf(v, trip_scale(i), acc);
  for (int w = parts / 2; w >= 32; w /= 2) {
    part_sum[t] = acc;
    __syncthreads();
    if (p < w) acc = __fadd_rn(acc, part_sum[t + w]);
    __syncthreads();
  }
  for (int w = min(parts / 2, 16); w >= 1; w /= 2) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, w));
  }
  if (p == 0) out[blockIdx.y * kTrRows + j] = acc;
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

// a (64, 128), b (8, 128); out (ncopies, 64, 8); ncopies <= 65535.
int vpu_dot_spread(const void* a, const void* b, int niter, int ncopies, void* out,
                   void* stream) {
  if (niter < 0 || ncopies <= 0 || ncopies > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(kDotM * kSpreadColGroups, ncopies);
  vpu_dot_spread_kernel<<<grid, kSpreadThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, niter, (float*)out);
  return (int)cudaGetLastError();
}

// x (8, 128) (its first 64 floats are read); parts a power of two, 1 to 256;
// out (ncopies, 64, 1); ncopies <= 65535.
int vpu_tr_split(const void* x, int niter, int parts, int ncopies, void* out, void* stream) {
  if (niter < 0 || parts < 1 || parts > kTrSplitMaxParts || (parts & (parts - 1)) ||
      ncopies <= 0 || ncopies > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = kTrRows * parts < kTrSplitThreads ? kTrRows * parts : kTrSplitThreads;
  const dim3 grid(kTrRows * parts / threads, ncopies);
  vpu_tr_split_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, niter, parts, (niter + parts - 1) / parts, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
