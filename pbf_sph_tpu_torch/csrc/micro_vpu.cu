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
// and three redesigns of the same TPU kernels for this card, beside them:
//   vpu_dot_spread <- dot_kernel: vpu_dot's function bit for bit, one copy
//                  spread over 128 CTAs (see its note below);
//   vpu_dot2_spread <- dot2_kernel: vpu_dot2's function bit for bit, one copy
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
// vpu_dot2_spread: CTA (blockIdx.x, blockIdx.y) = (a block of kSpread2Rows
// rows x kSpread2Width columns of the output, copy), 128 CTAs a copy.
// Producer warp p of kSpread2Producers takes the block's 8 outputs 8 (p mod
// 8) to 8 (p mod 8) + 7 (kSpread2Cols, of one row: its row of a and its
// columns of b in registers, loaded once) and part p / 8 of each tile's
// trips: lane l trips 4 l to 4 l + 3 of each 128 of its part,
// kSpread2Trips in all, a float4 store an output and 4 trips into one of
// kSpread2Slots ring slots.  The consumers add the block's 64 chains in
// trip order, kSpread2Chains a lane (1: warps 0 and 4, 2: warp 0), a
// read-in of kSpread2Read trips at a time, on the SM's first scheduler
// (warp w runs on scheduler w mod 4), which holds kSpread2Share producer
// warps beside them; the other producers fill the other three schedulers'
// warps in order, and warps left over idle.  A ring row (an output's tile)
// is padded as vpu_dot_spread's: by a read-in and 4 floats.
#ifndef MICRO_VPU_SPREAD2_ROWS
#define MICRO_VPU_SPREAD2_ROWS 1
#endif
#ifndef MICRO_VPU_SPREAD2_WARPS
#define MICRO_VPU_SPREAD2_WARPS 8
#endif
#ifndef MICRO_VPU_SPREAD2_TRIPS
#define MICRO_VPU_SPREAD2_TRIPS 8
#endif
#ifndef MICRO_VPU_SPREAD2_SLOTS
#define MICRO_VPU_SPREAD2_SLOTS 2
#endif
#ifndef MICRO_VPU_SPREAD2_CHAINS
#define MICRO_VPU_SPREAD2_CHAINS 1
#endif
#ifndef MICRO_VPU_SPREAD2_SHARE
#define MICRO_VPU_SPREAD2_SHARE 0
#endif
// as MICRO_VPU_SPREAD_PART: 0 all of it; 1 the producers; 2 the chain
#ifndef MICRO_VPU_SPREAD2_PART
#define MICRO_VPU_SPREAD2_PART 0
#endif
constexpr int kSpread2Outputs = 64, kSpread2Cols = 8, kSpread2Read = 32;
constexpr int kSpread2Rows = MICRO_VPU_SPREAD2_ROWS;
constexpr int kSpread2Width = kSpread2Outputs / kSpread2Rows;
constexpr int kSpread2ColBlocks = kDot2N / kSpread2Width;
constexpr int kSpread2Ctas = kDot2M * kDot2N / kSpread2Outputs;
constexpr int kSpread2Groups = kSpread2Outputs / kSpread2Cols;
constexpr int kSpread2Producers = MICRO_VPU_SPREAD2_WARPS;  // warps
constexpr int kSpread2Trips = MICRO_VPU_SPREAD2_TRIPS;
constexpr int kSpread2Chains = MICRO_VPU_SPREAD2_CHAINS;
constexpr int kSpread2Consumers = kSpread2Outputs / kSpread2Chains;  // threads
constexpr int kSpread2Share = MICRO_VPU_SPREAD2_SHARE;
constexpr int kSpread2Block = 32 * 4;  // a warp's 4 trips a lane
constexpr int kSpread2Tile = kSpread2Producers / kSpread2Groups * 32 * kSpread2Trips;
constexpr int kSpread2Slots = MICRO_VPU_SPREAD2_SLOTS, kSpread2Part = MICRO_VPU_SPREAD2_PART;
constexpr int kSpread2Stride = kSpread2Tile + kSpread2Read + 4;
constexpr size_t kSpread2Smem =
    sizeof(float) * (size_t)kSpread2Slots * kSpread2Outputs * kSpread2Stride;

// The producer warp that warp w = 4 r + q of a vpu_dot2_spread CTA is, or
// -1: on scheduler 0 (q = 0) the consumer warps come first, then
// kSpread2Share producers; on the others the rest of the producers, in
// rows r below the share each needs.
__host__ __device__ constexpr int spread2_producer(int w) {
  constexpr int kConsumerWarps = kSpread2Consumers / 32;
  constexpr int kRows = (kSpread2Producers - kSpread2Share + 2) / 3;
  int p = 0;
  for (int v = 0; v <= w; ++v) {
    const int r = v / 4;
    const bool producer =
        v % 4 ? r < kRows : r >= kConsumerWarps && r < kConsumerWarps + kSpread2Share;
    if (v == w) return producer && p < kSpread2Producers ? p : -1;
    p += producer;
  }
  return -1;
}

// The CTA's warps: up to the last producer's.
__host__ __device__ constexpr int spread2_warps() {
  int w = 0;
  while (spread2_producer(w) != kSpread2Producers - 1) ++w;
  return w + 1;
}

constexpr int kSpread2Threads = 32 * spread2_warps();
static_assert(kSpread2Width % kSpread2Cols == 0 && kDot2N % kSpread2Width == 0,
              "a block's columns are whole groups of 8 and tile the output's");
static_assert(kSpread2Producers % kSpread2Groups == 0 && kSpread2Trips % 4 == 0,
              "every group has the same producer warps, each whole float4s of trips");
static_assert(kSpread2Chains == 1 || kSpread2Chains == 2, "64 chains in 1 or 2 warps");
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

// The ring of both spread kernels: the producers fill slot tile mod SLOTS
// with a tile of trips' d, the consumers add them in trip order.  A full and
// an empty mbarrier a slot order the handoff (an arrive releases the stores
// before it, a wait acquires them): the producers wait for a free slot,
// store and arrive on full; the consumers wait on full, read and arrive on
// empty.  Use u = tile / SLOTS of a slot waits for parity u & 1 on full and
// (u & 1) ^ 1 on empty, so each slot's first use passes at once.
template <int SLOTS>
struct RingBars {
  uint64_t full[SLOTS], empty[SLOTS];
};

template <int SLOTS>
__device__ __forceinline__ void ring_init(RingBars<SLOTS>& r, int producers, int consumers) {
  for (int s = 0; s < SLOTS; ++s) {
    mbar_init(smem_u32(&r.full[s]), producers);
    mbar_init(smem_u32(&r.empty[s]), consumers);
  }
}

template <int SLOTS>
__device__ __forceinline__ void ring_wait_free(RingBars<SLOTS>& r, int tile) {
  mbar_wait_or_trap(smem_u32(&r.empty[tile % SLOTS]), ((tile / SLOTS) & 1) ^ 1);
}

template <int SLOTS>
__device__ __forceinline__ void ring_filled(RingBars<SLOTS>& r, int tile) {
  mbar_arrive(smem_u32(&r.full[tile % SLOTS]));
}

template <int SLOTS>
__device__ __forceinline__ void ring_wait_full(RingBars<SLOTS>& r, int tile) {
  mbar_wait_or_trap(smem_u32(&r.full[tile % SLOTS]), (tile / SLOTS) & 1);
}

template <int SLOTS>
__device__ __forceinline__ void ring_drained(RingBars<SLOTS>& r, int tile) {
  mbar_arrive(smem_u32(&r.empty[tile % SLOTS]));
}

// A consumer's read-in of R trips of each of its NC ring rows (float4 g of
// group `group` holds trips 4g to 4g + 3 of it), and its adds in trip order,
// the NC chains interleaved trip by trip (each add waits only on its own
// chain).
template <int R, int NC>
__device__ __forceinline__ void spread_read(float4 (&q)[NC][R / 4],
                                            const float* const (&row)[NC], int group) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      q[c][g] = reinterpret_cast<const float4*>(row[c])[group * (R / 4) + g];
    }
  }
}

template <int R, int NC>
__device__ __forceinline__ void spread_chain(float (&acc)[NC], const float4 (&q)[NC][R / 4]) {
#pragma unroll
  for (int g = 0; g < R / 4; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], q[c][g].x);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], q[c][g].y);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], q[c][g].z);
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], q[c][g].w);
  }
}

// One tile's `count` trips of each row added to its chain in trip order:
// read-ins of R trips in two buffers, one read while the other's adds wait
// on each other, then the ragged rest a trip at a time (a read past the
// count stays in the row's padding and is never added).  ONE (a sweep build
// of the producers alone) adds the tile's first trip only.
template <int R, int NC, bool ONE>
__device__ __forceinline__ void spread_tile(float (&acc)[NC], const float* const (&row)[NC],
                                            int count) {
  const int groups = ONE ? 0 : count / R;
  float4 qa[NC][R / 4], qb[NC][R / 4];
  spread_read<R, NC>(qa, row, 0);
  int gi = 0;
#pragma unroll 1
  for (; gi + 1 < groups; gi += 2) {
    spread_read<R, NC>(qb, row, gi + 1);
    spread_chain<R, NC>(acc, qa);
    spread_read<R, NC>(qa, row, gi + 2);
    spread_chain<R, NC>(acc, qb);
  }
  if (gi < groups) spread_chain<R, NC>(acc, qa);
#pragma unroll 1
  for (int j = groups * R; j < (ONE ? 1 : count); ++j) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], row[c][j]);
  }
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
  __shared__ __align__(8) RingBars<kSpreadSlots> bars;
  const int m = blockIdx.x / kSpreadColGroups;
  const int n0 = (blockIdx.x % kSpreadColGroups) * kSpreadCols;
  const int t = threadIdx.x;
  if (t < kDotK) {
    sb[t] = make_float4(b[n0 * kDotK + t], b[(n0 + 1) * kDotK + t], b[(n0 + 2) * kDotK + t],
                        b[(n0 + 3) * kDotK + t]);
  }
  if (t == 0) ring_init(bars, kSpreadProducers, kSpreadCols);
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
      const int slot = tile % kSpreadSlots;
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
      ring_wait_free(bars, tile);
#pragma unroll
      for (int h = 0; h < kSpreadTrips; ++h) {
#pragma unroll
        for (int c = 0; c < kSpreadCols; ++c) ring[slot][c][h * kSpreadProducers + t] = d[h][c];
      }
      ring_filled(bars, tile);
    }
  } else if (t < kSpreadProducers + kSpreadCols) {
    const int c = t - kSpreadProducers;
    float acc[1] = {0.0f};
    const float* row[1];
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      ring_wait_full(bars, tile);
      row[0] = ring[tile % kSpreadSlots][c];
      spread_tile<kSpreadRead, 1, kSpreadPart == 1>(
          acc, row, min(kSpreadTile, niter - tile * kSpreadTile));
      ring_drained(bars, tile);
    }
    out[(blockIdx.y * kDotM + m) * kDotN + n0 + c] = acc[0];
  }
}

// vpu_dot2_spread: vpu_dot2's function, one copy over the card.
//
// Replaces dot2_kernel (tools/micro_vpu.py:210-215, pallas_call :219) as
// vpu_dot2 does, bit for bit the same sums: every output is the chain acc =
// fadd(acc, d_i) over the trips in order from 0, and each d_i the chain d =
// fma(fl(a_k s_i), b_k, d) over k = 0..7 in order from 0.  What bounds it:
// vpu_dot2 runs a copy as one CTA of 512 threads (one SM of 132), ~380 ns a
// trip; the function's floor is a chain of 8192 dependent FADDs an output
// (~4 cycles each, ~0.017 ms), about its flop bound, and it has 8192 such
// chains, 16x vpu_dot's, each d 16x cheaper (K = 8).  So, as vpu_dot_spread,
// a CTA takes 64 outputs (a block of rows x columns) for all trips: 8
// producer warps, each one row of a and 8 columns of b in registers,
// compute the d of 8 trips a lane (a trip: the row's 8 scale multiplies and
// 64 FFMAs; a float4 store an output and 4 trips) into a shared-memory ring
// of 2 tiles of 256 trips; two consumer warps run the 64 chains in trip
// order.  A trip costs an SM's producers ~620 lane-instructions, 4.8 cycles
// of its 4 schedulers, the ring 512 bytes of shared memory (4 cycles), and
// a chain ~4 cycles of FADD latency.  But a consumer that shares its
// scheduler with producer warps is starved of issue slots (the producers
// always have an FFMA ready): 8 producers spread 2 to a scheduler run alone
// at 0.032 ms, and the kernel at 0.049 with the consumers beside two of
// them.  So the consumers have the first scheduler to themselves and the
// producers run 3, 3 and 2 to the others: the kernel is the busiest
// scheduler's 3 producer warps, ~10 cycles a trip, 0.042 ms (micro_vpu
// --sweep on an H100 80GB HBM3 at 700 W; it builds the kernel at other
// block shapes, producer warps, trips, slots, chains a consumer lane and
// producers beside the consumers, and its producers and chain alone,
// -DMICRO_VPU_SPREAD2_*).  The scale stays in every trip's products, each
// trip computes its own d (no (sum s_i) a b, no d shared by trips of equal
// s_i, no tensor cores, which round s_i - 1 away): that work is what the
// probe measures.
__global__ void __launch_bounds__(kSpread2Threads, 1)
    vpu_dot2_spread_kernel(const float* __restrict__ a, const float* __restrict__ b, int niter,
                           float* __restrict__ out) {
  // kSpread2Slots x kSpread2Outputs ring rows of kSpread2Stride floats
  extern __shared__ __align__(16) float ring2[];
  __shared__ __align__(8) RingBars<kSpread2Slots> bars;
  const int m0 = blockIdx.x / kSpread2ColBlocks * kSpread2Rows;
  const int nb = blockIdx.x % kSpread2ColBlocks * kSpread2Width;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t == 0) ring_init(bars, 32 * kSpread2Producers, kSpread2Consumers);
  __syncthreads();
  const int ntiles = (niter + kSpread2Tile - 1) / kSpread2Tile;
  const int p = spread2_producer(warp);
  if (p >= 0) {
    // the warp's 8 outputs, o0 to o0 + 7 of the block (row o0 / width, its
    // columns from o0 mod width), and its lane's first position in a tile
    const int o0 = (p % kSpread2Groups) * kSpread2Cols;
    const int m = m0 + o0 / kSpread2Width, n0 = nb + o0 % kSpread2Width;
    const int first = (p / kSpread2Groups) * 32 * kSpread2Trips + 4 * lane;
    const float4* a4 = reinterpret_cast<const float4*>(a + m * kDot2K);
    const float4 alo = a4[0], ahi = a4[1];
    const float ar[kDot2K] = {alo.x, alo.y, alo.z, alo.w, ahi.x, ahi.y, ahi.z, ahi.w};
    float br[kDot2K][kSpread2Cols];
#pragma unroll
    for (int k = 0; k < kDot2K; ++k) {
      const float4* b4 = reinterpret_cast<const float4*>(b + k * kDot2N + n0);
      const float4 lo = b4[0], hi = b4[1];
      const float bk[kSpread2Cols] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int c = 0; c < kSpread2Cols; ++c) br[k][c] = bk[c];
    }
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      // trip h of the lane: position first + (h / 4) kSpread2Block + h mod 4
      // of the tile; a trip past niter is computed and stored but never read
      float s[kSpread2Trips], d[kSpread2Trips][kSpread2Cols];
#pragma unroll
      for (int h = 0; h < kSpread2Trips; ++h) {
        s[h] = trip_scale(tile * kSpread2Tile + first + (h / 4) * kSpread2Block + h % 4);
#pragma unroll
        for (int c = 0; c < kSpread2Cols; ++c) d[h][c] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < (kSpread2Part == 2 ? 0 : kDot2K); ++k) {
#pragma unroll
        for (int h = 0; h < kSpread2Trips; ++h) {
          const float as = __fmul_rn(ar[k], s[h]);
#pragma unroll
          for (int c = 0; c < kSpread2Cols; ++c) d[h][c] = fmaf(as, br[k][c], d[h][c]);
        }
      }
      ring_wait_free(bars, tile);
      float* slot = ring2 + (tile % kSpread2Slots) * kSpread2Outputs * kSpread2Stride;
#pragma unroll
      for (int c = 0; c < kSpread2Cols; ++c) {
#pragma unroll
        for (int j = 0; j < kSpread2Trips / 4; ++j) {
          *reinterpret_cast<float4*>(slot + (o0 + c) * kSpread2Stride + first +
                                     j * kSpread2Block) =
              make_float4(d[4 * j][c], d[4 * j + 1][c], d[4 * j + 2][c], d[4 * j + 3][c]);
        }
      }
      ring_filled(bars, tile);
    }
  } else if (warp % 4 == 0 && warp / 4 < kSpread2Consumers / 32) {
    // consumer thread ct: outputs ct + j kSpread2Consumers of the block
    const int ct = warp / 4 * 32 + lane;
    float acc[kSpread2Chains];
    const float* row[kSpread2Chains];
#pragma unroll
    for (int j = 0; j < kSpread2Chains; ++j) acc[j] = 0.0f;
#pragma unroll 1
    for (int tile = 0; tile < ntiles; ++tile) {
      ring_wait_full(bars, tile);
      const float* slot = ring2 + (tile % kSpread2Slots) * kSpread2Outputs * kSpread2Stride;
#pragma unroll
      for (int j = 0; j < kSpread2Chains; ++j) {
        row[j] = slot + (ct + j * kSpread2Consumers) * kSpread2Stride;
      }
      spread_tile<kSpread2Read, kSpread2Chains, kSpread2Part == 1>(
          acc, row, min(kSpread2Tile, niter - tile * kSpread2Tile));
      ring_drained(bars, tile);
    }
#pragma unroll
    for (int j = 0; j < kSpread2Chains; ++j) {
      const int o = ct + j * kSpread2Consumers;
      out[(blockIdx.y * kDot2M + m0 + o / kSpread2Width) * kDot2N + nb + o % kSpread2Width] =
          acc[j];
    }
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

// a (64, 8), b (8, 128); out (ncopies, 64, 128); ncopies <= 65535.
int vpu_dot2_spread(const void* a, const void* b, int niter, int ncopies, void* out,
                    void* stream) {
  if (niter < 0 || ncopies <= 0 || ncopies > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      vpu_dot2_spread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSpread2Smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kSpread2Ctas, ncopies);
  vpu_dot2_spread_kernel<<<grid, kSpread2Threads, kSpread2Smem, (cudaStream_t)stream>>>(
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
