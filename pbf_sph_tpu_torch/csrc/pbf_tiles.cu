// Tiled lambda and delta on cell-sorted particles (sm_90a).
//
// Replaces the `sub`/`mxu` variants of the Pallas TPU kernels in
// pbf_sph_tpu/ops/pallas_pbf.py:
//   pbf_lambda_tile <- make_lambda_call(sub, mxu)  (:391; mxu=True r2 by
//                      _centred_r2_mxu, :351-388)
//   pbf_delta_tile  <- make_delta_call(sub, mxu)   (:491)
// and their redesigns pbf_lambda_tile_cull / pbf_delta_tile_cull (below),
// which skip the 8 x 8 row-candidate blocks that cannot contribute and
// give the same values on every member row, bit for bit.  They compute what
// the plain versions of pbf_sph_tpu_torch/ops/tiles.py compute; the fluid
// mask and the bounds clamp stay in the Python wrappers.
//
// Design (the dense kernels): one CTA of four warps per tile of SUB
// consecutive sorted rows.  The tile's nine disjoint windows (ops/tiles.py
// plan_tiles) are read as one sequence of candidates and staged in shared
// memory kChunk columns at a time, as many chunks as the windows hold: no
// capacity, no overflow.  Past
// the last candidate a slot holds a point 1e9 away, which every geometric
// mask zeroes.  The tile's SUB x kChunk pair block is cut into 8 x 8 blocks:
// lane (g, t) of a warp, g = lane / 4, t = lane % 4, owns pair (row g,
// candidates 2t and 2t+1) of each block, which is the accumulator layout of
// mma.sync m8n8k4.  Warps split the column blocks; each lane keeps the sums of
// its SUB / 8 rows in registers, the four lanes of a row add theirs by quad
// shuffles, and the warps theirs through shared memory in a fixed order.
//
// r2 routes.  MXU=false: per pair in fp32, (dx*dx + dy*dy) + dz*dz as two
// FMAs.  MXU=true: the centred product of _centred_r2_mxu on the tensor
// cores.  Rows and candidates are translated to the tile's centre (the fp32
// mean of all SUB rows, summed in fp64 and rounded once), and the 8 x 8 block
//   [ax, ay, az, 1] . [-2bx, -2by, -2bz, |b|^2] + |a|^2
// is one mma.sync.aligned.m8n8k4 in FP64 per block, plus |a|^2 added to the
// accumulator; the gradient takes the centred fp32 differences ax - bx.
// Why FP64 and not 3xTF32: 3xTF32 keeps ~21 bits of each product.  A tile
// that straddles a z-column wrap holds rows a whole column apart (|a| ~ 4
// sim units at dam1m), so its products reach ~16 and a 2^-21 error is
// ~1e-5 in r2, against h^2 = 1e-2: lambda's tolerance fails near r = h.
// FP64 products of fp32 inputs are exact and the K = 4 sum rounds at 2^-53,
// so the route's r2 is the exact centred r2 rounded once to fp32, and the
// plain version (fp64 in PyTorch) gives the same value.
//
// What bounds it: the pair math.  A tile evaluates every row against the
// union of its rows' windows, 1.24x (SUB 8) to 4.2x (SUB 64) the per-row
// pairs at dam1m, at ~22-34 fp32 operations a pair; the shared-memory
// staging makes each candidate one device read per tile instead of one per
// row.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a SUB that is not instantiated (8, 16, 32, 64).

#include <cuda_runtime.h>

#include "cull.cuh"
#include "dmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;  // candidate columns staged per pass
constexpr float kFar = 1e9f;

// The pair math of pbf_phases.cu's lambda_kernel; w of a row is its mass.
// Every rounding is pinned with the _rn intrinsics in the FMA forms nvcc
// contracts this math to, so the dense and the cull kernels, which inline
// it in different loops, give the same bits (the compiler neither contracts
// nor reassociates an intrinsic).
struct LambdaPair {
  static constexpr int kAcc = 4;  // poly6 sum, gradient x, y, z
  float h, hh, eps2, p6f, c_grad, rho_recip, cfm;

  __device__ __forceinline__ void add(float, float, float dx, float dy,
                                      float dz, float r2, float* acc) const {
    const float d2p = fmaxf(__fsub_rn(hh, r2), 0.f);
    acc[0] = __fmaf_rn(__fmul_rn(d2p, d2p), d2p, acc[0]);
    const float r2c = fmaxf(r2, eps2);
    const float u = rsqrtf(r2c);
    const float tt = fmaxf(__fmaf_rn(-r2c, u, h), 0.f);
    const float sg = __fmul_rn(__fmul_rn(tt, tt), u);
    acc[1] = __fmaf_rn(dx, sg, acc[1]);
    acc[2] = __fmaf_rn(dy, sg, acc[2]);
    acc[3] = __fmaf_rn(dz, sg, acc[3]);
  }

  __device__ __forceinline__ void store(int i, int, bool member, float mass,
                                        const float* s, float* out) const {
    if (!member) {  // memberf = 0: lambda = 1 / CFM
      out[i] = -(0.0f * rho_recip - 1.0f) / (0.0f + cfm);
      return;
    }
    const float rho = __fmul_rn(mass, __fmul_rn(s[0], p6f));
    const float gx = __fmul_rn(s[1], c_grad), gy = __fmul_rn(s[2], c_grad),
                gz = __fmul_rn(s[3], c_grad);
    const float norm2 = __fmaf_rn(gz, gz, __fmaf_rn(gy, gy, __fmul_rn(gx, gx)));
    out[i] = -__fmaf_rn(rho, rho_recip, -1.0f) / __fadd_rn(norm2, cfm);
  }
};

// The pair math of pbf_phases.cu's delta_kernel; w is lambda.  Pinned as
// LambdaPair.
struct DeltaPair {
  static constexpr int kAcc = 3;  // correction x, y, z
  float h, hh, eps2, skf, xqf, corr_k, rho_recip;

  __device__ __forceinline__ void add(float alam, float blam, float dx,
                                      float dy, float dz, float r2,
                                      float* acc) const {
    const float d2p = fmaxf(__fsub_rn(hh, r2), 0.f);
    const float xq = __fmul_rn(__fmul_rn(__fmul_rn(d2p, d2p), d2p), xqf);
    const float x2 = __fmul_rn(xq, xq);
    const float corr = __fmul_rn(__fmul_rn(corr_k, x2), x2);
    const float factor = __fmul_rn(__fadd_rn(__fadd_rn(alam, blam), corr), rho_recip);
    const float r2c = fmaxf(r2, eps2);
    const float u = rsqrtf(r2c);
    const float tt = fmaxf(__fmaf_rn(-r2c, u, h), 0.f);
    const float sg = __fmul_rn(__fmul_rn(__fmul_rn(skf, __fmul_rn(tt, tt)), u), factor);
    acc[0] = __fmaf_rn(dx, sg, acc[0]);
    acc[1] = __fmaf_rn(dy, sg, acc[1]);
    acc[2] = __fmaf_rn(dz, sg, acc[2]);
  }

  __device__ __forceinline__ void store(int i, int n, bool member, float,
                                        const float* s, float* out) const {
    out[i] = member ? s[0] : 0.f;
    out[n + i] = member ? s[1] : 0.f;
    out[2 * n + i] = member ? s[2] : 0.f;
  }
};

// The fp32 route's r2 of a pair, pinned as the pair math.
__device__ __forceinline__ float pair_r2(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

template <int SUB, bool MXU, class Pair>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const float4* __restrict__ cand,  // x, y, z, w
                const int* __restrict__ key, const int* __restrict__ tiles,
                int n, int ncells, Pair pair, float* __restrict__ out) {
  constexpr int kBlocks = SUB / 8;  // 8-row blocks of the tile
  constexpr int K = Pair::kAcc;
  __shared__ float4 rows[SUB];
  __shared__ float4 cbuf[kChunk];
  __shared__ double bmat[4][kChunk];  // MXU: -2bx, -2by, -2bz, |b|^2
  __shared__ float red[kWarps][SUB][K];
  __shared__ int wlo[9], woff[10];
  __shared__ float centre[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * SUB;
  const int* win = tiles + blockIdx.x * 18;

  if (tid < SUB) rows[tid] = cand[row0 + tid];
  if (tid < 9) wlo[tid] = win[2 * tid];
  __syncthreads();
  if (tid == 0) {
    int off = 0;
    for (int s = 0; s < 9; ++s) {
      woff[s] = off;
      off += win[2 * s + 1] - wlo[s];
    }
    woff[9] = off;
  }
  if (MXU && tid < 3) {
    double sum = 0.0;
    for (int r = 0; r < SUB; ++r) {
      const float4 p = rows[r];
      sum += tid == 0 ? p.x : (tid == 1 ? p.y : p.z);
    }
    centre[tid] = __double2float_rn(sum / SUB);
  }
  __syncthreads();

  const float cx = MXU ? centre[0] : 0.f;
  const float cy = MXU ? centre[1] : 0.f;
  const float cz = MXU ? centre[2] : 0.f;
  float ax[kBlocks], ay[kBlocks], az[kBlocks], aw[kBlocks];
  double afrag[kBlocks], a2[kBlocks];
  float acc[kBlocks][K];
#pragma unroll
  for (int rb = 0; rb < kBlocks; ++rb) {
    const float4 p = rows[rb * 8 + g];
    ax[rb] = p.x - cx;
    ay[rb] = p.y - cy;
    az[rb] = p.z - cz;
    aw[rb] = p.w;
    if (MXU) {
      const double x = ax[rb], y = ay[rb], z = az[rb];
      a2[rb] = x * x + y * y + z * z;
      afrag[rb] = t == 0 ? x : (t == 1 ? y : (t == 2 ? z : 1.0));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc[rb][k] = 0.f;
  }

  const int total = woff[9];
  for (int base = 0; base < total; base += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    if (tid < kChunk) {
      const int v = base + tid;
      float4 b = make_float4(kFar, kFar, kFar, 0.f);
      if (v < total) {
        int s = 0;
        while (v >= woff[s + 1]) ++s;
        b = cand[wlo[s] + v - woff[s]];
      }
      b.x -= cx;
      b.y -= cy;
      b.z -= cz;
      cbuf[tid] = b;
      if (MXU) {
        const double x = b.x, y = b.y, z = b.z;
        bmat[0][tid] = -2.0 * x;
        bmat[1][tid] = -2.0 * y;
        bmat[2][tid] = -2.0 * z;
        bmat[3][tid] = x * x + y * y + z * z;
      }
    }
    __syncthreads();
    const int ncol = min(kChunk, total - base);
    for (int cb = warp; cb * 8 < ncol; cb += kWarps) {  // warp-uniform
      const float4 b0 = cbuf[cb * 8 + 2 * t];
      const float4 b1 = cbuf[cb * 8 + 2 * t + 1];
      const double bf = MXU ? bmat[t][cb * 8 + g] : 0.0;
#pragma unroll
      for (int rb = 0; rb < kBlocks; ++rb) {
        const float dx0 = __fsub_rn(ax[rb], b0.x), dy0 = __fsub_rn(ay[rb], b0.y),
                    dz0 = __fsub_rn(az[rb], b0.z);
        const float dx1 = __fsub_rn(ax[rb], b1.x), dy1 = __fsub_rn(ay[rb], b1.y),
                    dz1 = __fsub_rn(az[rb], b1.z);
        float r20, r21;
        if (MXU) {
          double d0, d1;
          dmma_m8n8k4(afrag[rb], bf, d0, d1);
          r20 = __double2float_rn(d0 + a2[rb]);
          r21 = __double2float_rn(d1 + a2[rb]);
        } else {
          r20 = pair_r2(dx0, dy0, dz0);
          r21 = pair_r2(dx1, dy1, dz1);
        }
        pair.add(aw[rb], b0.w, dx0, dy0, dz0, r20, acc[rb]);
        pair.add(aw[rb], b1.w, dx1, dy1, dz1, r21, acc[rb]);
      }
    }
  }

#pragma unroll
  for (int rb = 0; rb < kBlocks; ++rb) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = acc[rb][k];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[warp][rb * 8 + g][k] = v;
    }
  }
  __syncthreads();
  if (tid < SUB) {
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = red[0][tid][k];
      for (int w = 1; w < kWarps; ++w) s[k] += red[w][tid][k];
    }
    const int i = row0 + tid;
    pair.store(i, n, key[i] < ncells, rows[tid].w, s, out);
  }
}

// ---------------------------------------------------------------------------
// pbf_lambda_tile_cull / pbf_delta_tile_cull: the tile kernels over the 8 x 8
// row-candidate blocks that can contribute.
//
// The dense kernel above runs every row of a tile against every candidate of
// its union windows, 1.24x (SUB 8) to 4.20x (SUB 64) the per-row pairs at
// dam1m, where 0.158x lie within h.  These kernels give the same raw lambda
// and delta on every member row, bit for bit, by skipping only blocks whose
// terms are all +-0, and summing the rest as the dense kernel does: column
// block j of the tile's candidate sequence goes to warp j % 4, lane (g, t)
// takes row g of each row block against columns 2t and 2t + 1, each
// accumulator sees its nonzero terms in the dense kernel's order, and the
// quad shuffles and the warps' sum are the dense kernel's (the pair math is
// pinned, so both inline it alike).  A lane keeps the sums of all SUB / 8
// row blocks in registers and reads a row block's coordinates from shared
// memory when it walks it, so SUB 64 holds no row in registers.
//
// Per CTA (one tile):
//   1. the rows, centred (MXU), in shared memory, with |a|^2 (MXU) and the
//      box of each 8-row block's member rows (a block with none is empty);
//   2. the candidate sequence in stages of kStage columns, one a thread: a
//      16-byte cp.async each into one of two shared buffers, the next stage
//      in flight while one is walked.  A column's window is the count of
//      window starts at or below it (8 compares, no loop);
//   3. per stage, each thread centres its column in place (and writes its
//      fp64 B row, MXU), the 8 lanes of a column block reduce its box over
//      its real columns (columns past the sequence hold a point 1e9 away and
//      drop out), and lane j of them tests row block j: keep[cb] bit rb is
//      set when test_r2 of the boxes' gap is below hh_keep;
//   4. the walk: a warp skips, warp-uniform, a column block with no bit and,
//      within one, each row block whose bit is clear: its mma.sync (MXU)
//      and its pair chain.  On the MXU route the boxes are taken over the
//      centred fp32 coordinates that the chain subtracts.
//
// Why a skipped pair's terms are zero.  hh_keep = hh (1 + 2^-19) rounded up
// (ops/phases.py keep_hh); u = 2^-24.  Each rounded difference of the gap is
// at most the pair's own rounded |a - b| (a, b the coordinates the chain
// subtracts), and test_r2 is monotone, so every pair of a skipped block has
// T = test_r2(fl(a - b)) >= hh_keep.  T is at most 5 roundings above E =
// |a - b|^2, the exact squared distance of the fp32 coordinates, so E >=
// hh (1 + 32u)(1 - 5u) >= hh (1 + 26u).
//   fp32 route: the chain's r2 is an FMA chain over the rounded
//   differences, at most 5 roundings below E: r2 >= hh (1 + 20u).
//   MXU route: the chain's r2 is |a|^2 + |b|^2 - 2 a.b in fp64 (exact
//   products; the sums' error below 2^-50 (|a|^2 + |b|^2)), rounded once to
//   fp32: r2 >= hh (1 + 20u) while |a|, |b| < 2^13 h, i.e. while a tile and
//   its windows lie within 8192 cells of the tile's centre (the dam1m grid
//   is 88 cells a side).
// So hh - r2 < 0 and the poly6 factor is 0.  rsqrtf is within 2 ulp (4u),
// the FMA takes the exact product: r2 * rsqrtf(r2) >= sqrt(hh) (1 + 6u) >
// h, as hh = f32(h h) >= h^2 (1 - u); the spiky factor max(h - r2 u, 0) is
// 0, and with it every gradient and delta term (lambda is finite).  Adding
// +-0 to a sum that starts at +0 changes no bit, so PR 24's margin holds on
// both routes.
//
// Bound: the pair chain over the kept blocks (1.24x the per-row pairs at
// SUB 8, 1.66x at SUB 64 at dam1m's sort-time state, by the plain mirror
// ops/tiles.py tile_keep_plain), plus a stage's staging and box tests.

constexpr int kStage = kThreads;  // candidate columns a stage: one a thread
constexpr unsigned kFull = 0xffffffffu;

// The box of the 8 lanes' points (an 8-lane group of the warp), on all 8.
__device__ __forceinline__ Box box8(Box b) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    b.lx = fminf(b.lx, __shfl_xor_sync(kFull, b.lx, o));
    b.ly = fminf(b.ly, __shfl_xor_sync(kFull, b.ly, o));
    b.lz = fminf(b.lz, __shfl_xor_sync(kFull, b.lz, o));
    b.hx = fmaxf(b.hx, __shfl_xor_sync(kFull, b.hx, o));
    b.hy = fmaxf(b.hy, __shfl_xor_sync(kFull, b.hy, o));
    b.hz = fmaxf(b.hz, __shfl_xor_sync(kFull, b.hz, o));
  }
  return b;
}

__device__ __forceinline__ Box point_box(float4 p, bool in) {
  const float inf = __int_as_float(0x7f800000);
  return in ? Box{p.x, p.y, p.z, p.x, p.y, p.z} : Box{inf, inf, inf, -inf, -inf, -inf};
}

template <int SUB, bool MXU, class Pair>
__global__ void __launch_bounds__(kThreads)
    tile_cull_kernel(const float4* __restrict__ cand,  // x, y, z, w
                     const int* __restrict__ key, const int* __restrict__ tiles,
                     int n, int ncells, float hh_keep, Pair pair,
                     float* __restrict__ out) {
  constexpr int kBlocks = SUB / 8;
  constexpr int K = Pair::kAcc;
  __shared__ __align__(16) float4 buf[2][kStage];  // candidates, centred in place
  __shared__ double bmat[MXU ? 4 : 1][kStage];      // MXU: -2bx, -2by, -2bz, |b|^2
  __shared__ unsigned char keep[kStage / 8];        // bit rb: block (rb, cb) kept
  __shared__ float4 rows[SUB];                      // centred x, y, z; w
  __shared__ double rowa2[MXU ? SUB : 1];           // MXU: |a|^2
  __shared__ Box rbox[kBlocks];                     // member rows of a row block
  __shared__ float red[kWarps][SUB][K];
  __shared__ int wlo[9], woff[10];
  __shared__ float centre[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * SUB;
  const int* win = tiles + blockIdx.x * 18;

  if (tid < SUB) rows[tid] = cand[row0 + tid];
  if (tid < 9) wlo[tid] = win[2 * tid];
  __syncthreads();
  if (tid == 0) {
    int off = 0;
    for (int s = 0; s < 9; ++s) {
      woff[s] = off;
      off += win[2 * s + 1] - wlo[s];
    }
    woff[9] = off;
  }
  if (MXU && tid < 3) {
    double sum = 0.0;
    for (int r = 0; r < SUB; ++r) {
      const float4 p = rows[r];
      sum += tid == 0 ? p.x : (tid == 1 ? p.y : p.z);
    }
    centre[tid] = __double2float_rn(sum / SUB);
  }
  __syncthreads();

  const float cx = MXU ? centre[0] : 0.f;
  const float cy = MXU ? centre[1] : 0.f;
  const float cz = MXU ? centre[2] : 0.f;
  if (warp * 32 < SUB) {  // whole warps, for the shuffles
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < SUB) {
      p = rows[tid];
      p.x -= cx;
      p.y -= cy;
      p.z -= cz;
      rows[tid] = p;
      if (MXU) {
        const double x = p.x, y = p.y, z = p.z;
        rowa2[tid] = x * x + y * y + z * z;
      }
    }
    const Box b = box8(point_box(p, tid < SUB && key[row0 + tid] < ncells));
    if (tid < SUB && (lane & 7) == 0) rbox[tid >> 3] = b;
  }

  float acc[kBlocks][K];
#pragma unroll
  for (int rb = 0; rb < kBlocks; ++rb) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[rb][k] = 0.f;
  }

  const int total = woff[9];
  const int nst = (total + kStage - 1) / kStage;
  // stage s of the candidate sequence into buf[s & 1] (no wait)
  auto stage = [&](int s) {
    const int v = s * kStage + tid;
    if (v < total) {
      int w = 0;
#pragma unroll
      for (int j = 1; j < 9; ++j) w += v >= woff[j];
      cp_async16(&buf[s & 1][tid], cand + (wlo[w] + v - woff[w]));
    }
    cp_async_commit();
  };
  if (nst > 0) stage(0);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s landed; stage s - 1 walked
    if (s + 1 < nst) stage(s + 1);
    float4* cur = buf[s & 1];
    {
      const bool real = s * kStage + tid < total;
      float4 b = real ? cur[tid] : make_float4(kFar, kFar, kFar, 0.f);
      b.x -= cx;
      b.y -= cy;
      b.z -= cz;
      cur[tid] = b;
      if (MXU) {
        const double x = b.x, y = b.y, z = b.z;
        bmat[0][tid] = -2.0 * x;
        bmat[1][tid] = -2.0 * y;
        bmat[2][tid] = -2.0 * z;
        bmat[3][tid] = x * x + y * y + z * z;
      }
      const Box cbox = box8(point_box(b, real));
      const int j = lane & 7;  // this lane tests row block j
      const bool near = j < kBlocks && box_near(cbox, rbox[j < kBlocks ? j : 0], hh_keep);
      const unsigned vote = __ballot_sync(kFull, near);
      if (j == 0) keep[tid >> 3] = (unsigned char)(vote >> (lane & 24));
    }
    __syncthreads();
    const int ncol = min(kStage, total - s * kStage);
    for (int cb = warp; cb * 8 < ncol; cb += kWarps) {  // warp-uniform
      asm volatile("" ::: "memory");  // the row reads stay in the trip
      const unsigned kept = keep[cb];
      if (kept == 0) continue;
      const float4 b0 = cur[cb * 8 + 2 * t];
      const float4 b1 = cur[cb * 8 + 2 * t + 1];
      const double bf = MXU ? bmat[t][cb * 8 + g] : 0.0;
#pragma unroll
      for (int rb = 0; rb < kBlocks; ++rb) {
        if (!((kept >> rb) & 1u)) continue;  // warp-uniform
        const float4 a = rows[rb * 8 + g];
        const float dx0 = __fsub_rn(a.x, b0.x), dy0 = __fsub_rn(a.y, b0.y),
                    dz0 = __fsub_rn(a.z, b0.z);
        const float dx1 = __fsub_rn(a.x, b1.x), dy1 = __fsub_rn(a.y, b1.y),
                    dz1 = __fsub_rn(a.z, b1.z);
        float r20, r21;
        if (MXU) {
          const double x = a.x, y = a.y, z = a.z;
          const double af = t == 0 ? x : (t == 1 ? y : (t == 2 ? z : 1.0));
          const double a2 = rowa2[MXU ? rb * 8 + g : 0];
          double d0, d1;
          dmma_m8n8k4(af, bf, d0, d1);
          r20 = __double2float_rn(d0 + a2);
          r21 = __double2float_rn(d1 + a2);
        } else {
          r20 = pair_r2(dx0, dy0, dz0);
          r21 = pair_r2(dx1, dy1, dz1);
        }
        pair.add(a.w, b0.w, dx0, dy0, dz0, r20, acc[rb]);
        pair.add(a.w, b1.w, dx1, dy1, dz1, r21, acc[rb]);
      }
    }
  }

#pragma unroll
  for (int rb = 0; rb < kBlocks; ++rb) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = acc[rb][k];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (t == 0) red[warp][rb * 8 + g][k] = v;
    }
  }
  __syncthreads();
  if (tid < SUB) {
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = red[0][tid][k];
      for (int w = 1; w < kWarps; ++w) s[k] += red[w][tid][k];
    }
    const int i = row0 + tid;
    pair.store(i, n, key[i] < ncells, rows[tid].w, s, out);
  }
}

// Which kernel a launcher runs.
enum class Kind { kDense, kCull };

template <int SUB, bool MXU, class Pair>
void launch_kind(Kind kind, const float4* cand, const int* key, const int* tiles,
                 int n, int ncells, float hh_keep, const Pair& pair, float* out,
                 cudaStream_t s) {
  const int grid = n / SUB;
  switch (kind) {
    case Kind::kDense:
      tile_kernel<SUB, MXU, Pair><<<grid, kThreads, 0, s>>>(cand, key, tiles, n, ncells,
                                                            pair, out);
      break;
    case Kind::kCull:
      tile_cull_kernel<SUB, MXU, Pair><<<grid, kThreads, 0, s>>>(
          cand, key, tiles, n, ncells, hh_keep, pair, out);
      break;
  }
}

template <int SUB, class Pair>
void launch(Kind kind, bool mxu, const void* cand, const void* key, const void* tiles,
            int n, int ncells, float hh_keep, const Pair& pair, void* out,
            cudaStream_t s) {
  if (mxu) {
    launch_kind<SUB, true>(kind, (const float4*)cand, (const int*)key, (const int*)tiles,
                           n, ncells, hh_keep, pair, (float*)out, s);
  } else {
    launch_kind<SUB, false>(kind, (const float4*)cand, (const int*)key, (const int*)tiles,
                            n, ncells, hh_keep, pair, (float*)out, s);
  }
}

template <class Pair>
int dispatch(Kind kind, int sub, int mxu, const void* cand, const void* key,
             const void* tiles, int n, int ncells, float hh_keep, const Pair& pair,
             void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n % sub != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool m = mxu != 0;
  switch (sub) {
    case 8: launch<8>(kind, m, cand, key, tiles, n, ncells, hh_keep, pair, out, s); break;
    case 16: launch<16>(kind, m, cand, key, tiles, n, ncells, hh_keep, pair, out, s); break;
    case 32: launch<32>(kind, m, cand, key, tiles, n, ncells, hh_keep, pair, out, s); break;
    case 64: launch<64>(kind, m, cand, key, tiles, n, ncells, hh_keep, pair, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pbf_lambda_tile(const void* cand, const void* key, const void* tiles, int n,
                    int ncells, int sub, int mxu, float h, float hh, float eps2,
                    float p6f, float c_grad, float rho_recip, float cfm,
                    void* lam, void* stream) {
  const LambdaPair pair{h, hh, eps2, p6f, c_grad, rho_recip, cfm};
  return dispatch(Kind::kDense, sub, mxu, cand, key, tiles, n, ncells, 0.f, pair, lam,
                  stream);
}

int pbf_delta_tile(const void* cand, const void* key, const void* tiles, int n,
                   int ncells, int sub, int mxu, float h, float hh, float eps2,
                   float skf, float xqf, float corr_k, float rho_recip,
                   void* dp, void* stream) {
  const DeltaPair pair{h, hh, eps2, skf, xqf, corr_k, rho_recip};
  return dispatch(Kind::kDense, sub, mxu, cand, key, tiles, n, ncells, 0.f, pair, dp,
                  stream);
}

int pbf_lambda_tile_cull(const void* cand, const void* key, const void* tiles, int n,
                         int ncells, int sub, int mxu, float h, float hh, float hh_keep,
                         float eps2, float p6f, float c_grad, float rho_recip, float cfm,
                         void* lam, void* stream) {
  const LambdaPair pair{h, hh, eps2, p6f, c_grad, rho_recip, cfm};
  return dispatch(Kind::kCull, sub, mxu, cand, key, tiles, n, ncells, hh_keep, pair, lam,
                  stream);
}

int pbf_delta_tile_cull(const void* cand, const void* key, const void* tiles, int n,
                        int ncells, int sub, int mxu, float h, float hh, float hh_keep,
                        float eps2, float skf, float xqf, float corr_k, float rho_recip,
                        void* dp, void* stream) {
  const DeltaPair pair{h, hh, eps2, skf, xqf, corr_k, rho_recip};
  return dispatch(Kind::kCull, sub, mxu, cand, key, tiles, n, ncells, hh_keep, pair, dp,
                  stream);
}

}  // extern "C"
