// The compaction's building blocks on Hopper (sm_90a): lane rolls, the
// unaligned part body, the 4-chunk dense λ, and the data-movement probes.
//
// Replaces the Pallas TPU kernels of tools/micro_roll.py's `run` (:41) and
// three of tools/micro_vpu.py:
//   roll_lanes <- a) k_dyn (:55): 8 rows rolled by s[i mod 64] + 0.0 a trip,
//                 b) k_sta (:69): the same by 37; out = the rows' sum
//   roll_part  <- c) k_static (:113), d) k_fori (:122), e) k_nested (:134):
//                 part_body (:91) run x16 unrolled, in a loop of 16, and
//                 9 x 2 nested over parts (iv + ci) mod 16
//   roll_part_blocked <- the same, laid out for Hopper: a warp per (copy,
//                 field, chunk), the merge held in registers
//   roll_lam   <- f) k_lam (:154): micro_dense's chunk_math over 4 chunks
//   vpu_rot    <- rot_kernel (micro_vpu.py:115, call :121): roll(x, s, 1)
//   vpu_unal   <- unal_kernel (:136, call :142): x[:, o:o+128]
//   vpu_dma    <- dma_kernel (:157, call :169): the same slice by async copy
// pbf_sph_tpu_torch/tools/micro_roll.py holds the wrappers, the plain
// versions and the SASS check of every kernel here.
//
// A row of 128 lanes is one warp's: lane l holds columns l, l+32, l+64, l+96
// (roll_lanes, vpu_rot, roll_part_blocked) or 4l..4l+3 (roll_part).  A roll
// by s (np.roll: out[j] = in[(j - s) mod 128], any int32 s, as pltpu.roll
// takes) is 4 warp shuffles from lane (l - s) mod 32 and a rotation of the 4
// slots by (s div 32 + [l < s mod 32]) mod 4, two stages of selects; 4 SHFL is the
// least a roll of 128 values on 32 lanes needs, so a)/b) and vpu_rot are
// bound by the SM's shuffle rate (one warp SHFL a clock).  a)/b) run the 8
// rows as 8 independent chains in one warp, as the TPU tool's 8 streams; N
// and the shifts are run-time arguments (37 x 8192 = 0 mod 128: a folded b)
// would be the identity); the + 0.0 stays (-0 + 0 = +0).
//
// The part body reads the unaligned window AB[r .. r+128) of two aligned
// windows A = strip[ba..], B = strip[bb..], bb = min(ba + 128, SM - 128),
// and merges it into chunk dst // 128 of the output under the mask [dst,
// dst + len), exactly as part_body writes it (the source lane is not
// shifted by dst mod 128; a part past its chunk loses its tail; where the
// clamp bites, B is A).  Two bodies: `shuffle` (what the TPU tool
// measures: two aligned float4 loads a lane, realigned by 4 shuffles a
// field whose source lane and component are warp-uniform) and `direct`
// (4 unaligned 32-bit loads a lane at ba/bb + the column: how a Hopper
// compaction reads an unaligned window).  One warp walks one copy's parts
// in order (the last writer wins where parts overlap), a float4
// read-modify-write a field; the output is NaN-filled by the wrapper, so
// the columns no part writes stay NaN.  The meta (16, 3) = (s0, dst, len)
// is the TPU's SMEM table: a kernel parameter, read from the constant bank.
// Bound: the L1's 32 lanes of 4 bytes a clock for the loads and stores, or
// the bytes.  The TPU kernels' REP loop rewrites one output; here REP is
// the grid (CTA r owns copy r: CTAs sharing one output would race in the
// read-modify-write), and a CTA runs `npass` passes over its parts (the
// same result), the strip read at pass * pass_stride (0 at run time), so
// no pass can be hoisted.
//
// roll_lam: one CTA of 1024 threads a copy, warp a = row a, lane l takes
// columns l + 32i of the 512 candidates (staged once as float4 in shared
// memory) through lambda_pair of csrc/pbf_pair.cuh (the λ phase kernels'
// pair code; it takes p6 from the unclamped r2, which below eps2 = 1e-16
// gives hh in fp32 as the clamped one does); a pass is one rep of the TPU
// loop: the carries start at 0, v = ((Σp6 + Σgx) + Σgy) + Σgz by warp
// shuffles, acc += v in the tool's order.  REP is `npass` (the candidates
// read at pass * pass_stride, 0 at run time); the grid only copies.  Bound:
// fp32 and MUFU issue.
//
// vpu_unal takes 32-bit loads: 128 consecutive floats at o = 37 are
// misaligned for float4, and a shuffle realign would add instructions to a
// 4 KB copy bound by its launch, not its loads, whose lanes still read
// consecutive words (one or two 128-byte lines a warp instruction).
// vpu_dma lands the slice in shared memory by cp.async copies of 4 bytes (one
// a column: cp.async.bulk needs 16-byte aligned addresses and 37 x 4 = 148
// is not), completed on an mbarrier (each thread arrives when its copies
// land) whose wait traps after ~1M tries, then stores it: the
// make_async_copy, wait and store of the TPU kernel.  A TMA tiled copy
// through a tensor map, whose box may start at any element, raised an
// illegal-instruction fault on an H100 80GB HBM3 in every form tried (the
// map as a __grid_constant__ parameter and in global memory, 1-D and 2-D
// boxes) though the map encoded, so the port takes cp.async.  Both probes
// are bound by their launch; their bytes are 8 KB.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// body, loop or argument it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_copies.cuh"
#include "mbarrier.cuh"
#include "pbf_pair.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kW = 128;             // lanes of a row
constexpr int kRows = 8;            // rows of a)/b)'s and the vpu probes' tiles
constexpr int kShifts = 64;         // a)'s shift table
constexpr int kLaneThreads = 256;   // roll_lanes: 8 warps a CTA, a copy each
constexpr int kSm = 4096;           // strip columns
constexpr int kFields = 4;          // strip rows
constexpr int kParts = 16;
constexpr int kOutCols = 512;       // the part output: 4 chunks of 128
constexpr int kLamRows = 32;
constexpr int kLamCands = 512;
constexpr int kLamRowW = 8;         // floats of a row: rows (32, 8)
constexpr int kLamThreads = 1024;
constexpr int kVpuCols = 512;       // the slice probes' source width
constexpr int kVpuThreads = 256;

enum PartBody { kShuffle = 0, kDirect = 1 };
enum PartLoop { kStatic = 0, kFori = 1, kNested = 2 };

// (s0, dst, len) of each part: by value, in the constant bank
struct PartMeta {
  int v[kParts][3];
};

// ---------------------------------------------------------------------------
// Lane rolls
// ---------------------------------------------------------------------------

struct RollLane {
  int src;      // the lane the 4 shuffles read
  bool b0, b1;  // the bits of the slot rotation
};

// This lane's part of a roll by s (any int32: & and >> take it mod 128).
__device__ __forceinline__ RollLane roll_lane(int s) {
  const int l = threadIdx.x & 31;
  const int r = s & 31;
  const int t = ((s >> 5) + (l < r ? 1 : 0)) & 3;
  return {(l - r) & 31, (t & 1) != 0, (t & 2) != 0};
}

// v[k] = row[l + 32k] becomes row rolled: out[k] = w[(k - t) mod 4], w the
// slots shuffled from lane src.
__device__ __forceinline__ void roll_row(float (&v)[4], const RollLane& rl) {
  float w[4], y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __shfl_sync(kFull, v[k], rl.src);
#pragma unroll
  for (int k = 0; k < 4; ++k) y[k] = rl.b0 ? w[(k + 3) & 3] : w[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = rl.b1 ? y[(k + 2) & 3] : y[k];
}

__device__ __forceinline__ void load_rows(const float* __restrict__ x, int ld,
                                          float (&v)[kRows][4]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[i][k] = x[i * ld + l + 32 * k];
  }
}

// a) DYN = 1: trip i rolls by shifts[i mod 64]; b) DYN = 0: by `shift`.
template <int DYN>
__global__ void __launch_bounds__(kLaneThreads, 1)
    roll_lanes_kernel(const float* __restrict__ x, const int* __restrict__ shifts, int shift,
                      int ntrips, int ncopies, float* __restrict__ out) {
  __shared__ int sh[kShifts];
  if (DYN) {
    for (int i = threadIdx.x; i < kShifts; i += blockDim.x) sh[i] = shifts[i];
    __syncthreads();
  }
  const int copy = blockIdx.x * (kLaneThreads / 32) + (threadIdx.x >> 5);
  if (copy >= ncopies) return;
  float v[kRows][4];
  load_rows(x, kW, v);
#pragma unroll 1
  for (int i = 0; i < ntrips; ++i) {
    const RollLane rl = roll_lane(DYN ? sh[i & (kShifts - 1)] : shift);
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      roll_row(v[row], rl);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[row][k] = v[row][k] + 0.0f;
    }
  }
  // acc = c[0] + c[1] + ... + c[7], in the tool's order, on every row
  float acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = v[0][k];
#pragma unroll
  for (int row = 1; row < kRows; ++row) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = acc[k] + v[row][k];
  }
  float* o = out + (size_t)copy * kRows * kW;
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[row * kW + l + 32 * k] = acc[k];
  }
}

__global__ void __launch_bounds__(32)
    vpu_rot_kernel(const float* __restrict__ x, const int* __restrict__ s,
                   float* __restrict__ out) {
  float v[kRows][4];
  load_rows(x, kW, v);
  const RollLane rl = roll_lane(*s);
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    roll_row(v[row], rl);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[row * kW + l + 32 * k] = v[row][k];
  }
}

// ---------------------------------------------------------------------------
// The part body
// ---------------------------------------------------------------------------

// A select the compiler keeps as one instruction: on a warp-uniform predicate
// a C++ ?: may become a branch, and a shuffle after a branch waits for the
// warp to reconverge.
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %1, 0;\n\tselp.f32 %0, %2, %3, q;\n\t}"
      : "=f"(r)
      : "r"((unsigned)p), "f"(a), "f"(b));
  return r;
}

// rolled[k] = AB[4l + k + r] of AB = a[0..128) ++ b[0..128), lane t holding
// a[4t..4t+3] and b[4t..4t+3].  Slot k of lane l comes from lane l + rq
// (component k + rr) or, past the float4, from lane l + rq + 1, rq = r / 4,
// rr = r mod 4, both warp-uniform; that lane index wraps past 31 into b,
// which the sender tells from its own index.  So each sender lines up e =
// its 4 values for lane l - rq and its 4 for lane l - rq - 1, picks e[k + rr]
// by two stages of selects, and each slot is one shuffle.
__device__ __forceinline__ void shuffle_window(const float* __restrict__ a,
                                               const float* __restrict__ b, int r,
                                               float (&rolled)[4]) {
  const int l = threadIdx.x & 31;
  const float4 fa = reinterpret_cast<const float4*>(a)[l];
  const float4 fb = reinterpret_cast<const float4*>(b)[l];
  const int rq = r >> 2, rr = r & 3;
  const bool p1 = l >= rq, p2 = l >= rq + 1;   // a, else b, for lane l - rq / l - rq - 1
  const float e[8] = {sel(p1, fa.x, fb.x), sel(p1, fa.y, fb.y), sel(p1, fa.z, fb.z),
                      sel(p1, fa.w, fb.w), sel(p2, fa.x, fb.x), sel(p2, fa.y, fb.y),
                      sel(p2, fa.z, fb.z), sel(p2, fa.w, fb.w)};
  float t[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) t[j] = sel(rr & 1, e[j + 1], e[j]);
  const int src = (l + rq) & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = sel(rr & 2, t[k + 2], t[k]);
    rolled[k] = __shfl_sync(kFull, send, k + rr < 4 ? src : (src + 1) & 31);
  }
}

// The same window by one 32-bit load a column.
__device__ __forceinline__ void direct_window(const float* __restrict__ row, int ba, int bb,
                                              int r, float (&rolled)[4]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * l + k;
    rolled[k] = row[j < kW - r ? ba + j + r : bb + j + r - kW];
  }
}

// part_body (:91-109) of part p on one copy's output (4, 512).
template <int BODY>
__device__ __forceinline__ void part_body(const float* __restrict__ strips, const PartMeta& meta,
                                          int p, float* out) {
  const int s0 = meta.v[p][0], dst = meta.v[p][1], len = meta.v[p][2];
  const int l = threadIdx.x & 31;
  const int c = dst >> 7;
  const int r = s0 & (kW - 1);
  const int ba = s0 - r;
  const int bb = min(ba + kW, kSm - kW);
  const int col = c * kW + 4 * l;
  bool valid[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) valid[k] = col + k >= dst && col + k < dst + len;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const float* row = strips + f * kSm;
    float rolled[4];
    if constexpr (BODY == kShuffle) {
      shuffle_window(row + ba, row + bb, r, rolled);
    } else {
      direct_window(row, ba, bb, r, rolled);
    }
    float4* o = reinterpret_cast<float4*>(out + f * kOutCols + col);
    const float4 cur = *o;
    *o = make_float4(sel(valid[0], rolled[0], cur.x), sel(valid[1], rolled[1], cur.y),
                     sel(valid[2], rolled[2], cur.z), sel(valid[3], rolled[3], cur.w));
  }
}

template <int BODY, int LOOP>
__global__ void __launch_bounds__(32)
    roll_part_kernel(const float* __restrict__ strips, const PartMeta meta, int niv, int nci,
                     int npass, int pass_stride, float* __restrict__ out) {
  float* o = out + (size_t)blockIdx.x * kFields * kOutCols;
#pragma unroll 1
  for (int pass = 0; pass < npass; ++pass) {
    const float* s = strips + pass * pass_stride;
    if constexpr (LOOP == kStatic) {
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        // unfenced, nvcc issues all 16 parts' strip loads ahead and spills
        // (255 registers, 96 bytes of local memory in the shuffle body)
        asm volatile("" ::: "memory");
        part_body<BODY>(s, meta, p, o);
      }
    } else if constexpr (LOOP == kFori) {
#pragma unroll 1
      for (int p = 0; p < kParts; ++p) part_body<BODY>(s, meta, p, o);
    } else {
#pragma unroll 1
      for (int iv = 0; iv < niv; ++iv) {
#pragma unroll 1
        for (int ci = 0; ci < nci; ++ci) part_body<BODY>(s, meta, (iv + ci) & (kParts - 1), o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The part body redesigned: a warp per (copy, field, chunk)
// ---------------------------------------------------------------------------

// roll_part_kernel's warp walks a whole copy, 3.9 warps an SM at the JAX
// call's 512 copies, and each merge is a float4 load and store of the
// output that the next part of the chunk loads again: a chain of memory
// round trips.  But part_body writes field f only from field f of the
// strip, and part p only into chunk dst >> 7, so a copy's 4 x 4 pieces are
// independent.  Here warp f of CTA b owns field f of copy b / n and chunk
// id[b % n] (the chunks some part of the structure writes, n of them, from
// the launcher; the others are neither loaded nor stored).  It loads its
// 128 columns once, walks the structure's parts in order, skips (warp-
// uniformly) those of other chunks, so the last writer still wins, merges
// each by select in 4 registers a lane, and stores once after the last
// pass.  The layout is free: lane l holds columns l + 32k, so every load
// of a window is one run of 32 consecutive floats.  Issue bounds it, not
// the loads: mostly integer work (the walk over 16 parts, a window's index
// and address arithmetic, on a pipe of half the issue rate), so that
// arithmetic is kept short.  4 warps a CTA, fixed.
constexpr int kChunks = kOutCols / kW;
constexpr int kBlockedThreads = 32 * kFields;

// The chunks a structure's parts write, in order; by value, in the constant
// bank.
struct PartChunks {
  int id[kChunks];
  int n;
};

// rolled[k] = AB[r + l + 32k].  direct: one load a column at ba + ((r + j)
// & mask): A ++ B is the strip's run from s0 (mask 255, r + j < 255) unless
// the clamp makes B = A (ba = SM - 128), where the run wraps within A
// (mask 127).  shuffle: the two aligned windows in 8 loads, lane l holding
// slots A[l + 32i], B[l + 32i], rolled by r as roll_row rolls a row: output
// slot k of lane l is slot k + (r >> 5) of lane (l + r) mod 32, or the next
// slot where that lane index wraps, which the sender tells from its own
// index (t < r mod 32); it picks slot k + q, q in [0, 4], by selects that
// shift the 8 slots by q's bits, and each output slot is one shuffle.
template <int BODY>
__device__ __forceinline__ void blocked_window(const float* __restrict__ row, int s0,
                                               float (&rolled)[4]) {
  const int l = threadIdx.x & 31;
  const int r = s0 & (kW - 1);
  const int ba = s0 - r;
  if constexpr (BODY == kDirect) {
    const unsigned mask = ba == kSm - kW ? kW - 1 : 2 * kW - 1;
    const float* a = row + ba;
    // a in a register: else nvcc folds ba and the pass offset into each
    // load's index, 4 more integer instructions a load for its 64-bit sum
    // (the register hides that a is global, so the loads say so: __ldg)
    asm("" : "+l"(a));
#pragma unroll
    for (int k = 0; k < 4; ++k) rolled[k] = __ldg(a + ((unsigned)(r + l + 32 * k) & mask));
  } else {
    const float* a = row + ba + l;
    const float* b = row + min(ba + kW, kSm - kW) + l;
    float e[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = __ldg(a + 32 * i), e[4 + i] = __ldg(b + 32 * i);
    const int rr = r & 31;
    const int q = (r >> 5) + (l < rr ? 1 : 0);
    float y[6], z[4];
#pragma unroll
    for (int i = 0; i < 6; ++i) y[i] = sel(q & 1, e[i + 1], e[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i] = sel(q & 2, y[i + 2], y[i]);
    const int src = (l + rr) & 31;
#pragma unroll
    for (int k = 0; k < 4; ++k) rolled[k] = __shfl_sync(kFull, sel(q & 4, e[k + 4], z[k]), src);
  }
}

// part_body (:91-109) of part p on chunk c of one field, held in v.
template <int BODY>
__device__ __forceinline__ void blocked_visit(const float* __restrict__ row, const PartMeta& meta,
                                              int p, int c, float (&v)[4]) {
  const int s0 = meta.v[p][0], dst = meta.v[p][1], len = meta.v[p][2];
  if ((dst >> 7) != c) return;
  float rolled[4];
  blocked_window<BODY>(row, s0, rolled);
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // col in [dst, dst + len): dst and col < 512, len >= 0
    const bool valid = (unsigned)(c * kW + l + 32 * k - dst) < (unsigned)len;
    v[k] = sel(valid, rolled[k], v[k]);
  }
}

template <int BODY, int LOOP>
__global__ void __launch_bounds__(kBlockedThreads)
    roll_part_blocked_kernel(const float* __restrict__ strips, const PartMeta meta,
                             const PartChunks chunks, int niv, int nci, int npass,
                             int pass_stride, float* __restrict__ out) {
  const int f = threadIdx.x >> 5;
  const int c = chunks.id[blockIdx.x % chunks.n];
  float* o = out + ((size_t)(blockIdx.x / chunks.n) * kFields + f) * kOutCols + c * kW;
  const float* row = strips + f * kSm;
  const int l = threadIdx.x & 31;
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = o[l + 32 * k];
#pragma unroll 1
  for (int pass = 0; pass < npass; ++pass) {
    const float* s = row + pass * pass_stride;
    if constexpr (LOOP == kStatic) {
#pragma unroll
      for (int p = 0; p < kParts; ++p) blocked_visit<BODY>(s, meta, p, c, v);
    } else if constexpr (LOOP == kFori) {
#pragma unroll 1
      for (int p = 0; p < kParts; ++p) blocked_visit<BODY>(s, meta, p, c, v);
    } else {
#pragma unroll 1
      for (int iv = 0; iv < niv; ++iv) {
#pragma unroll 1
        for (int ci = 0; ci < nci; ++ci) {
          blocked_visit<BODY>(s, meta, (iv + ci) & (kParts - 1), c, v);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) o[l + 32 * k] = v[k];
}

// ---------------------------------------------------------------------------
// f): the 4-chunk dense λ
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kLamThreads)
    roll_lam_kernel(const float* __restrict__ rows, const float* __restrict__ cands, float hh,
                    float hf, float eps2, int npass, int pass_stride, float* __restrict__ out) {
  __shared__ float4 cb[kLamCands];
  for (int i = threadIdx.x; i < kLamCands; i += kLamThreads) {
    cb[i] = make_float4(cands[i], cands[kLamCands + i], cands[2 * kLamCands + i], 0.0f);
  }
  __syncthreads();
  const int a = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const float* ra = rows + a * kLamRowW;
  const float ax = ra[0], ay = ra[1], az = ra[2];
  float acc = 0.0f;
#pragma unroll 1
  for (int p = 0; p < npass; ++p) {
    const float4* b = cb + l + p * pass_stride;
    float p6s = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
    for (int j = 0; j < kLamCands; j += 32) {
      lambda_pair(ax, ay, az, b[j], hf, hh, eps2, p6s, gx, gy, gz);
    }
    acc = acc + (((warp_sum(p6s) + warp_sum(gx)) + warp_sum(gy)) + warp_sum(gz));
  }
  if (l == 0) out[blockIdx.x * kLamRows + a] = acc;
}

// ---------------------------------------------------------------------------
// The slice probes
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kVpuThreads)
    vpu_unal_kernel(const float* __restrict__ x, int o, float* __restrict__ out) {
  const int row = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const float* src = x + row * kVpuCols + o;
#pragma unroll
  for (int k = 0; k < 4; ++k) out[row * kW + l + 32 * k] = src[l + 32 * k];
}

__global__ void __launch_bounds__(kVpuThreads)
    vpu_dma_kernel(const float* __restrict__ x, int o, float* __restrict__ out) {
  __shared__ __align__(16) float tile[kRows * kW];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_u32(&bar);
  if (threadIdx.x == 0) mbar_init(b, kVpuThreads);
  __syncthreads();
  const int row = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const float* src = x + row * kVpuCols + o;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_u32(tile + row * kW + l + 32 * k)),
                 "l"(src + l + 32 * k)
                 : "memory");
  }
  // the barrier's phase completes when every thread's copies have landed
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(b) : "memory");
  mbar_wait_or_trap(b, 0u);
  reinterpret_cast<float4*>(out)[threadIdx.x] = reinterpret_cast<const float4*>(tile)[threadIdx.x];
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

using LanesFn = void (*)(const float*, const int*, int, int, int, float*);
using PartFn = void (*)(const float*, const PartMeta, int, int, int, int, float*);

LanesFn find_lanes(int dynamic) {
  switch (dynamic) {
    case 0: return roll_lanes_kernel<0>;
    case 1: return roll_lanes_kernel<1>;
  }
  return nullptr;
}

PartFn find_part(int body, int loop) {
  switch (body * 3 + loop) {
    case kShuffle * 3 + kStatic: return roll_part_kernel<kShuffle, kStatic>;
    case kShuffle * 3 + kFori: return roll_part_kernel<kShuffle, kFori>;
    case kShuffle * 3 + kNested: return roll_part_kernel<kShuffle, kNested>;
    case kDirect * 3 + kStatic: return roll_part_kernel<kDirect, kStatic>;
    case kDirect * 3 + kFori: return roll_part_kernel<kDirect, kFori>;
    case kDirect * 3 + kNested: return roll_part_kernel<kDirect, kNested>;
  }
  return nullptr;
}

using BlockedFn = void (*)(const float*, const PartMeta, const PartChunks, int, int, int, int,
                          float*);

BlockedFn find_blocked(int body, int loop) {
  switch (body * 3 + loop) {
    case kShuffle * 3 + kStatic: return roll_part_blocked_kernel<kShuffle, kStatic>;
    case kShuffle * 3 + kFori: return roll_part_blocked_kernel<kShuffle, kFori>;
    case kShuffle * 3 + kNested: return roll_part_blocked_kernel<kShuffle, kNested>;
    case kDirect * 3 + kStatic: return roll_part_blocked_kernel<kDirect, kStatic>;
    case kDirect * 3 + kFori: return roll_part_blocked_kernel<kDirect, kFori>;
    case kDirect * 3 + kNested: return roll_part_blocked_kernel<kDirect, kNested>;
  }
  return nullptr;
}

bool bad_part(int body, int loop) {
  return body < kShuffle || body > kDirect || loop < kStatic || loop > kNested;
}

// The meta read from host memory into m; false unless every s0 is in [0,
// 4096), dst in [0, 512) and len in [0, 512].
bool read_meta(const void* meta, PartMeta& m) {
  const int* host = (const int*)meta;
  for (int p = 0; p < kParts; ++p) {
    for (int i = 0; i < 3; ++i) m.v[p][i] = host[p * 3 + i];
    if (m.v[p][0] < 0 || m.v[p][0] >= kSm || m.v[p][1] < 0 || m.v[p][1] >= kOutCols ||
        m.v[p][2] < 0 || m.v[p][2] > kOutCols) {
      return false;
    }
  }
  return true;
}

// roll_part's checks, and its meta read into m; false on what the part
// kernels do not take.
bool part_args(const void* strips, const void* meta, int body, int loop, int niv, int nci,
               int nrep, int npass, const void* out, PartMeta& m) {
  if (bad_part(body, loop) || nrep <= 0 || npass <= 0 || niv < 0 || nci < 0 ||
      ((uintptr_t)strips & 15u) != 0 || ((uintptr_t)out & 15u) != 0) {
    return false;
  }
  return read_meta(meta, m);
}

// The chunks that some part of the structure writes, in order: one
// roll_part_blocked CTA a copy for each.
PartChunks blocked_chunks(const PartMeta& m, int loop, int niv, int nci) {
  bool written[kChunks] = {};
  if (loop == kNested) {
    // (iv + ci) mod 16 takes every part it ever takes by iv, ci < 16
    for (int iv = 0; iv < min(niv, kParts); ++iv) {
      for (int ci = 0; ci < min(nci, kParts); ++ci) {
        written[m.v[(iv + ci) & (kParts - 1)][1] >> 7] = true;
      }
    }
  } else {
    for (int p = 0; p < kParts; ++p) written[m.v[p][1] >> 7] = true;
  }
  PartChunks chunks{};
  for (int c = 0; c < kChunks; ++c) {
    if (written[c]) chunks.id[chunks.n++] = c;
  }
  return chunks;
}

}  // namespace

extern "C" {

// Copies that fill every SM at the kernel's occupancy: kernel 0 roll_lanes
// (variant: dynamic 1 or 0), 1 roll_part (variant: body * 3 + loop), 2
// roll_lam; for kernel 3 roll_part_blocked (variant as 1) the (copy, chunk)
// CTAs that do; -1 for a kernel it has no instantiation of.
int micro_roll_fill(int kernel, int variant) {
  if (kernel == 0 && find_lanes(variant) != nullptr) {
    return fill_ctas(find_lanes(variant), kLaneThreads) * (kLaneThreads / 32);
  }
  if (kernel == 1 && variant >= 0 && !bad_part(variant / 3, variant % 3)) {
    return fill_ctas(find_part(variant / 3, variant % 3), 32);
  }
  if (kernel == 3 && variant >= 0 && !bad_part(variant / 3, variant % 3)) {
    return fill_ctas(find_blocked(variant / 3, variant % 3), kBlockedThreads);
  }
  if (kernel == 2) return fill_ctas(roll_lam_kernel, kLamThreads);
  return -1;
}

// x (8, 128); shifts (64,) int32 (dynamic 1) or shift (dynamic 0); out
// (ncopies, 8, 128).
int roll_lanes(const void* x, const void* shifts, int dynamic, int shift, int ntrips,
               int ncopies, void* out, void* stream) {
  LanesFn fn = find_lanes(dynamic);
  if (fn == nullptr || ntrips < 0 || ncopies <= 0) return (int)cudaErrorInvalidValue;
  const int warps = kLaneThreads / 32;
  const int threads = 32 * min(ncopies, warps);
  fn<<<(ncopies + warps - 1) / warps, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)shifts, shift, ntrips, ncopies, (float*)out);
  return (int)cudaGetLastError();
}

// strips (4, 4096), 16-byte aligned; meta (16, 3) int32 in host memory,
// every s0 in [0, 4096), dst in [0, 512), len in [0, 512]; out (nrep, 4,
// 512), filled by the caller.  body 0 shuffle / 1 direct; loop 0 static x16
// (c), 1 fori x16 (d), 2 nested niv x nci (e).
int roll_part(const void* strips, const void* meta, int body, int loop, int niv, int nci,
              int nrep, int npass, int pass_stride, void* out, void* stream) {
  PartMeta m;
  if (!part_args(strips, meta, body, loop, niv, nci, nrep, npass, out, m)) {
    return (int)cudaErrorInvalidValue;
  }
  PartFn fn = find_part(body, loop);
  fn<<<nrep, 32, 0, (cudaStream_t)stream>>>((const float*)strips, m, niv, nci, npass, pass_stride,
                                            (float*)out);
  return (int)cudaGetLastError();
}

// The CTAs a copy of roll_part_blocked runs for this meta (16, 3) int32 in
// host memory and loop (0-2, as roll_part's), niv and nci: one for each
// chunk that a part of the structure writes; -1 on what roll_part refuses.
int roll_part_blocked_chunks(const void* meta, int loop, int niv, int nci) {
  PartMeta m;
  if (bad_part(kShuffle, loop) || niv < 0 || nci < 0 || !read_meta(meta, m)) return -1;
  return blocked_chunks(m, loop, niv, nci).n;
}

// roll_part's function and arguments: CTAs of 4 warps (field f on warp f),
// one for each copy and each chunk that a part of the structure writes;
// refused where no part runs (e with niv or nci 0), which launches nothing.
int roll_part_blocked(const void* strips, const void* meta, int body, int loop, int niv,
                      int nci, int nrep, int npass, int pass_stride, void* out, void* stream) {
  PartMeta m;
  if (!part_args(strips, meta, body, loop, niv, nci, nrep, npass, out, m) ||
      nrep > INT32_MAX / kChunks) {
    return (int)cudaErrorInvalidValue;
  }
  const PartChunks chunks = blocked_chunks(m, loop, niv, nci);
  if (chunks.n == 0) return (int)cudaErrorInvalidValue;
  BlockedFn fn = find_blocked(body, loop);
  fn<<<nrep * chunks.n, kBlockedThreads, 0, (cudaStream_t)stream>>>(
      (const float*)strips, m, chunks, niv, nci, npass, pass_stride, (float*)out);
  return (int)cudaGetLastError();
}

// rows (32, 8); cands (4, 512); out (nrep, 32, 1).
int roll_lam(const void* rows, const void* cands, int nrep, int npass, int pass_stride,
             float hh, float hf, float eps2, void* out, void* stream) {
  if (nrep <= 0 || npass < 0) return (int)cudaErrorInvalidValue;
  roll_lam_kernel<<<nrep, kLamThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)cands, hh, hf, eps2, npass, pass_stride, (float*)out);
  return (int)cudaGetLastError();
}

// x (8, 128); s (1,) int32, any value; out (8, 128).
int vpu_rot(const void* x, const void* s, void* out, void* stream) {
  vpu_rot_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)x, (const int*)s,
                                                     (float*)out);
  return (int)cudaGetLastError();
}

// x (8, 512); o in [0, 384]; out (8, 128).
int vpu_unal(const void* x, int o, void* out, void* stream) {
  if (o < 0 || o > kVpuCols - kW) return (int)cudaErrorInvalidValue;
  vpu_unal_kernel<<<1, kVpuThreads, 0, (cudaStream_t)stream>>>((const float*)x, o,
                                                               (float*)out);
  return (int)cudaGetLastError();
}

// x (8, 512); o in [0, 384]; out (8, 128), 16-byte aligned.
int vpu_dma(const void* x, int o, void* out, void* stream) {
  if (o < 0 || o > kVpuCols - kW || ((uintptr_t)out & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  vpu_dma_kernel<<<1, kVpuThreads, 0, (cudaStream_t)stream>>>((const float*)x, o,
                                                              (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
