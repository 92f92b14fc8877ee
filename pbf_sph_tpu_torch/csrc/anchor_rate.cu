// Rate anchor of the λ/Δp pair math on Hopper (sm_90a): four micro-kernels.
//
// Replaces the three Pallas TPU kernels of tools/anchor_rate.py:
//   anchor_issue  <- build_issue  (fp32 issue rate of one op, :116)
//   anchor_body   <- build_body   (the λ or Δp pair chain alone, :204)
//   anchor_body_blocked <- build_body, redesigned: the same function, R rows
//                    a thread on one shared-memory read of each candidate,
//                    with the pair terms of the main path (csrc/pbf_cells.cu)
//   anchor_rowfix <- build_subfix (a λ row whose every range is empty, :288)
//   anchor_rowfix_blocked <- build_subfix, redesigned: the same function by
//                    the main path's row code (csrc/pbf_cells.cu), a grid that
//                    fills the card, each (dx, dy)'s range ends read once a warp
// Each computes what its Pallas kernel computes; the (8,128) vreg tiles, the
// 128-lane chunks, the sentinel strip and the static unrolling that Mosaic
// needs are not carried over.  pbf_sph_tpu_torch/tools/anchor_rate.py holds
// the wrappers, the plain versions and the SASS check of every kernel here.
//
// What bounds them: by construction, instruction issue (anchor_issue: one
// op on `nstreams` independent fp32 carries; anchor_body: the pair terms of
// csrc/pbf_pair.cuh, which pbf_lambda and pbf_delta run, on candidates read
// from shared memory by broadcast; anchor_body_blocked: those of
// csrc/pbf_cells_pair.cuh, which the main path's pbf_lambda_cells and
// pbf_delta_cells run, with the read and the loop's own instructions shared
// by R pairs), and for anchor_rowfix the per-row fixed
// work of pbf_lambda's own row code: the key, the row, 18 cell-table reads
// and the λ store (anchor_rowfix_blocked: the same work of the main path's
// row code, in this card's layout).  Each kernel is launched over
// enough CTAs to fill every SM at its occupancy (anchor_fill_threads), each
// thread computing one element of the JAX output again (thread t takes
// element t mod 1024 of the tile, row t mod 64 of the body, rows t*R .. t*R
// + R - 1 mod 64 of the blocked body, row t mod nrows of the rows), and
// writes its own output so that no work is dead.
//
// The compiler must not fold the loops the rates are read from: max(c, x)
// is idempotent, so the max op is inline PTX; sub_mul uses the _rn
// intrinsics so that c*x then -x is not contracted to one FFMA; the body
// reads chunk (k + i*stride) mod nch with `stride` a run-time argument (0 in
// every use), so its math cannot be hoisted out of the iteration loop.  The
// wrapper checks the SASS of each instantiation (cuobjdump).
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// combination it has no instantiation for).

#include <cuda_runtime.h>

#include "grid_copies.cuh"
#include "pbf_cells_pair.cuh"
#include "pbf_pair.cuh"

namespace {

constexpr int kThreads = 256;
// R, the rows a thread of anchor_body_blocked holds (tools/anchor_rate.py's
// BLOCKED_ROWS; a CPU test holds the two equal).  Read on the H100 at 2, 3,
// 4, 6 and 8: 2-6 within 3.2% of each other, 8 slower (PERF.md, row 7b-b);
// 4 divides the body's iterations and spills nothing.
constexpr int kBlockedRows = 4;
constexpr int kTile = 1024;  // elements of the JAX (8, 128) tile
constexpr int kSub = 64;     // rows of the JAX body tile
constexpr int kWcol = 128;   // candidates of one strip chunk

enum Op { kFma = 0, kMul = 1, kMax = 2, kSubMul = 3, kRsqrt = 4 };

template <int OP>
__device__ __forceinline__ float issue_op(float c, float x, int u) {
  if constexpr (OP == kFma) return fmaf(c, 1.000001f, x);
  if constexpr (OP == kMul) return __fmul_rn(c, 1.000001f);
  if constexpr (OP == kMax) {
    float r;
    asm volatile("max.f32 %0, %1, %2;" : "=f"(r) : "f"(c), "f"(x));
    return r;
  }
  if constexpr (OP == kSubMul) return (u % 2) ? __fsub_rn(c, x) : __fmul_rn(c, x);
  return rsqrtf(__fadd_rn(c, x));
}

// nstreams independent carries from x + s; each iteration applies `UN`
// rounds of the op to every carry; the output is the sum of the carries.
template <int OP, int NS, int UN>
__global__ void __launch_bounds__(kThreads)
    issue_kernel(const float* __restrict__ x_in, int niter, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const float x = x_in[t % kTile];
  float c[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) c[s] = x + (float)s;
  for (int i = 0; i < niter; ++i) {
#pragma unroll
    for (int u = 0; u < UN; ++u) {
#pragma unroll
      for (int s = 0; s < NS; ++s) c[s] = issue_op<OP>(c[s], x, u);
    }
  }
  float acc = c[0];
#pragma unroll
  for (int s = 1; s < NS; ++s) acc += c[s];
  out[t] = acc;
}

using IssueFn = void (*)(const float*, int, float*);

// The instantiations: the JAX tool's 16 streams x 16 rounds for every op,
// and the serial chain (1 stream) for fma.
IssueFn find_issue(int op, int nstreams, int unroll) {
  if (nstreams == 16 && unroll == 16) {
    switch (op) {
      case kFma: return issue_kernel<kFma, 16, 16>;
      case kMul: return issue_kernel<kMul, 16, 16>;
      case kMax: return issue_kernel<kMax, 16, 16>;
      case kSubMul: return issue_kernel<kSubMul, 16, 16>;
      case kRsqrt: return issue_kernel<kRsqrt, 16, 16>;
    }
  }
  if (nstreams == 1 && unroll == 16 && op == kFma) return issue_kernel<kFma, 1, 16>;
  return nullptr;
}

// The production chunk body: row t mod 64 against `nunroll` chunks of the
// strip an iteration, chunk (k + i*stride) mod nch, each pair by the
// lambda_pair or delta_pair that csrc/pbf_phases.cu runs.  The strip is staged
// once per CTA in shared memory as float4 (x, y, z, λ); every lane of a warp
// reads the same candidate, a broadcast.  The output is the row's sum over
// its pairs of the summed carries.
template <bool LAMBDA>
__global__ void __launch_bounds__(kThreads)
    body_kernel(const float* __restrict__ rows, const float* __restrict__ strip,
                int nch, int nunroll, int niter, int stride, float h, float hh,
                float eps2, float skf, float xqf, float corr_k, float rho_recip,
                float* __restrict__ out) {
  extern __shared__ float4 cand[];
  const int ncols = nch * kWcol;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    cand[c] = make_float4(strip[c], strip[ncols + c], strip[2 * ncols + c],
                          strip[3 * ncols + c]);
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t % kSub;
  const float ax = rows[r], ay = rows[kSub + r], az = rows[2 * kSub + r];
  const float alam = rows[3 * kSub + r];
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int off = 0;
  for (int i = 0; i < niter; ++i) {
    int chunk = off;
    for (int k = 0; k < nunroll; ++k) {
      const float4* b0 = cand + chunk * kWcol;
#pragma unroll 8
      for (int j = 0; j < kWcol; ++j) {
        if constexpr (LAMBDA) {
          lambda_pair(ax, ay, az, b0[j], h, hh, eps2, s0, s1, s2, s3);
        } else {
          delta_pair(ax, ay, az, alam, b0[j], h, hh, eps2, skf, xqf, corr_k, rho_recip,
                     s0, s1, s2);
        }
      }
      chunk = chunk + 1 == nch ? 0 : chunk + 1;
    }
    off = (off + stride) % nch;
  }
  out[t] = LAMBDA ? ((s0 + s1) + s2) + s3 : (s0 + s1) + s2;
}

// body_kernel's function, redesigned for this card: thread t holds R rows,
// the rows of output elements t*R .. t*R + R - 1 (element e is row e mod
// 64's sum, as in body_kernel), and each candidate it reads from shared
// memory (one LDS.128, a broadcast) feeds R pairs, so the read and the
// loop's own instructions are paid once for R pairs.  The pair terms are
// csrc/pbf_cells_pair.cuh's, the code of the main path's λ/Δp; they give
// csrc/pbf_pair.cuh's bits wherever r2c >= eps^2 is normal, and each row's
// carries take its pairs in body_kernel's order, so the output is
// body_kernel's bit for bit.  The candidate loop runs kStep candidates a
// trip (R * kStep = 16 pairs) and is not unrolled further.
template <bool LAMBDA>
__global__ void __launch_bounds__(kThreads)
    body_blocked_kernel(const float* __restrict__ rows, const float* __restrict__ strip,
                        int nch, int nunroll, int niter, int stride, float h, float hh,
                        float eps2, float skf, float xqf, float corr_k, float rho_recip,
                        float* __restrict__ out) {
  constexpr int R = kBlockedRows;
  constexpr int kStep = 4;
  static_assert(kWcol % kStep == 0, "a chunk is whole trips");
  extern __shared__ float4 cand[];
  const int ncols = nch * kWcol;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    cand[c] = make_float4(strip[c], strip[ncols + c], strip[2 * ncols + c],
                          strip[3 * ncols + c]);
  }
  __syncthreads();
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * R;
  float ax[R], ay[R], az[R], alam[R];
  float s0[R], s1[R], s2[R], s3[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = (e0 + q) % kSub;
    ax[q] = rows[r];
    ay[q] = rows[kSub + r];
    az[q] = rows[2 * kSub + r];
    alam[q] = rows[3 * kSub + r];
    s0[q] = s1[q] = s2[q] = s3[q] = 0.f;
  }
  int off = 0;
  for (int i = 0; i < niter; ++i) {
    int chunk = off;
    for (int k = 0; k < nunroll; ++k) {
      const float4* b0 = cand + chunk * kWcol;
#pragma unroll 1
      for (int j = 0; j < kWcol; j += kStep) {
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const float4 b = b0[j + u];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            if constexpr (LAMBDA) {
              cells_lambda_pair(ax[q], ay[q], az[q], b, h, hh, eps2, s0[q], s1[q], s2[q],
                                s3[q]);
            } else {
              cells_delta_pair(ax[q], ay[q], az[q], alam[q], b, h, hh, eps2, skf, xqf,
                               corr_k, rho_recip, s0[q], s1[q], s2[q]);
            }
          }
        }
      }
      chunk = chunk + 1 == nch ? 0 : chunk + 1;
    }
    off = (off + stride) % nch;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    out[e0 + q] = LAMBDA ? ((s0[q] + s1[q]) + s2[q]) + s3[q] : (s0[q] + s1[q]) + s2[q];
  }
}

// pbf_lambda (csrc/pbf_phases.cu) for row t mod nrows (nrows a power of
// two): the code that pbf_lambda runs, with lambda_member of
// csrc/pbf_pair.cuh.
// Driven with a table whose every range is empty, it measures the fixed cost
// of a member row: the key, the row's float4, the 18 cell-table reads of the
// nine (dx, dy) ranges, the epilogue, the store.
__global__ void __launch_bounds__(kThreads)
    rowfix_kernel(const float4* __restrict__ cand, const int* __restrict__ key,
                  const int* __restrict__ table, int n, int nrows, int ny, int nz,
                  int ncells, float h, float hh, float eps2, float p6f, float c_grad,
                  float rho_recip, float cfm, float* __restrict__ lam) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = i & (nrows - 1);
  const int lin = key[row];
  if (lin >= ncells) {
    lam[i] = lambda_nonmember(rho_recip, cfm);
    return;
  }
  lam[i] = lambda_member(cand, table, row, lin, ny, nz, ncells, h, hh, eps2, p6f, c_grad,
                         rho_recip, cfm);
}

// anchor_rowfix's function, redesigned for this card, on the row code of
// the main path's pbf_lambda_cells (csrc/pbf_cells.cu): the key, the row's
// float4, the nine (dx, dy) ranges [table[clip(base - 1)], table[clip(base +
// 2)]) as walk_direct builds them, cells_lambda_pair over each range and
// cells_lambda_end (fluid).  rowfix_kernel runs one short thread a row over
// (n + 255) / 256 CTAs and 18 dependent table reads and some 25
// instructions a range a row; here a grid that fills the card walks the
// output in turns of 32 R elements a warp, and a warp reads each (dx, dy)'s
// range ends once: where its member rows' cells lie within kSharedSpan of
// each other, lane l loads table[clip(lmin + off - 1 + l)] (one coalesced
// load) and each row takes its lo and hi from lanes lin - lmin and lin -
// lmin + 3 by __shfl_sync, so the ends a row reads are the entries
// walk_direct reads (a non-member row takes both from lane 0: an empty
// range); where every lane's entry of every range lies inside the table, the
// warp skips the clip.  A warp whose span is wider loads each row's ends
// directly, warp-uniform.  The nine ranges' loads are all issued before the
// first range loop, and the range loop is walk_direct's.  A thread takes
// elements w0 + 32q + lane, q < R (rows 32 apart: a warp's 32 rows of a
// step span 16 cells of the tool's index, two rows a cell, and each λ is a
// coalesced 4-byte store).  Element e is the λ of row e mod nrows.  The
// pair terms are the cells kernels', so the output is rowfix_kernel's bit
// for bit wherever every r2c is normal.
constexpr int kRowfixRows = 4;  // R: tools/anchor_rate.py's ROWFIX_ROWS
constexpr int kSharedSpan = 28;  // ends lin - 1 .. lin + 2 of 29 cells: 32 lanes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rowfix_blocked_row(
    const float4* __restrict__ cand, const int* __restrict__ key,
    const int* __restrict__ table, int row, int lane, int ny, int nz, int ncells, float h,
    float hh, float eps2, float p6f, float c_grad, float rho_recip, float cfm) {
  const int lin = key[row];
  const float4 a = cand[row];
  const bool member = lin < ncells;
  const int lmin = __reduce_min_sync(kFull, member ? lin : 0x7fffffff);
  const int lmax = __reduce_max_sync(kFull, member ? lin : -1);
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  if (lmax >= 0) {  // a member row in the warp
    const int nynz = ny * nz;
    const int dhi = member ? 3 : 0;  // a non-member's hi is its lo: no pair
    int lo[9], hi[9];
    if (lmax - lmin <= kSharedSpan) {
      const int d = member ? lin - lmin : 0;
      const int first = lmin - 1 + lane;  // lane's entry of the (0, 0) range
      int v[9];
      if (first - lane - nynz - nz >= 0 && first - lane + 31 + nynz + nz <= ncells) {
        // every lane's entry of every range inside the table: no clip
#pragma unroll
        for (int k = 0; k < 9; ++k) v[k] = table[first + (k / 3 - 1) * nynz + (k % 3 - 1) * nz];
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          v[k] = table[clip_cell(first + (k / 3 - 1) * nynz + (k % 3 - 1) * nz, ncells)];
        }
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        lo[k] = __shfl_sync(kFull, v[k], d);
        hi[k] = __shfl_sync(kFull, v[k], d + dhi);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int base = lin + (k / 3 - 1) * nynz + (k % 3 - 1) * nz;
        lo[k] = table[clip_cell(base - 1, ncells)];
        hi[k] = table[clip_cell(base - 1 + dhi, ncells)];
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      for (int j = lo[k]; j < hi[k]; ++j) {
        cells_lambda_pair(a.x, a.y, a.z, cand[j], h, hh, eps2, p6s, gx, gy, gz);
      }
    }
  }
  return cells_lambda_end(member, a.w, p6s, gx, gy, gz, p6f, c_grad, rho_recip, cfm, true);
}

__global__ void __launch_bounds__(kThreads)
    rowfix_blocked_kernel(const float4* __restrict__ cand, const int* __restrict__ key,
                          const int* __restrict__ table, int n, int nrows, int ny, int nz,
                          int ncells, float h, float hh, float eps2, float p6f, float c_grad,
                          float rho_recip, float cfm, float* __restrict__ lam) {
  constexpr int R = kRowfixRows;
  constexpr int kTurn = 32 * R;  // elements a warp takes a turn
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * (kThreads / 32) * kTurn;
  for (int w0 = (blockIdx.x * kThreads + threadIdx.x) / 32 * kTurn; w0 < n; w0 += step) {
#pragma unroll 1
    for (int q = 0; q < R; ++q) {
      const int e = w0 + 32 * q + lane;
      const float l = rowfix_blocked_row(cand, key, table, e & (nrows - 1), lane, ny, nz,
                                         ncells, h, hh, eps2, p6f, c_grad, rho_recip, cfm);
      if (e < n) lam[e] = l;
    }
  }
}

// Threads that fill every SM at the kernel's occupancy, 0 if it has none.
template <typename K>
int fill_threads(K kernel, size_t smem) {
  return fill_ctas(kernel, kThreads, smem) * kThreads;
}

size_t body_smem(int nch) { return (size_t)nch * kWcol * sizeof(float4); }

using BodyFn = void (*)(const float*, const float*, int, int, int, int, float, float, float,
                        float, float, float, float, float*);

BodyFn find_body(int kernel) {
  switch (kernel) {
    case 1: return body_kernel<true>;
    case 2: return body_kernel<false>;
    case 3: return body_blocked_kernel<true>;
    case 4: return body_blocked_kernel<false>;
  }
  return nullptr;
}

// Blocks of kThreads threads, or of one warp where nthreads is not a
// multiple of kThreads (the serial chain runs one warp an SM); 0 where
// nthreads is neither.
int block_of(int nthreads) {
  if (nthreads <= 0) return 0;
  if (nthreads % kThreads == 0) return kThreads;
  return nthreads % 32 == 0 ? 32 : 0;
}

// Launch body kernel `kernel` (find_body's numbering) over nthreads threads.
int launch_body(int kernel, const void* rows, const void* strip, int nch, int nunroll,
                int niter, int stride, float h, float hh, float eps2, float skf, float xqf,
                float corr_k, float rho_recip, int nthreads, void* out, void* stream) {
  const int block = block_of(nthreads);
  if (block == 0 || nch < 1 || nunroll < 0 || niter < 0 || stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = body_smem(nch);
  BodyFn fn = find_body(kernel);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<nthreads / block, block, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const float*)strip, nch, nunroll, niter, stride, h, hh, eps2, skf,
      xqf, corr_k, rho_recip, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kernel: 0 issue (op, nstreams, unroll), 1 λ body, 2 Δp body, 3 blocked λ
// body, 4 blocked Δp body (nch); the card-filling thread count, or -1 for a
// combination with no instantiation.
int anchor_fill_threads(int kernel, int op, int nstreams, int unroll, int nch) {
  if (kernel == 0) {
    IssueFn fn = find_issue(op, nstreams, unroll);
    return fn ? fill_threads(fn, 0) : -1;
  }
  BodyFn fn = find_body(kernel);
  return fn && nch >= 1 ? fill_threads(fn, body_smem(nch)) : -1;
}

int anchor_issue(const void* x, int op, int nstreams, int unroll, int niter,
                 int nthreads, void* out, void* stream) {
  IssueFn fn = find_issue(op, nstreams, unroll);
  const int block = block_of(nthreads);
  if (fn == nullptr || block == 0 || niter < 0) return (int)cudaErrorInvalidValue;
  fn<<<nthreads / block, block, 0, (cudaStream_t)stream>>>((const float*)x, niter,
                                                          (float*)out);
  return (int)cudaGetLastError();
}

// out: nthreads elements, element e row e mod 64's sum.
int anchor_body(const void* rows, const void* strip, int lambda, int nch, int nunroll,
                int niter, int stride, float h, float hh, float eps2, float skf,
                float xqf, float corr_k, float rho_recip, int nthreads, void* out,
                void* stream) {
  return launch_body(lambda ? 1 : 2, rows, strip, nch, nunroll, niter, stride, h, hh, eps2,
                     skf, xqf, corr_k, rho_recip, nthreads, out, stream);
}

// out: nthreads * R elements (R = kBlockedRows), element e row e mod 64's
// sum.
int anchor_body_blocked(const void* rows, const void* strip, int lambda, int nch,
                        int nunroll, int niter, int stride, float h, float hh, float eps2,
                        float skf, float xqf, float corr_k, float rho_recip, int nthreads,
                        void* out, void* stream) {
  return launch_body(lambda ? 3 : 4, rows, strip, nch, nunroll, niter, stride, h, hh, eps2,
                     skf, xqf, corr_k, rho_recip, nthreads, out, stream);
}

// λ (n elements, element e row e mod nrows) by rowfix_blocked_kernel over
// the CTAs that fill the card (fewer where n needs fewer).
int anchor_rowfix_blocked(const void* cand, const void* key, const void* table, int n,
                          int nrows, int ny, int nz, int ncells, float h, float hh, float eps2,
                          float p6f, float c_grad, float rho_recip, float cfm, void* lam,
                          void* stream) {
  if (nrows < 1 || (nrows & (nrows - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int per_cta = kThreads * kRowfixRows;
    const int need = (n + per_cta - 1) / per_cta;
    const int fill = fill_ctas(rowfix_blocked_kernel, kThreads);
    const int ctas = fill < need ? fill : need;
    if (ctas <= 0) return (int)cudaErrorInvalidValue;
    rowfix_blocked_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)cand, (const int*)key, (const int*)table, n, nrows, ny, nz, ncells, h,
        hh, eps2, p6f, c_grad, rho_recip, cfm, (float*)lam);
  }
  return (int)cudaGetLastError();
}

int anchor_rowfix(const void* cand, const void* key, const void* table, int n,
                  int nrows, int ny, int nz, int ncells, float h, float hh, float eps2,
                  float p6f, float c_grad, float rho_recip, float cfm, void* lam,
                  void* stream) {
  if (nrows < 1 || (nrows & (nrows - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    rowfix_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)cand, (const int*)key, (const int*)table, n, nrows, ny, nz,
        ncells, h, hh, eps2, p6f, c_grad, rho_recip, cfm, (float*)lam);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
