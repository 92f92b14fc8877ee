// Window micro-benchmark of the λ row on Hopper (sm_90a): four kernels that
// run the same λ pair terms and epilogue and differ only in how a row finds
// its candidates.
//
// Replaces the four Pallas TPU kernels of tools/micro_window.py:
//   window_prod    <- build_prod_structure (:176): nine windows from a lo/hi
//                     table, an unconditional first chunk a window (an empty
//                     window reads the sentinel chunk at smax), then a loop;
//                     split loads, or fused ones (a body the JAX tool lacks:
//                     pbf_lambda's own loads)
//   window_guarded <- build_guarded        (:226): the same without the
//                     unconditional chunk, split or fused
//   window_flat    <- build_flat           (:290): one loop over a
//                     per-sub-block list [count, offsets...], split or fused
//                     candidate loads
//   window_static  <- build_static_fused   (:324): offsets computed, not
//                     loaded, fused loads
// and, redesigned for this card beside the originals (which stay, as the
// bisection they belong to), one kernel for the four rungs:
//   window_prod_blocked    <- build_prod_structure (:176)
//   window_guarded_blocked <- build_guarded        (:226)
//   window_flat_blocked    <- build_flat           (:290)
//   window_static_blocked  <- build_static_fused   (:324)
// each the same function as its original, bit for bit.
// Every kernel computes λ of 1024 rows (16 sub-blocks of 64) in the JAX
// tool's form: each pair by lambda_pair of csrc/pbf_pair.cuh (the tool's
// lam_math, and pbf_lambda's own pair terms), then the tool's epilogue, where
// memberf scales rho and the gradient.  pbf_sph_tpu_torch/tools/micro_window.py
// holds the wrappers, the plain versions, the tables and the SASS check.
//
// Generalised in one place: the chunk width W, 128 in the JAX tool.  Each
// kernel is instantiated at W = 128 and at W = 1, where the prod kernel's
// chunk loop is pbf_lambda's own `for j in [lo, hi)` and the flat list a
// per-row candidate list.  The static kernel reads nwin windows of nper
// chunks at ((s*7 + t) % 40) * nper * W; the JAX tool's scenario is nwin 10,
// nper 1.  Its trip counts are arguments: the census scenario takes them
// from the data at run time.
//
// What bounds them: instruction issue, by construction.  Every thread reads
// the candidates of its sub-block, which two warps share, so a load is a
// broadcast from L1; the strip (a (4, ncols) SoA for split loads, an
// (ncols, 4) float4 pack for fused ones) is ~135 KB and stays in L1/L2.  The
// JAX fori over nblocks is not a loop here: its body is loop-invariant and
// nvcc would hoist it.  Thread i computes row i mod 1024 and writes out[i],
// so nblocks x 1024 threads replicate the rows and no work is dead.
//
// Sums: at W > 1 a chunk's pairs go to a partial sum, which is added to the
// row's total, as the Pallas (64, W) carry keeps a sum a lane; at W = 1 each
// pair goes to the total, so the pair loop holds pbf_lambda's fp32
// instructions a pair, opcode by opcode (the wrapper checks the SASS).
//
// The blocked kernel (window_blocked_kernel) takes what holds the four rungs
// back on this card: a thread is one row, so every pair pays its own
// candidate load from L1, and every row pays its list's bookkeeping (prod's
// and guarded's two table reads, a division and a chunk count a window;
// flat's count and an offset load a chunk, at W 1 a pair; static's modulo a
// window).  Instead a warp works on one sub-block t, whose chunk list is
// then warp-uniform, and a thread holds R = kBlockedRows distinct rows of it
// (R 2: a warp holds the 64 rows; R 4: each half-warp the same 16-lane row
// sets of another replica block).  A CTA's warps all take the same t over
// several replica blocks, so the CTA stages the chunks of t's list (at W 1,
// the columns) once, into shared memory as float4 by cp.async: 16 bytes
// from the pack (fused), three times 4 from the SoA strip (split; w is not
// read).  Only where the list comes from differs between the rungs (the
// WindowList, FlatList and StaticList sources); its bookkeeping runs once a
// CTA and in the staging, and each candidate is then one LDS.128 broadcast
// that feeds R pairs.  Lists longer than a stage buffer are staged in
// rounds, double-buffered.  Each row keeps its carries in its original's
// order (at W 128 a chunk's partials from 0, then added to the totals; at W
// 1 each pair into the totals) with the same lambda_pair and epilogue, so
// the output is the original's bit for bit.  Every one of the nblocks x
// 1024 outputs runs its own pairs.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (cudaErrorInvalidValue for a
// width it has no instantiation for).  Table offsets must lie in
// [0, ncols - W]; the kernels do not clip them (prod and guarded clip the
// window chunks to smax, as the tool does).

#include <cuda_runtime.h>

#include <cstdint>

#include "cull.cuh"
#include "pbf_pair.cuh"

namespace {

constexpr int kThreads = 256;
// R, the rows a thread of the blocked kernels holds (tools/micro_window.py's
// BLOCKED_ROWS; a CPU test holds the two equal).  A divisor of 64 from 2 on.
constexpr int kBlockedRows = 4;
constexpr int kBlockedThreads = 128;  // 4 warps, all on one sub-block
constexpr int kStage = 768;           // float4 slots of a stage buffer: 6 chunks at W 128
constexpr int kNsub = 16;             // sub-blocks of a block
constexpr int kRows = 1024;    // rows of one block: 16 sub-blocks of 64
constexpr int kSubShift = 6;   // 64 rows a sub-block
constexpr int kWindows = 9;    // the nine (dx, dy) windows of a sub-block
constexpr int kWinStride = 18; // [t*18 + 2s + {lo, hi}]
constexpr int kSpan = 40;      // the static offsets' period, in windows

struct Row {
  int r, t;
  float ax, ay, az;
};

__device__ __forceinline__ Row row_of(const float* __restrict__ rows, int i) {
  Row w;
  w.r = i & (kRows - 1);
  w.t = w.r >> kSubShift;
  w.ax = rows[w.r];
  w.ay = rows[kRows + w.r];
  w.az = rows[2 * kRows + w.r];
  return w;
}

// Candidate k: one float4 load from the pack (fused), or three 32-bit loads
// from the SoA strip (split).
template <bool FUSED>
__device__ __forceinline__ float4 candidate(const float* __restrict__ strip,
                                            const float4* __restrict__ pack, int ncols, int k) {
  if constexpr (FUSED) {
    return pack[k];
  } else {
    return make_float4(strip[k], strip[ncols + k], strip[2 * ncols + k], 0.f);
  }
}

// The candidates of one chunk, columns [o, o + W), against the row.
template <int W, bool FUSED>
__device__ __forceinline__ void chunk(const float* __restrict__ strip,
                                      const float4* __restrict__ pack, int ncols, int o,
                                      const Row& w, float h, float hh, float eps2,
                                      float& p6s, float& gx, float& gy, float& gz) {
  if constexpr (W == 1) {
    lambda_pair(w.ax, w.ay, w.az, candidate<FUSED>(strip, pack, ncols, o), h, hh, eps2, p6s,
                gx, gy, gz);
  } else {
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll 8
    for (int j = 0; j < W; ++j) {
      lambda_pair(w.ax, w.ay, w.az, candidate<FUSED>(strip, pack, ncols, o + j), h, hh, eps2,
                  c0, c1, c2, c3);
    }
    p6s += c0;
    gx += c1;
    gy += c2;
    gz += c3;
  }
}

// The tool's epilogue (tools/micro_window.py:96-109): memberf scales rho and
// the gradient.
__device__ __forceinline__ float epilogue(const float* __restrict__ rows, int r, float p6s,
                                          float gx, float gy, float gz, float p6f,
                                          float c_grad, float rho_recip, float cfm) {
  const float mass = rows[3 * kRows + r];
  const float memberf = rows[4 * kRows + r];
  const float rho = mass * (p6s * p6f) * memberf;
  const float c = c_grad * memberf;
  const float ux = gx * c, uy = gy * c, uz = gz * c;
  const float norm2 = ux * ux + uy * uy + uz * uz;
  const float ci = rho * rho_recip - 1.0f;
  return -ci / (norm2 + cfm);
}

// window_prod (GUARDED false) and window_guarded (true), with the JAX
// tool's split loads or with fused ones, as pbf_lambda loads its candidates.
template <int W, bool GUARDED, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const int* __restrict__ wins, const float* __restrict__ rows,
                  const float* __restrict__ strip, const float4* __restrict__ pack, int ncols,
                  int smax, int n, float h, float hh, float eps2, float p6f, float c_grad,
                  float rho_recip, float cfm, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Row w = row_of(rows, i);
  const int* __restrict__ tw = wins + w.t * kWinStride;
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll 1
  for (int s = 0; s < kWindows; ++s) {
    const int lo = tw[2 * s];
    const int hi = tw[2 * s + 1];
    const int c0 = lo / W;
    const int nchunk = hi > lo ? (hi - c0 * W + W - 1) / W : 0;
    int wi = 0;
    if constexpr (!GUARDED) {
      chunk<W, FUSED>(strip, pack, ncols, min(c0 * W, smax), w, h, hh, eps2, p6s, gx, gy, gz);
      wi = 1;
    }
    for (; wi < nchunk; ++wi) {
      chunk<W, FUSED>(strip, pack, ncols, min((c0 + wi) * W, smax), w, h, hh, eps2, p6s, gx,
                      gy, gz);
    }
  }
  out[i] = epilogue(rows, w.r, p6s, gx, gy, gz, p6f, c_grad, rho_recip, cfm);
}

// A 4-byte cp.async: one of a split candidate's x, y, z.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Candidates [0, n) of a staged span against a thread's R rows, each row's
// pairs in the span's order into its carries: kStep candidates a trip (16
// pairs), each candidate one LDS.128 broadcast that feeds R pairs.
template <int R>
__device__ __forceinline__ void blocked_pairs(const float4* b0, int n, const float (&ax)[R],
                                              const float (&ay)[R], const float (&az)[R],
                                              float h, float hh, float eps2, float (&s0)[R],
                                              float (&s1)[R], float (&s2)[R], float (&s3)[R]) {
  constexpr int kStep = 16 / R;
  int j = 0;
#pragma unroll 1
  for (; j + kStep <= n; j += kStep) {
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      const float4 b = b0[j + u];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        lambda_pair(ax[q], ay[q], az[q], b, h, hh, eps2, s0[q], s1[q], s2[q], s3[q]);
      }
    }
  }
#pragma unroll 1
  for (; j < n; ++j) {
    const float4 b = b0[j];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      lambda_pair(ax[q], ay[q], az[q], b, h, hh, eps2, s0[q], s1[q], s2[q], s3[q]);
    }
  }
}

// Where a blocked CTA's chunk list comes from, the one thing the four
// blocked rungs do not share.  count<W>(t, meta) lays out the list of
// sub-block t once a CTA (every thread calls it) and returns its length;
// col<W>(t, meta, k) is the first column of list entry k, asked by the
// staging, never by the pair loop.  kSplit: the original has split loads.
//
// prod's (GUARDED false) and guarded's nine windows of the lo/hi table:
// window s holds list entries [first[s], first[s + 1]), entry k of them the
// chunk at min((c0 + k - first[s]) * W, smax), prod's first one
// unconditional.
template <bool GUARDED>
struct WindowList {
  static constexpr bool kSplit = true;
  const int* __restrict__ wins;
  int smax;
  struct Shared {
    int c0[kWindows];
    int first[kWindows + 1];
  };
  template <int W>
  __device__ __forceinline__ int count(int t, Shared& meta) const {
    // lane s < 9 reads window s, then a scan
    if (threadIdx.x < 32) {
      const int s = threadIdx.x;
      int n = 0;
      if (s < kWindows) {
        const int lo = __ldg(wins + t * kWinStride + 2 * s);
        const int hi = __ldg(wins + t * kWinStride + 2 * s + 1);
        const int c0 = lo / W;
        const int nchunk = hi > lo ? (hi - c0 * W + W - 1) / W : 0;
        n = GUARDED ? nchunk : max(nchunk, 1);
        meta.c0[s] = c0;
      }
#pragma unroll
      for (int d = 1; d < 16; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, n, d);
        if (s >= d) n += v;
      }
      if (s < kWindows) meta.first[s + 1] = n;
      if (s == 0) meta.first[0] = 0;
    }
    __syncthreads();
    return meta.first[kWindows];
  }
  template <int W>
  __device__ __forceinline__ int col(int, const Shared& meta, int k) const {
    int s = 0;
    while (meta.first[s + 1] <= k) ++s;
    return min((meta.c0[s] + k - meta.first[s]) * W, smax);
  }
};

// flat's per-sub-block list: tbl[t*stride] = count, then the chunk offsets.
struct FlatList {
  static constexpr bool kSplit = true;
  const int* __restrict__ tbl;
  int stride;
  struct Shared {};
  template <int W>
  __device__ __forceinline__ int count(int t, Shared&) const {
    return __ldg(tbl + t * stride);
  }
  template <int W>
  __device__ __forceinline__ int col(int t, const Shared&, int k) const {
    return __ldg(tbl + t * stride + 1 + k);
  }
};

// static's computed offsets: entry k is chunk k % nper of window k / nper,
// at ((s*7 + t) % 40) * nper * W, fused loads only.
struct StaticList {
  static constexpr bool kSplit = false;
  int nwin, nper;
  struct Shared {};
  template <int W>
  __device__ __forceinline__ int count(int, Shared&) const {
    return nwin * nper;
  }
  template <int W>
  __device__ __forceinline__ int col(int t, const Shared&, int k) const {
    // unsigned: the signed division's sign fix-ups cost the W 1 instance 7
    // registers (63 against flat's 56) and a CTA an SM
    const unsigned n = nper, s = unsigned(k) / n;
    return int(((s * 7 + t) % kSpan) * n * W + (k - s * n) * W);
  }
};

// The four originals redesigned (see the header), one kernel for all, the
// chunk list from `list`.  CTA b takes sub-block t = b mod 16 of replica
// blocks from (b / 16) * kReps on; its thread i holds rows t*64 + i mod L +
// q*L (q < R, L = 64 / R) of replica block (b / 16) * kReps + i / L.
template <int W, class List, bool FUSED>
__global__ void __launch_bounds__(kBlockedThreads)
    window_blocked_kernel(const List list, const float* __restrict__ rows,
                          const float* __restrict__ strip, const float4* __restrict__ pack,
                          int ncols, int nblocks, float h, float hh, float eps2, float p6f,
                          float c_grad, float rho_recip, float cfm, float* __restrict__ out) {
  constexpr int R = kBlockedRows;
  constexpr int L = (1 << kSubShift) / R;
  constexpr int kReps = kBlockedThreads / L;
  constexpr int kChunks = kStage / W;  // chunks a stage round
  static_assert(R >= 2 && (1 << kSubShift) % R == 0 && L <= 32 && 16 % R == 0,
                "R divides a sub-block and a trip");
  static_assert(kStage % W == 0, "a stage round is whole chunks");
  static_assert(FUSED || List::kSplit, "split loads only where the original has them");
  __shared__ __align__(16) float4 stage[2][kStage];
  __shared__ typename List::Shared meta;

  const int t = blockIdx.x % kNsub;
  const int nchunks = list.template count<W>(t, meta);  // the bookkeeping, once a CTA

  // list entries [rd * kChunks, ...) into `buf`, one commit group
  auto stage_round = [&](int rd, float4* buf) {
    const int k0 = rd * kChunks;
    const int nslot = min(kChunks, nchunks - k0) * W;
    for (int p = threadIdx.x; p < nslot; p += kBlockedThreads) {
      const int col = list.template col<W>(t, meta, k0 + p / W) + p % W;
      if constexpr (FUSED) {
        cp_async16(buf + p, pack + col);
      } else {
        cp_async4(&buf[p].x, strip + col);
        cp_async4(&buf[p].y, strip + ncols + col);
        cp_async4(&buf[p].z, strip + 2 * ncols + col);
      }
    }
    cp_async_commit();
  };

  const int lane = threadIdx.x % L;
  const int rep = (blockIdx.x / kNsub) * kReps + threadIdx.x / L;
  float ax[R], ay[R], az[R], p6s[R], gx[R], gy[R], gz[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = (t << kSubShift) + lane + q * L;
    ax[q] = rows[r];
    ay[q] = rows[kRows + r];
    az[q] = rows[2 * kRows + r];
    p6s[q] = gx[q] = gy[q] = gz[q] = 0.f;
  }
  const int nrounds = (nchunks + kChunks - 1) / kChunks;
  if (nrounds > 0) stage_round(0, stage[0]);
#pragma unroll 1
  for (int rd = 0; rd < nrounds; ++rd) {
    if (rd + 1 < nrounds) {
      stage_round(rd + 1, stage[(rd + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* buf = stage[rd & 1];
    const int nch = min(kChunks, nchunks - rd * kChunks);
    if constexpr (W == 1) {
      blocked_pairs<R>(buf, nch, ax, ay, az, h, hh, eps2, p6s, gx, gy, gz);
    } else {
#pragma unroll 1
      for (int k = 0; k < nch; ++k) {
        float c0[R], c1[R], c2[R], c3[R];
#pragma unroll
        for (int q = 0; q < R; ++q) c0[q] = c1[q] = c2[q] = c3[q] = 0.f;
        blocked_pairs<R>(buf + k * W, W, ax, ay, az, h, hh, eps2, c0, c1, c2, c3);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          p6s[q] += c0[q];
          gx[q] += c1[q];
          gy[q] += c2[q];
          gz[q] += c3[q];
        }
      }
    }
    __syncthreads();  // before round rd + 2 is staged into this buffer
  }
  if (rep < nblocks) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = (t << kSubShift) + lane + q * L;
      out[rep * kRows + r] =
          epilogue(rows, r, p6s[q], gx[q], gy[q], gz[q], p6f, c_grad, rho_recip, cfm);
    }
  }
}

// window_flat: tbl[t*stride] = count, then the chunk offsets.
template <int W, bool FUSED>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const int* __restrict__ tbl, int stride, const float* __restrict__ rows,
                const float* __restrict__ strip, const float4* __restrict__ pack, int ncols,
                int n, float h, float hh, float eps2, float p6f, float c_grad,
                float rho_recip, float cfm, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Row w = row_of(rows, i);
  const int* __restrict__ tt = tbl + w.t * stride;
  const int cnt = tt[0];
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
  for (int c = 0; c < cnt; ++c) {
    chunk<W, FUSED>(strip, pack, ncols, tt[1 + c], w, h, hh, eps2, p6s, gx, gy, gz);
  }
  out[i] = epilogue(rows, w.r, p6s, gx, gy, gz, p6f, c_grad, rho_recip, cfm);
}

// window_static: nwin windows of nper chunks at computed offsets.
template <int W>
__global__ void __launch_bounds__(kThreads)
    static_kernel(const float* __restrict__ rows, const float4* __restrict__ pack, int nwin,
                  int nper, int n, float h, float hh, float eps2, float p6f, float c_grad,
                  float rho_recip, float cfm, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Row w = row_of(rows, i);
  float p6s = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll 1
  for (int s = 0; s < nwin; ++s) {
    const int base = ((s * 7 + w.t) % kSpan) * nper * W;
    for (int c = 0; c < nper; ++c) {
      chunk<W, true>(nullptr, pack, 0, base + c * W, w, h, hh, eps2, p6s, gx, gy, gz);
    }
  }
  out[i] = epilogue(rows, w.r, p6s, gx, gy, gz, p6f, c_grad, rho_recip, cfm);
}

int blocks_of(int n) { return (n + kThreads - 1) / kThreads; }

template <bool GUARDED>
int launch_window(const void* wins, const void* rows, const void* cand, int ncols, int smax,
                  int width, int fused, int n, float h, float hh, float eps2, float p6f,
                  float c_grad, float rho_recip, float cfm, void* out, void* stream) {
  using Fn = void (*)(const int*, const float*, const float*, const float4*, int, int, int,
                      float, float, float, float, float, float, float, float*);
  Fn kernel = nullptr;
  if (width == 128) {
    kernel = fused ? window_kernel<128, GUARDED, true> : window_kernel<128, GUARDED, false>;
  }
  if (width == 1) {
    kernel = fused ? window_kernel<1, GUARDED, true> : window_kernel<1, GUARDED, false>;
  }
  if (kernel == nullptr || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)wins, (const float*)rows, fused ? nullptr : (const float*)cand,
        fused ? (const float4*)cand : nullptr, ncols, smax, n, h, hh, eps2, p6f, c_grad,
        rho_recip, cfm, (float*)out);
  }
  return (int)cudaGetLastError();
}

// The blocked instance of `list` at width W: fused, or split where the
// original has split loads; nullptr otherwise.
template <int W, class List>
auto blocked_instance(int fused) {
  if constexpr (List::kSplit) {
    return fused ? window_blocked_kernel<W, List, true> : window_blocked_kernel<W, List, false>;
  } else {
    return fused ? window_blocked_kernel<W, List, true> : nullptr;
  }
}

// n = nblocks x 1024 outputs, a CTA a sub-block of kReps replica blocks.
template <class List>
int launch_blocked(const List& list, const void* rows, const void* cand, int ncols, int width,
                   int fused, int n, float h, float hh, float eps2, float p6f, float c_grad,
                   float rho_recip, float cfm, void* out, void* stream) {
  using Fn = void (*)(List, const float*, const float*, const float4*, int, int, float, float,
                      float, float, float, float, float, float*);
  Fn kernel = nullptr;
  if (width == 128) kernel = blocked_instance<128, List>(fused);
  if (width == 1) kernel = blocked_instance<1, List>(fused);
  if (kernel == nullptr || n < 0 || n % kRows != 0 ||
      (fused && reinterpret_cast<uintptr_t>(cand) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kReps = kBlockedThreads * kBlockedRows / (1 << kSubShift);
  const int nblocks = n / kRows;
  if (nblocks > 0) {
    kernel<<<kNsub * ((nblocks + kReps - 1) / kReps), kBlockedThreads, 0,
             (cudaStream_t)stream>>>(list, (const float*)rows,
                                     fused ? nullptr : (const float*)cand,
                                     fused ? (const float4*)cand : nullptr, ncols, nblocks, h,
                                     hh, eps2, p6f, c_grad, rho_recip, cfm, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cand is the (4, ncols) strip for split loads, the (ncols, 4) pack for
// fused ones, in every launcher that takes `fused`.
int window_prod(const void* wins, const void* rows, const void* cand, int ncols, int smax,
                int width, int fused, int n, float h, float hh, float eps2, float p6f,
                float c_grad, float rho_recip, float cfm, void* out, void* stream) {
  return launch_window<false>(wins, rows, cand, ncols, smax, width, fused, n, h, hh, eps2, p6f,
                              c_grad, rho_recip, cfm, out, stream);
}

int window_guarded(const void* wins, const void* rows, const void* cand, int ncols, int smax,
                   int width, int fused, int n, float h, float hh, float eps2, float p6f,
                   float c_grad, float rho_recip, float cfm, void* out, void* stream) {
  return launch_window<true>(wins, rows, cand, ncols, smax, width, fused, n, h, hh, eps2, p6f,
                             c_grad, rho_recip, cfm, out, stream);
}

// The blocked kernels take window_prod's / window_guarded's arguments; n must
// be a multiple of 1024, and the pack (fused) 16-byte aligned.
int window_prod_blocked(const void* wins, const void* rows, const void* cand, int ncols,
                        int smax, int width, int fused, int n, float h, float hh, float eps2,
                        float p6f, float c_grad, float rho_recip, float cfm, void* out,
                        void* stream) {
  return launch_blocked(WindowList<false>{(const int*)wins, smax}, rows, cand, ncols, width,
                        fused, n, h, hh, eps2, p6f, c_grad, rho_recip, cfm, out, stream);
}

int window_guarded_blocked(const void* wins, const void* rows, const void* cand, int ncols,
                           int smax, int width, int fused, int n, float h, float hh,
                           float eps2, float p6f, float c_grad, float rho_recip, float cfm,
                           void* out, void* stream) {
  return launch_blocked(WindowList<true>{(const int*)wins, smax}, rows, cand, ncols, width,
                        fused, n, h, hh, eps2, p6f, c_grad, rho_recip, cfm, out, stream);
}

int window_flat(const void* tbl, int stride, const void* rows, const void* cand, int ncols,
                int width, int fused, int n, float h, float hh, float eps2, float p6f,
                float c_grad, float rho_recip, float cfm, void* out, void* stream) {
  using Fn = void (*)(const int*, int, const float*, const float*, const float4*, int, int,
                      float, float, float, float, float, float, float, float*);
  Fn kernel = nullptr;
  if (width == 128) kernel = fused ? flat_kernel<128, true> : flat_kernel<128, false>;
  if (width == 1) kernel = fused ? flat_kernel<1, true> : flat_kernel<1, false>;
  if (kernel == nullptr || n < 0 || stride < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)tbl, stride, (const float*)rows, fused ? nullptr : (const float*)cand,
        fused ? (const float4*)cand : nullptr, ncols, n, h, hh, eps2, p6f, c_grad, rho_recip,
        cfm, (float*)out);
  }
  return (int)cudaGetLastError();
}

int window_static(const void* rows, const void* pack, int nwin, int nper, int width, int n,
                  float h, float hh, float eps2, float p6f, float c_grad, float rho_recip,
                  float cfm, void* out, void* stream) {
  using Fn = void (*)(const float*, const float4*, int, int, int, float, float, float, float,
                      float, float, float, float*);
  Fn kernel = nullptr;
  if (width == 128) kernel = static_kernel<128>;
  if (width == 1) kernel = static_kernel<1>;
  if (kernel == nullptr || n < 0 || nwin < 0 || nper < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const float4*)pack, nwin, nper, n, h, hh, eps2, p6f, c_grad,
        rho_recip, cfm, (float*)out);
  }
  return (int)cudaGetLastError();
}

// The blocked flat and static kernels take window_flat's / window_static's
// arguments, with the same rules on n and the pack as the other two.
int window_flat_blocked(const void* tbl, int stride, const void* rows, const void* cand,
                        int ncols, int width, int fused, int n, float h, float hh, float eps2,
                        float p6f, float c_grad, float rho_recip, float cfm, void* out,
                        void* stream) {
  if (stride < 1) return (int)cudaErrorInvalidValue;
  return launch_blocked(FlatList{(const int*)tbl, stride}, rows, cand, ncols, width, fused, n,
                        h, hh, eps2, p6f, c_grad, rho_recip, cfm, out, stream);
}

int window_static_blocked(const void* rows, const void* pack, int nwin, int nper, int width,
                          int n, float h, float hh, float eps2, float p6f, float c_grad,
                          float rho_recip, float cfm, void* out, void* stream) {
  if (nwin < 0 || nper < 0) return (int)cudaErrorInvalidValue;
  return launch_blocked(StaticList{nwin, nper}, rows, pack, 0, width, 1, n, h, hh, eps2, p6f,
                        c_grad, rho_recip, cfm, out, stream);
}

}  // extern "C"
