// Tiled lambda and delta on cell-sorted particles (sm_90a).
//
// Replaces the `sub`/`mxu` variants of the Pallas TPU kernels in
// pbf_sph_tpu/ops/pallas_pbf.py:
//   pbf_lambda_tile <- make_lambda_call(sub, mxu)  (:391; mxu=True r2 by
//                      _centred_r2_mxu, :351-388)
//   pbf_delta_tile  <- make_delta_call(sub, mxu)   (:491)
// They compute what the plain versions of pbf_sph_tpu_torch/ops/tiles.py
// compute; the fluid mask and the bounds clamp stay in the Python wrappers.
//
// Design: one CTA of four warps per tile of SUB consecutive sorted rows.  The
// tile's nine disjoint windows (ops/tiles.py plan_tiles) are read as one
// sequence of candidates and staged in shared memory kChunk columns at a
// time, as many chunks as the windows hold: no capacity, no overflow.  Past
// the last candidate a slot holds a point 1e9 away, which every geometric
// mask zeroes.  The tile's SUB x kChunk pair block is cut into 8 x 8 blocks:
// lane (g, t) of a warp, g = lane / 4, t = lane % 4, owns pair (row g,
// candidates 2t and 2t+1) of each block, which is the accumulator layout of
// mma.sync m8n8k4.  Warps split the column blocks; each lane keeps the sums of
// its SUB / 8 rows in registers, the four lanes of a row add theirs by quad
// shuffles, and the warps theirs through shared memory in a fixed order.
//
// r2 routes.  MXU=false: per pair in fp32, dx*dx + dy*dy + dz*dz.  MXU=true:
// the centred product of _centred_r2_mxu on the tensor cores.  Rows and
// candidates are translated to the tile's centre (the fp32 mean of all SUB
// rows, summed in fp64 and rounded once), and the 8 x 8 block
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
// row.  wgmma, TMA and asynchronous copies are left for later work.
//
// Every launcher runs on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a SUB that is not instantiated (8, 16, 32, 64).

#include <cuda_runtime.h>

#include "dmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;  // candidate columns staged per pass
constexpr float kFar = 1e9f;

// The pair math of pbf_phases.cu's lambda_kernel; w of a row is its mass.
struct LambdaPair {
  static constexpr int kAcc = 4;  // poly6 sum, gradient x, y, z
  float h, hh, eps2, p6f, c_grad, rho_recip, cfm;

  __device__ __forceinline__ void add(float, float, float dx, float dy,
                                      float dz, float r2, float* acc) const {
    const float d2p = fmaxf(hh - r2, 0.f);
    acc[0] += d2p * d2p * d2p;
    const float r2c = fmaxf(r2, eps2);
    const float u = rsqrtf(r2c);
    const float tt = fmaxf(h - r2c * u, 0.f);
    const float sg = tt * tt * u;
    acc[1] += dx * sg;
    acc[2] += dy * sg;
    acc[3] += dz * sg;
  }

  __device__ __forceinline__ void store(int i, int, bool member, float mass,
                                        const float* s, float* out) const {
    if (!member) {  // memberf = 0: lambda = 1 / CFM
      out[i] = -(0.0f * rho_recip - 1.0f) / (0.0f + cfm);
      return;
    }
    const float rho = mass * (s[0] * p6f);
    const float gx = s[1] * c_grad, gy = s[2] * c_grad, gz = s[3] * c_grad;
    const float norm2 = gx * gx + gy * gy + gz * gz;
    out[i] = -(rho * rho_recip - 1.0f) / (norm2 + cfm);
  }
};

// The pair math of pbf_phases.cu's delta_kernel; w is lambda.
struct DeltaPair {
  static constexpr int kAcc = 3;  // correction x, y, z
  float h, hh, eps2, skf, xqf, corr_k, rho_recip;

  __device__ __forceinline__ void add(float alam, float blam, float dx,
                                      float dy, float dz, float r2,
                                      float* acc) const {
    const float d2p = fmaxf(hh - r2, 0.f);
    const float xq = d2p * d2p * d2p * xqf;
    const float x2 = xq * xq;
    const float corr = corr_k * x2 * x2;
    const float factor = (alam + blam + corr) * rho_recip;
    const float r2c = fmaxf(r2, eps2);
    const float u = rsqrtf(r2c);
    const float tt = fmaxf(h - r2c * u, 0.f);
    const float sg = (skf * (tt * tt) * u) * factor;
    acc[0] += dx * sg;
    acc[1] += dy * sg;
    acc[2] += dz * sg;
  }

  __device__ __forceinline__ void store(int i, int n, bool member, float,
                                        const float* s, float* out) const {
    out[i] = member ? s[0] : 0.f;
    out[n + i] = member ? s[1] : 0.f;
    out[2 * n + i] = member ? s[2] : 0.f;
  }
};

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
        const float dx0 = ax[rb] - b0.x, dy0 = ay[rb] - b0.y, dz0 = az[rb] - b0.z;
        const float dx1 = ax[rb] - b1.x, dy1 = ay[rb] - b1.y, dz1 = az[rb] - b1.z;
        float r20, r21;
        if (MXU) {
          double d0, d1;
          dmma_m8n8k4(afrag[rb], bf, d0, d1);
          r20 = __double2float_rn(d0 + a2[rb]);
          r21 = __double2float_rn(d1 + a2[rb]);
        } else {
          r20 = dx0 * dx0 + dy0 * dy0 + dz0 * dz0;
          r21 = dx1 * dx1 + dy1 * dy1 + dz1 * dz1;
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

template <int SUB, class Pair>
void launch(bool mxu, const void* cand, const void* key, const void* tiles,
            int n, int ncells, const Pair& pair, void* out, cudaStream_t s) {
  const int grid = n / SUB;
  if (mxu) {
    tile_kernel<SUB, true, Pair><<<grid, kThreads, 0, s>>>(
        (const float4*)cand, (const int*)key, (const int*)tiles, n, ncells,
        pair, (float*)out);
  } else {
    tile_kernel<SUB, false, Pair><<<grid, kThreads, 0, s>>>(
        (const float4*)cand, (const int*)key, (const int*)tiles, n, ncells,
        pair, (float*)out);
  }
}

template <class Pair>
int dispatch(int sub, int mxu, const void* cand, const void* key,
             const void* tiles, int n, int ncells, const Pair& pair, void* out,
             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n % sub != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (sub) {
    case 8: launch<8>(mxu, cand, key, tiles, n, ncells, pair, out, s); break;
    case 16: launch<16>(mxu, cand, key, tiles, n, ncells, pair, out, s); break;
    case 32: launch<32>(mxu, cand, key, tiles, n, ncells, pair, out, s); break;
    case 64: launch<64>(mxu, cand, key, tiles, n, ncells, pair, out, s); break;
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
  return dispatch(sub, mxu, cand, key, tiles, n, ncells, pair, lam, stream);
}

int pbf_delta_tile(const void* cand, const void* key, const void* tiles, int n,
                   int ncells, int sub, int mxu, float h, float hh, float eps2,
                   float skf, float xqf, float corr_k, float rho_recip,
                   void* dp, void* stream) {
  const DeltaPair pair{h, hh, eps2, skf, xqf, corr_k, rho_recip};
  return dispatch(sub, mxu, cand, key, tiles, n, ncells, pair, dp, stream);
}

}  // extern "C"
