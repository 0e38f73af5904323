// The final step of the fused SuperGlue matcher: pair scores into the
// dustbin coupling, log-domain Sinkhorn, and mutual-max match extraction.
//
// Replaces the last grid step (s == L2) of
//   posediffusion_tpu/ops/superglue_kernel.py  _superglue_kernel, as run by
//                                              fused_match_pairs (:285)
// whose GNN layers run on csrc/linear.cu and csrc/attention.cu (key bias).
//
// Layout: m is (C, 2, K, D) float32, the final projections of both keypoint
// sets of C pairs; masks are (C, K) float32 0/1. The coupling, and the log
// assignment Z, are (C, K + 1, K + 1): rows and columns 0..K-1 are the
// keypoints, row and column K the dustbin. The TPU kernel pads them to
// K + 8 for its (8, 128) tiling; Hopper needs no such padding, so there is
// none (the padded cells are -1e9 there and change no sum).
//   coupling[i, j] = valid0[i] & valid1[j] ? m0[i] . m1[j] / sqrt(D) : -1e9
//   coupling[i, K] = valid0[i] ? bin : -1e9, coupling[K, j] likewise,
//   coupling[K, K] = bin;
//   norm = -log(ms + ns), log_mu = (valid0 ? norm : -1e9 | log ns + norm),
//   log_nu = (valid1 ? norm : -1e9 | log ms + norm);
//   iters x { u = log_mu - lse_j(cpl + v); v = log_nu - lse_i(cpl + u) }
//   Z = cpl + u + v - norm.
// Matches: over the live block (valid0[i] & valid1[j]), row i matches
// j = its first argmax when i is column j's first argmax and exp(Z[i, j]) >
// threshold. That is the mutual check of the reference match_pair and of
// match_pairs_batched_xla. The TPU kernel's gather-free both-argmax
// (:262-275) differs on exact ties: two rows that tie for a column's maximum
// both match it there. Random weights collapse tokens into such ties, so
// the port follows the reference; the one gather (a column's argmax) is a
// single load per row here.
//
// Bound: at K = 1,024 and C = 32 pairs the scores are 17 GFLOP (FMA tiles,
// 64 x 64 per block, as csrc/linear.cu's FMA route, B read transposed), and
// each Sinkhorn half-iteration streams the 134 MB coupling once from HBM
// (it does not fit the 50 MB L2): 100 passes, bound by memory bandwidth and
// expf. Design, simple first: one launch per half-iteration, one warp per
// row (coalesced) or 32 columns per block with 8 warps splitting the rows
// (coalesced across the columns), an online log-sum-exp per lane merged
// across lanes. No tensor cores, TMA or fusion of the passes yet.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e9f;      // a masked cell, as the JAX package's _NEG
constexpr float kDead = -3e38f;    // outside the live block in match extraction
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- (a) scores: S = m0 m1^T / sqrt(D), masked, into the coupling
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int TX = BN / TN, TY = BM / TM;
static_assert(TX * TY == kThreads, "tile / thread mismatch");

__global__ void __launch_bounds__(kThreads)
sg_scores_kernel(const float* __restrict__ m, const float* __restrict__ mask0,
                 const float* __restrict__ mask1, float* __restrict__ cpl,
                 int K, int D, float sqrt_d) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int c = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const float* A = m + (size_t)c * 2 * K * D;  // set 0
  const float* B = A + (size_t)K * D;          // set 1

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK, k = k0 + kk;
      const int i = i0 + r, j = j0 + r;
      As[kk][r] = (i < K && k < D) ? A[(size_t)i * D + k] : 0.f;
      Bs[kk][r] = (j < K && k < D) ? B[(size_t)j * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t K1 = (size_t)K + 1;
  float* out = cpl + (size_t)c * K1 * K1;
  const float* v0 = mask0 + (size_t)c * K;
  const float* v1 = mask1 + (size_t)c * K;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i0 + ty + i * TY;
    if (row >= K) continue;
    const bool row_ok = v0[row] > 0.5f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tx + j * TX;
      if (col >= K) continue;
      out[row * K1 + col] = (row_ok && v1[col] > 0.5f) ? acc[i][j] / sqrt_d : kNeg;
    }
  }
}

// Dustbin row and column of the coupling, and the marginals; one block a pair.
__global__ void __launch_bounds__(kThreads)
sg_marginals_kernel(const float* __restrict__ mask0, const float* __restrict__ mask1,
                    const float* __restrict__ bin, float* __restrict__ cpl,
                    float* __restrict__ log_mu, float* __restrict__ log_nu,
                    float* __restrict__ norm, int K) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x;
  const size_t K1 = (size_t)K + 1;
  const float* v0 = mask0 + (size_t)c * K;
  const float* v1 = mask1 + (size_t)c * K;
  float s0 = 0.f, s1 = 0.f;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    s0 += v0[i] > 0.5f ? 1.f : 0.f;
    s1 += v1[i] > 0.5f ? 1.f : 0.f;
  }
  const float ms = block_sum(s0, red);  // counts: exact in any order
  const float ns = block_sum(s1, red);
  const float nrm = -logf(ms + ns);
  const float b = bin[0];
  float* out = cpl + (size_t)c * K1 * K1;
  float* mu = log_mu + (size_t)c * K1;
  float* nu = log_nu + (size_t)c * K1;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const bool ok0 = v0[i] > 0.5f, ok1 = v1[i] > 0.5f;
    mu[i] = ok0 ? nrm : kNeg;
    nu[i] = ok1 ? nrm : kNeg;
    out[i * K1 + K] = ok0 ? b : kNeg;
    out[K * K1 + i] = ok1 ? b : kNeg;
  }
  if (threadIdx.x == 0) {
    mu[K] = logf(ns) + nrm;
    nu[K] = logf(ms) + nrm;
    out[K * K1 + K] = b;
    norm[c] = nrm;
  }
}

// ---- (b) Sinkhorn
// Online log-sum-exp of one lane: (m, s) with s = sum exp(x - m).
__device__ __forceinline__ void lse_push(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

// u[i] = log_mu[i] - lse_j(cpl[i, j] + v[j]): one warp a row.
__global__ void __launch_bounds__(kThreads)
sg_sinkhorn_rows_kernel(const float* __restrict__ cpl, const float* __restrict__ log_mu,
                        const float* __restrict__ v, float* __restrict__ u, int K1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, row = blockIdx.x * kWarps + warp;
  if (row >= K1) return;  // whole warps leave; no block barrier follows
  const float* r = cpl + ((size_t)c * K1 + row) * K1;
  const float* vc = v + (size_t)c * K1;
  float m = -INFINITY, s = 0.f;
  for (int j = lane; j < K1; j += 32) lse_push(r[j] + vc[j], m, s);
  const float mx = warp_max(m);
  s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - mx));
  if (lane == 0) u[(size_t)c * K1 + row] = log_mu[(size_t)c * K1 + row] - (mx + logf(s));
}

// v[j] = log_nu[j] - lse_i(cpl[i, j] + u[i]): 32 columns a block, the rows
// split over its 8 warps, partials merged through shared memory.
__global__ void __launch_bounds__(kThreads)
sg_sinkhorn_cols_kernel(const float* __restrict__ cpl, const float* __restrict__ log_nu,
                        const float* __restrict__ u, float* __restrict__ v, int K1) {
  __shared__ float pm[kWarps][33], ps[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, col = blockIdx.x * 32 + lane;
  const float* base = cpl + (size_t)c * K1 * K1;
  const float* uc = u + (size_t)c * K1;
  float m = -INFINITY, s = 0.f;
  if (col < K1)
    for (int i = warp; i < K1; i += kWarps) lse_push(base[(size_t)i * K1 + col] + uc[i], m, s);
  pm[warp][lane] = m;
  ps[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= K1) return;
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w][lane]);
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    tot += pm[w][lane] == -INFINITY ? 0.f : ps[w][lane] * expf(pm[w][lane] - mx);
  v[(size_t)c * K1 + col] = log_nu[(size_t)c * K1 + col] - (mx + logf(tot));
}

// Z = cpl + u + v - norm over the whole (C, K1, K1) tensor.
__global__ void __launch_bounds__(kThreads)
sg_assign_kernel(const float* __restrict__ cpl, const float* __restrict__ u,
                 const float* __restrict__ v, const float* __restrict__ norm,
                 float* __restrict__ Z, int C, int K1) {
  const size_t per = (size_t)K1 * K1, total = per * C;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const size_t c = e / per, ij = e % per, i = ij / K1, j = ij % K1;
    Z[e] = cpl[e] + u[c * K1 + i] + v[c * K1 + j] - norm[c];
  }
}

// ---- (c) mutual-max matches
// First argmax of each column of Z over the live block; 32 columns a block,
// the rows split over its 8 warps.
__global__ void __launch_bounds__(kThreads)
sg_colarg_kernel(const float* __restrict__ Z, const float* __restrict__ mask0,
                 const float* __restrict__ mask1, int* __restrict__ colarg, int K) {
  __shared__ float pm[kWarps][33];
  __shared__ int pa[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, col = blockIdx.x * 32 + lane;
  const size_t K1 = (size_t)K + 1;
  const float* zc = Z + (size_t)c * K1 * K1;
  const float* v0 = mask0 + (size_t)c * K;
  const bool col_ok = col < K && mask1[(size_t)c * K + col] > 0.5f;
  float best = kDead;
  int arg = K;  // past every row: loses every tie below
  if (col_ok)
    for (int i = warp; i < K; i += kWarps)
      if (v0[i] > 0.5f && zc[i * K1 + col] > best) {  // strict: the first maximum
        best = zc[i * K1 + col];
        arg = i;
      }
  pm[warp][lane] = best;
  pa[warp][lane] = arg;
  __syncthreads();
  if (warp != 0 || col >= K) return;
  for (int w = 1; w < kWarps; ++w)
    if (pm[w][lane] > best || (pm[w][lane] == best && pa[w][lane] < arg)) {
      best = pm[w][lane];
      arg = pa[w][lane];
    }
  colarg[(size_t)c * K + col] = arg;
}

// One warp a row: its row max and first argmax over the live block; the row
// is a mutual match when that column's first argmax is the row.
__global__ void __launch_bounds__(kThreads)
sg_rowmatch_kernel(const float* __restrict__ Z, const float* __restrict__ mask0,
                   const float* __restrict__ mask1, const int* __restrict__ colarg,
                   int* __restrict__ matches, float* __restrict__ mscores, int K,
                   float threshold) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, row = blockIdx.x * kWarps + warp;
  if (row >= K) return;
  const size_t K1 = (size_t)K + 1;
  const float* zr = Z + ((size_t)c * K1 + row) * K1;
  const float* v1 = mask1 + (size_t)c * K;
  const bool row_ok = mask0[(size_t)c * K + row] > 0.5f;
  float best = kDead;
  int arg = K;  // past every column: loses every tie below
  if (row_ok)
    for (int j = lane; j < K; j += 32)
      if (v1[j] > 0.5f && zr[j] > best) {  // strict: a lane keeps its first maximum
        best = zr[j];
        arg = j;
      }
  const float rowmax = warp_max(best);
  int idx = best == rowmax ? arg : K;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, o));
  if (lane != 0) return;
  // idx == K: no live cell in the row, so no match
  const bool mutual = idx < K && colarg[(size_t)c * K + idx] == row;
  const float score = mutual ? expf(rowmax) : 0.f;
  const bool ok = mutual && score > threshold;
  matches[(size_t)c * K + row] = ok ? idx : -1;
  mscores[(size_t)c * K + row] = ok ? score : 0.f;
}

int blocks_for(size_t n) {
  return (int)(n < (size_t)132 * 64 * kThreads ? (n + kThreads - 1) / kThreads
                                               : (size_t)132 * 64);
}

}  // namespace

PD_API int pd_sg_coupling(const void* m, const void* mask0, const void* mask1,
                          const void* bin, void* cpl, void* log_mu, void* log_nu,
                          void* norm, int C, int K, int D, float sqrt_d,
                          void* stream) {
  if (C < 1 || K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((K + BN - 1) / BN, (K + BM - 1) / BM, C);
  sg_scores_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)m, (const float*)mask0, (const float*)mask1, (float*)cpl, K,
      D, sqrt_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sg_marginals_kernel<<<C, kThreads, 0, s>>>(
      (const float*)mask0, (const float*)mask1, (const float*)bin, (float*)cpl,
      (float*)log_mu, (float*)log_nu, (float*)norm, K);
  return (int)cudaGetLastError();
}

// v must hold the starting column potentials (zeros); u is scratch.
PD_API int pd_sg_sinkhorn(const void* cpl, const void* log_mu, const void* log_nu,
                          const void* norm, void* u, void* v, void* Z, int C,
                          int K1, int iters, void* stream) {
  if (C < 1 || K1 < 2 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 rows((K1 + kWarps - 1) / kWarps, C), cols((K1 + 31) / 32, C);
  for (int it = 0; it < iters; ++it) {
    sg_sinkhorn_rows_kernel<<<rows, kThreads, 0, s>>>(
        (const float*)cpl, (const float*)log_mu, (const float*)v, (float*)u, K1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sg_sinkhorn_cols_kernel<<<cols, kThreads, 0, s>>>(
        (const float*)cpl, (const float*)log_nu, (const float*)u, (float*)v, K1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sg_assign_kernel<<<blocks_for((size_t)C * K1 * K1), kThreads, 0, s>>>(
      (const float*)cpl, (const float*)u, (const float*)v, (const float*)norm,
      (float*)Z, C, K1);
  return (int)cudaGetLastError();
}

// colarg is (C, K) int32 scratch.
PD_API int pd_sg_matches(const void* Z, const void* mask0, const void* mask1,
                         void* colarg, void* matches, void* mscores, int C, int K,
                         float threshold, void* stream) {
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  sg_colarg_kernel<<<dim3((K + 31) / 32, C), kThreads, 0, s>>>(
      (const float*)Z, (const float*)mask0, (const float*)mask1, (int*)colarg, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sg_rowmatch_kernel<<<dim3((K + kWarps - 1) / kWarps, C), kThreads, 0, s>>>(
      (const float*)Z, (const float*)mask0, (const float*)mask1,
      (const int*)colarg, (int*)matches, (float*)mscores, K, threshold);
  return (int)cudaGetLastError();
}
