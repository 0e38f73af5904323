// Tiled GEMM with a fused epilogue, y = epi(a @ W + bias) [+ residual], and
// the weight gradient of the same product, dW = X^T dY and db = colsum(dY).
//
// Replaces every matrix product inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (qkv, proj,
//                                              fc1 + exact-erf GELU, fc2)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (in_proj,
//                                              out_proj, linear1 + ReLU,
//                                              linear2), as run by
//   posediffusion_tpu/ops/sampler_kernel.py    _sampler_kernel
//   posediffusion_tpu/ops/vit_train_kernel.py  _fwd_call / _bwd_call: the
//                                              forward products with dropout
//                                              at the m1, mff and m2 sites
//                                              (:101), the dgrad products
//                                              dY W^T and the weight
//                                              gradients X^T dY of
//                                              _mlp_residual_bwd (:278) and
//                                              _attn_residual_bwd (:356)
//
// a is (M, K) float32; W is (K, N), or (N, K) read transposed (trans_w: the
// dgrad product dY W^T with W in its forward layout), float32 or bfloat16;
// bias (N,) or null; gain (N,) or null; residual and y (M, N) float32.
// round_a rounds a to bfloat16 as it is staged (the cast(...) of the TPU
// kernels' bf16 mode). The epilogue, in the TPU kernels' order: + bias,
// [pre <- v], activation, x gain[n] (DINOv2's LayerScale, (a@W + b) * ls at
// vit_train_kernel.py:210-212, :238-240), x dropout mask, [round to bf16,
// + residual, round to bf16 when the residual stream is bf16 (round_out)].
//
// Bound: compute. The ViT's train products (M = 512 images x 264 tokens =
// 135,168 rows, K and N 384 to 1,536) are 40-160 GFLOP each; the sampler's
// (M = 20 rows) are bound by memory and launch latency.
// Design: two forward kernels, chosen by the operand types.
//   * bf16 a and bf16 W: WMMA bfloat16 tensor-core tiles (64 x 64 per block,
//     four warps of 32 x 32), f32 accumulation in the fragments, the
//     epilogue from a shared-memory copy of the tile.
//   * float32 a (bf16 or f32 W): FMA tiles staged through shared memory, W
//     widened to float32 as it is staged, so the products are those of the
//     JAX kernel's f32 dot with a bf16 weight. A 32 x 32 tile for small M
//     keeps more blocks in flight for the sampler's 20-row products.
// The weight gradient reduces over all M rows into a small (K, N) result:
// the rows are split into S ranges, one block per (range, 64 x 64 output
// tile) writes an f32 partial (S, K, N), and a second pass (train.cu,
// pd_sum_partials) sums the S partials in order. That is the TPU kernel's
// per-batch-chunk partials (:937-940): deterministic, no atomics. It has the
// same FMA and WMMA modes; db is the column sum of dY in the same pass.
// No wgmma, TMA or multi-stage pipeline yet: correct first, fast later.
#include <mma.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU) return gelu_f(v);
  return v;
}

struct Epilogue {
  const float* bias;
  const float* gain;
  const float* res;
  float* y;
  float* pre;
  int act;
  int round_out;
  DropArgs drop;

  __device__ __forceinline__ void store(float acc, int m, int n, int N) const {
    const size_t idx = (size_t)m * N + n;
    float v = acc + (bias ? bias[n] : 0.f);
    if (pre) pre[idx] = v;
    v = activate(v, act);
    if (gain) v *= gain[n];
    v *= drop_mul(drop, (unsigned int)idx);
    if (res) {
      if (round_out) v = round_bf16(v);
      v += res[idx];
      if (round_out) v = round_bf16(v);
    }
    y[idx] = v;
  }
};

// W element (k, n) of the product's (K, N) operand.
template <typename WT>
__device__ __forceinline__ float w_at(const WT* W, int k, int n, int K, int N,
                                      int trans) {
  return to_float(trans ? W[(size_t)n * K + k] : W[(size_t)k * N + n]);
}

constexpr int FMA_BK = 16;
constexpr int FMA_THREADS = 256;

template <typename WT, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(FMA_THREADS)
linear_fma_kernel(const float* __restrict__ A, const WT* __restrict__ W,
                  int trans, Epilogue ep, int M, int N, int K, int round_a) {
  static_assert((BM / TM) * (BN / TN) == FMA_THREADS, "tile / thread mismatch");
  constexpr int TX = BN / TN, TY = BM / TM;
  __shared__ float As[FMA_BK][BM + 4];
  __shared__ float Ws[FMA_BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FMA_BK) {
    for (int i = tid; i < BM * FMA_BK; i += FMA_THREADS) {
      const int r = i / FMA_BK, c = i % FMA_BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      if (round_a) v = round_bf16(v);
      As[c][r] = v;
    }
    for (int i = tid; i < FMA_BK * BN; i += FMA_THREADS) {
      // neighbouring threads read neighbouring addresses of either layout
      const int r = trans ? i % FMA_BK : i / BN;
      const int c = trans ? i / FMA_BK : i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? w_at(W, gk, gn, K, N, trans) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FMA_BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) ep.store(acc[i][j], m, n, N);
    }
  }
}

// ---- bf16 x bf16 on the tensor cores (WMMA 16x16x16)
constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 32, TC_THREADS = 128;
constexpr int TC_LDA = TC_BK + 8;   // bf16 elements; rows stay 32-byte aligned
constexpr int TC_LDW = TC_BN + 8;
constexpr int TC_LDC = TC_BN + 4;   // float elements

__global__ void __launch_bounds__(TC_THREADS)
linear_bf16_tc_kernel(const float* __restrict__ A,
                      const __nv_bfloat16* __restrict__ W, int trans,
                      Epilogue ep, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[TC_BM * TC_LDA];
  __shared__ __align__(32) __nv_bfloat16 Ws[TC_BK * TC_LDW];
  __shared__ __align__(32) float Cs[TC_BM * TC_LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 32 x 32
  const int m0 = blockIdx.y * TC_BM, n0 = blockIdx.x * TC_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TC_BK) {
    for (int i = tid; i < TC_BM * TC_BK; i += TC_THREADS) {
      const int r = i / TC_BK, cc = i % TC_BK;
      const int gm = m0 + r, gk = k0 + cc;
      const float v = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      As[r * TC_LDA + cc] = __float2bfloat16_rn(v);
    }
    for (int i = tid; i < TC_BK * TC_BN; i += TC_THREADS) {
      const int r = trans ? i % TC_BK : i / TC_BN;
      const int cc = trans ? i / TC_BK : i % TC_BN;
      const int gk = k0 + r, gn = n0 + cc;
      Ws[r * TC_LDW + cc] =
          (gk < K && gn < N)
              ? (trans ? W[(size_t)gn * K + gk] : W[(size_t)gk * N + gn])
              : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * TC_LDA + kk,
                               TC_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Ws + kk * TC_LDW + wn * 32 + j * 16,
                               TC_LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * TC_LDC + wn * 32 + j * 16,
                              c[i][j], TC_LDC, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < TC_BM * TC_BN; i += TC_THREADS) {
    const int r = i / TC_BN, cc = i % TC_BN;
    const int m = m0 + r, n = n0 + cc;
    if (m < M && n < N) ep.store(Cs[r * TC_LDC + cc], m, n, N);
  }
}

template <typename WT>
void launch_fma(const float* a, const WT* w, int trans, const Epilogue& ep,
                int M, int N, int K, int round_a, cudaStream_t s) {
  if (M <= 32) {
    dim3 grid((N + 31) / 32, (M + 31) / 32);
    linear_fma_kernel<WT, 32, 32, 2, 2><<<grid, FMA_THREADS, 0, s>>>(
        a, w, trans, ep, M, N, K, round_a);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    linear_fma_kernel<WT, 64, 64, 4, 4><<<grid, FMA_THREADS, 0, s>>>(
        a, w, trans, ep, M, N, K, round_a);
  }
}

// ---- weight gradient: partial[s] = X[rows of s]^T dY[rows of s]
//
// Block (n tile, k tile, split s). X is (M, K), dY (M, N); the partial
// (S, K, N) and, from the blocks of k tile 0, the bias partial (S, N). The
// bias sum rides the staging of dY: a thread stages the same column of
// every tile (the block size is a multiple of the tile width), so it keeps
// that column's running sum of the unrounded values in a register; the
// THREADS / BN sums of a column are then added in a fixed order.
template <int BN, int THREADS>
__device__ void bias_partial(float bacc, float* red, float* pb, int n0, int N) {
  red[threadIdx.x] = bacc;
  __syncthreads();
  if (threadIdx.x < BN && n0 + (int)threadIdx.x < N) {
    float s = 0.f;
    for (int j = threadIdx.x; j < THREADS; j += BN) s += red[j];
    pb[n0 + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(FMA_THREADS)
wgrad_fma_kernel(const float* __restrict__ X, const float* __restrict__ dY,
                 float* __restrict__ pw, float* __restrict__ pb, int M, int K,
                 int N, int rows, int round_in) {
  constexpr int BM = 64, BN = 64, TM = 4, TN = 4;  // BM: rows of dW (k)
  constexpr int TX = BN / TN, TY = BM / TM;
  __shared__ float Xs[FMA_BK][BM + 4];
  __shared__ float Ds[FMA_BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, s = blockIdx.z;
  const int r0 = s * rows, r1 = min(M, r0 + rows);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float bacc = 0.f;  // column tid % BN of dY, this thread's rows
  for (int m0 = r0; m0 < r1; m0 += FMA_BK) {
    for (int i = tid; i < FMA_BK * BM; i += FMA_THREADS) {
      const int mm = i / BM, c = i % BM;
      const int gm = m0 + mm, gk = k0 + c;
      float v = (gm < r1 && gk < K) ? X[(size_t)gm * K + gk] : 0.f;
      Xs[mm][c] = round_in ? round_bf16(v) : v;
    }
    for (int i = tid; i < FMA_BK * BN; i += FMA_THREADS) {
      const int mm = i / BN, c = i % BN;
      const int gm = m0 + mm, gn = n0 + c;
      float v = (gm < r1 && gn < N) ? dY[(size_t)gm * N + gn] : 0.f;
      bacc += v;
      Ds[mm][c] = round_in ? round_bf16(v) : v;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < FMA_BK; ++mm) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Xs[mm][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ds[mm][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = pw + (size_t)s * K * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty + i * TY;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) out[(size_t)k * N + n] = acc[i][j];
    }
  }
  if (pb && blockIdx.y == 0) {
    __syncthreads();
    bias_partial<BN, FMA_THREADS>(bacc, &Xs[0][0], pb + (size_t)s * N, n0, N);
  }
}

__global__ void __launch_bounds__(TC_THREADS)
wgrad_bf16_tc_kernel(const float* __restrict__ X, const float* __restrict__ dY,
                     float* __restrict__ pw, float* __restrict__ pb, int M,
                     int K, int N, int rows) {
  using namespace nvcuda;
  constexpr int LDX = TC_BM + 8, LDD = TC_BN + 8;  // bf16 elements
  __shared__ __align__(32) __nv_bfloat16 Xs[TC_BK * LDX];  // [m][k]
  __shared__ __align__(32) __nv_bfloat16 Ds[TC_BK * LDD];  // [m][n]
  __shared__ __align__(32) float Cs[TC_BM * TC_LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * TC_BN, k0 = blockIdx.y * TC_BM, s = blockIdx.z;
  const int r0 = s * rows, r1 = min(M, r0 + rows);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);

  float bacc = 0.f;  // column tid % TC_BN of dY, unrounded, this thread's rows
  for (int m0 = r0; m0 < r1; m0 += TC_BK) {
    for (int i = tid; i < TC_BK * TC_BM; i += TC_THREADS) {
      const int mm = i / TC_BM, cc = i % TC_BM;
      const int gm = m0 + mm, gk = k0 + cc;
      Xs[mm * LDX + cc] = __float2bfloat16_rn(
          (gm < r1 && gk < K) ? X[(size_t)gm * K + gk] : 0.f);
    }
    for (int i = tid; i < TC_BK * TC_BN; i += TC_THREADS) {
      const int mm = i / TC_BN, cc = i % TC_BN;
      const int gm = m0 + mm, gn = n0 + cc;
      const float v = (gm < r1 && gn < N) ? dY[(size_t)gm * N + gn] : 0.f;
      bacc += v;
      Ds[mm * LDD + cc] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      // A = X^T: element (k, m) at Xs[m * LDX + k], a column-major tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Xs + kk * LDX + wm * 32 + i * 16, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Ds + kk * LDD + wn * 32 + j * 16, LDD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * TC_LDC + wn * 32 + j * 16,
                              c[i][j], TC_LDC, wmma::mem_row_major);
  __syncthreads();
  float* out = pw + (size_t)s * K * N;
  for (int i = tid; i < TC_BM * TC_BN; i += TC_THREADS) {
    const int r = i / TC_BN, cc = i % TC_BN;
    const int k = k0 + r, n = n0 + cc;
    if (k < K && n < N) out[(size_t)k * N + n] = Cs[r * TC_LDC + cc];
  }
  if (pb && blockIdx.y == 0) {
    __syncthreads();
    bias_partial<TC_BN, TC_THREADS>(bacc, Cs, pb + (size_t)s * N, n0, N);
  }
}

}  // namespace

PD_API int pd_linear(const void* a, const void* w, int w_bf16, int trans_w,
                     const void* bias, const void* gain, const void* res,
                     void* y, void* pre,
                     int M, int N, int K, int round_a, int act,
                     unsigned int drop_key, int drop_thr, float drop_scale,
                     int round_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* A = (const float*)a;
  Epilogue ep{(const float*)bias, (const float*)gain, (const float*)res,
              (float*)y, (float*)pre, act, round_out,
              DropArgs{drop_key, drop_thr, drop_scale}};
  if (w_bf16 && round_a) {
    dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
    linear_bf16_tc_kernel<<<grid, TC_THREADS, 0, s>>>(
        A, (const __nv_bfloat16*)w, trans_w, ep, M, N, K);
  } else if (w_bf16) {
    launch_fma<__nv_bfloat16>(A, (const __nv_bfloat16*)w, trans_w, ep, M, N,
                              K, round_a, s);
  } else {
    launch_fma<float>(A, (const float*)w, trans_w, ep, M, N, K, round_a, s);
  }
  return (int)cudaGetLastError();
}

// X (M, K), dY (M, N) -> partials pw (S, K, N) and pb (S, N) (pb may be
// null), S = ceil(M / rows). round_in: both operands rounded to bf16 on the
// tensor cores (the bf16 mode); else float32 FMA.
PD_API int pd_linear_wgrad(const void* x, const void* dy, void* pw, void* pb,
                           int M, int K, int N, int rows, int round_in,
                           void* stream) {
  if (rows < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = (M + rows - 1) / rows;
  dim3 grid((N + 63) / 64, (K + 63) / 64, S);
  if (round_in) {
    wgrad_bf16_tc_kernel<<<grid, TC_THREADS, 0, s>>>(
        (const float*)x, (const float*)dy, (float*)pw, (float*)pb, M, K, N, rows);
  } else {
    wgrad_fma_kernel<<<grid, FMA_THREADS, 0, s>>>(
        (const float*)x, (const float*)dy, (float*)pw, (float*)pb, M, K, N,
        rows, 0);
  }
  return (int)cudaGetLastError();
}
