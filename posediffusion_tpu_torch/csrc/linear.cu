// Tiled GEMM with a fused epilogue: y = epi(a @ W + bias) [+ residual].
//
// Replaces every matrix product inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (qkv, proj,
//                                              fc1 + exact-erf GELU, fc2)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (in_proj,
//                                              out_proj, linear1 + ReLU,
//                                              linear2), as run by
//   posediffusion_tpu/ops/sampler_kernel.py    _sampler_kernel
//
// a is (M, K) float32, W is (K, N) float32 or bfloat16 (the layout of the
// JAX weight stacks), bias (N,) float32, residual and y (M, N) float32.
// round_a rounds a to bfloat16 as it is staged, which is the cast(...) of
// the TPU kernel's bf16-activation mode.
//
// Bound: in the ViT (M = 20 frames x 264 tokens = 5280 rows, K <= 1536) the
// products are compute-bound; in the sampler (M = 20 rows) they read a few
// MB of weights for a few MFLOP and are bound by memory and launch latency.
// Design: two kernels, chosen by the operand types.
//   * bf16 a and bf16 W: WMMA bfloat16 tensor-core tiles (64 x 64 per block,
//     four warps of 32 x 32), f32 accumulation in the fragments, the
//     epilogue from a shared-memory copy of the tile.
//   * float32 a (bf16 or f32 W): FMA tiles staged through shared memory, W
//     widened to float32 as it is staged, so the products are those of the
//     JAX kernel's f32 dot with a bf16 weight. A 32 x 32 tile for small M
//     keeps more blocks in flight for the sampler's 20-row products.
// No wgmma, TMA or multi-stage pipeline yet: correct first, fast later.
#include <mma.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float epilogue(float v, int act) {
  if (act == ACT_RELU) {
    v = fmaxf(v, 0.f);
  } else if (act == ACT_GELU) {
    // exact GELU (torch nn.GELU): 0.5 x (1 + erf(x / sqrt(2)))
    v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  }
  return v;
}

constexpr int FMA_BK = 16;
constexpr int FMA_THREADS = 256;

template <typename WT, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(FMA_THREADS)
linear_fma_kernel(const float* __restrict__ A, const WT* __restrict__ W,
                  const float* __restrict__ bias, const float* res,
                  float* y, int M, int N, int K, int round_a, int act) {
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
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Ws[r][c] = (gk < K && gn < N) ? to_float(W[(size_t)gk * N + gn]) : 0.f;
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
      if (n >= N) continue;
      float v = epilogue(acc[i][j] + bias[n], act);
      if (res) v += res[(size_t)m * N + n];
      y[(size_t)m * N + n] = v;
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
                      const __nv_bfloat16* __restrict__ W,
                      const float* __restrict__ bias, const float* res,
                      float* y, int M, int N, int K, int act) {
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
      const int r = i / TC_BN, cc = i % TC_BN;
      const int gk = k0 + r, gn = n0 + cc;
      Ws[r * TC_LDW + cc] = (gk < K && gn < N) ? W[(size_t)gk * N + gn]
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
    if (m >= M || n >= N) continue;
    float v = epilogue(Cs[r * TC_LDC + cc] + bias[n], act);
    if (res) v += res[(size_t)m * N + n];
    y[(size_t)m * N + n] = v;
  }
}

template <typename WT>
void launch_fma(const float* a, const WT* w, const float* bias,
                const float* res, float* y, int M, int N, int K, int round_a,
                int act, cudaStream_t s) {
  if (M <= 32) {
    dim3 grid((N + 31) / 32, (M + 31) / 32);
    linear_fma_kernel<WT, 32, 32, 2, 2><<<grid, FMA_THREADS, 0, s>>>(
        a, w, bias, res, y, M, N, K, round_a, act);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    linear_fma_kernel<WT, 64, 64, 4, 4><<<grid, FMA_THREADS, 0, s>>>(
        a, w, bias, res, y, M, N, K, round_a, act);
  }
}

}  // namespace

PD_API int pd_linear(const void* a, const void* w, int w_bf16,
                     const void* bias, const void* res, void* y, int M, int N,
                     int K, int round_a, int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* A = (const float*)a;
  const float* B = (const float*)bias;
  const float* R = (const float*)res;
  float* Y = (float*)y;
  if (w_bf16 && round_a) {
    dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM);
    linear_bf16_tc_kernel<<<grid, TC_THREADS, 0, s>>>(
        A, (const __nv_bfloat16*)w, B, R, Y, M, N, K, act);
  } else if (w_bf16) {
    launch_fma<__nv_bfloat16>(A, (const __nv_bfloat16*)w, B, R, Y, M, N, K,
                              round_a, act, s);
  } else {
    launch_fma<float>(A, (const float*)w, B, R, Y, M, N, K, round_a, act, s);
  }
  return (int)cudaGetLastError();
}
