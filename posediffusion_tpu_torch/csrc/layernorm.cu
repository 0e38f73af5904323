// LayerNorm over the last axis, one warp per row, and its backward.
//
// Replaces the LayerNorms inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (_layer_norm,
//                                              eps 1e-6, bf16 cast of the output
//                                              at :89 and :136)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (_layer_norm,
//                                              eps 1e-5)
//   posediffusion_tpu/ops/vit_train_kernel.py  _ln_bwd (:265-275) inside
//                                              _bwd_call, with the residual
//                                              cotangent added (:353, :488)
//
// Bound: memory. A row is 384 to 768 floats, read three times (mean,
// variance, output) and written once; the second and third reads hit L1.
// Design: a warp owns a row, so the two reductions are register shuffles
// with no shared memory and no block barrier; eps and the bf16 rounding of
// the output are arguments, so both trunks share the one kernel.
// Backward: bound by memory too (x, dh and the residual cotangent read,
// dx written). A warp owns a row again and recomputes mean and rstd from the
// saved input, as _ln_bwd does from _ln_fwd; dg = sum(dh * xhat) and
// db = sum(dh) over rows are kept per lane in registers across the block's
// rows, merged across the block's warps in shared memory in a fixed order,
// and written as one f32 partial per block; train.cu's pd_sum_partials adds
// the partials in order. No atomics, so the result repeats bitwise. A lane
// keeps COLS = ceil(D / 32) columns of its row in registers: the kernel is
// instantiated for D <= 512 (ViT-S, the denoiser), <= 768 (ViT-B) and
// <= 1024; the cross-warp merge reuses one (warps x COLS x 32) shared array
// for dg, then db (32 KB at COLS 32, under the 48 KB of static shared memory).
#include "common.cuh"

__global__ void __launch_bounds__(256)
layernorm_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, float* __restrict__ y, int rows,
                 int D, float eps, int round_out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * D;
  float* yr = y + (size_t)row * D;

  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += xr[d];
  const float mean = warp_sum(s) / (float)D;

  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float t = xr[d] - mean;
    v = fmaf(t, t, v);
  }
  const float var = warp_sum(v) / (float)D;
  const float r = rsqrtf(var + eps);

  for (int d = lane; d < D; d += 32) {
    float o = (xr[d] - mean) * r * g[d] + b[d];
    if (round_out) o = round_bf16(o);
    yr[d] = o;
  }
}

PD_API int pd_layernorm(const void* x, const void* g, const void* b, void* y,
                        int rows, int D, float eps, int round_out,
                        void* stream) {
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  layernorm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)b, (float*)y, rows, D,
      eps, round_out);
  return (int)cudaGetLastError();
}

constexpr int LNB_WARPS = 8;
constexpr int LNB_ROWS_PER_WARP = 16;
constexpr int LNB_MAX_D = 1024;

// dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) + res, with
// dxhat = dh g; per block: dg, db partials over its rows.
template <int COLS>
__global__ void __launch_bounds__(LNB_WARPS * 32)
layernorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ dh, const float* __restrict__ res,
                     float* __restrict__ dx, float* __restrict__ pg,
                     float* __restrict__ pb, int rows, int D, float eps,
                     int round_out) {
  __shared__ float red[LNB_WARPS][COLS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (D + 31) / 32;
  float accg[COLS], accb[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) accg[c] = accb[c] = 0.f;

  const int row0 = (blockIdx.x * LNB_WARPS + warp) * LNB_ROWS_PER_WARP;
  for (int rr = 0; rr < LNB_ROWS_PER_WARP; ++rr) {
    const int row = row0 + rr;
    if (row >= rows) break;
    const float* xr = x + (size_t)row * D;
    const float* dr = dh + (size_t)row * D;
    float xv[COLS], dv[COLS];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      xv[c] = (c < ncol && d < D) ? xr[d] : 0.f;
      s += xv[c];
    }
    const float mean = warp_sum(s) / (float)D;
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (c < ncol && d < D) {
        const float t = xv[c] - mean;
        v = fmaf(t, t, v);
      }
    }
    const float rstd = rsqrtf(warp_sum(v) / (float)D + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (c < ncol && d < D) {
        const float xh = (xv[c] - mean) * rstd;
        const float dhv = dr[d];
        accg[c] = fmaf(dhv, xh, accg[c]);
        accb[c] += dhv;
        dv[c] = dhv * g[d];
        xv[c] = xh;
        s1 += dv[c];
        s2 = fmaf(dv[c], xh, s2);
      }
    }
    const float m1 = warp_sum(s1) / (float)D, m2 = warp_sum(s2) / (float)D;
    float* out = dx + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = lane + 32 * c;
      if (c < ncol && d < D) {
        float o = rstd * (dv[c] - m1 - xv[c] * m2);
        if (res) o += res[(size_t)row * D + d];
        out[d] = round_out ? round_bf16(o) : o;
      }
    }
  }
  // dg, then db: the warps' partials of column d (lane d % 32, register
  // d / 32) added in warp order
#pragma unroll
  for (int c = 0; c < COLS; ++c) red[warp][c * 32 + lane] = accg[c];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float sg = 0.f;
    for (int w = 0; w < LNB_WARPS; ++w) sg += red[w][d];
    pg[(size_t)blockIdx.x * D + d] = sg;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < COLS; ++c) red[warp][c * 32 + lane] = accb[c];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float sb = 0.f;
    for (int w = 0; w < LNB_WARPS; ++w) sb += red[w][d];
    pb[(size_t)blockIdx.x * D + d] = sb;
  }
}

// Rows a block of layernorm_bwd covers (the partials' count is
// ceil(rows / this)).
PD_API int pd_layernorm_bwd_rows_per_block() {
  return LNB_WARPS * LNB_ROWS_PER_WARP;
}

PD_API int pd_layernorm_bwd(const void* x, const void* g, const void* dh,
                            const void* res, void* dx, void* pg, void* pb,
                            int rows, int D, float eps, int round_out,
                            void* stream) {
  if (D < 1 || D > LNB_MAX_D) return (int)cudaErrorInvalidValue;
  const int per_block = LNB_WARPS * LNB_ROWS_PER_WARP;
  const int blocks = (rows + per_block - 1) / per_block;
  const int ncol = (D + 31) / 32;
  auto* kernel = ncol <= 16   ? &layernorm_bwd_kernel<16>
                 : ncol <= 24 ? &layernorm_bwd_kernel<24>
                              : &layernorm_bwd_kernel<32>;
  kernel<<<blocks, LNB_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)dh, (const float*)res,
      (float*)dx, (float*)pg, (float*)pb, rows, D, eps, round_out);
  return (int)cudaGetLastError();
}
