// LayerNorm over the last axis, one warp per row.
//
// Replaces the LayerNorms inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (_layer_norm,
//                                              eps 1e-6, bf16 cast of the output
//                                              at :89 and :136)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (_layer_norm,
//                                              eps 1e-5)
//
// Bound: memory. A row is 384 or 512 floats, read three times (mean,
// variance, output) and written once; the second and third reads hit L1.
// Design: a warp owns a row, so the two reductions are register shuffles
// with no shared memory and no block barrier; eps and the bf16 rounding of
// the output are arguments, so both trunks share the one kernel.
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
