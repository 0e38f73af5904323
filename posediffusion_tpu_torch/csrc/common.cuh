// Helpers shared by the Hopper kernels of posediffusion_tpu_torch.
//
// Every kernel has a plain C entry point (extern "C", pointers and the
// stream as void*) that returns cudaGetLastError() right after its launch,
// so the ctypes wrapper in ops/kernels.py can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define PD_API extern "C" __attribute__((visibility("default")))

// Round-to-nearest-even through bfloat16, like jnp.astype(jnp.bfloat16) and
// torch's .to(torch.bfloat16): the value stays a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; `red` holds at least blockDim.x / 32 floats.
// Every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nwarps; ++w) t += red[w];
  return t;
}

// Activation codes shared with the Python wrapper.
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };
