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

// ---- dropout (the train kernels of ops/vit_train_kernel.py)
//
// A counter-based mask: element i of one dropout site keeps its value iff
// the low 23 bits of fmix32(fmix32(i) ^ key) are >= thr, and is then scaled
// by 1 / (1 - rate). `key` mixes (seed, layer, site) on the host
// (ops/kernels.drop_args), thr = ceil(rate * 2^23) is the TPU kernel's rule
// u >= rate on a 23-bit uniform (posediffusion_tpu/ops/vit_train_kernel.py
// :121-128) in integers. The mask depends on (key, i) alone, never on a
// tiling, so the forward, the backward and the plain PyTorch version
// (ops/kernels.dropout_mask, the same integer steps) draw the same bits.
struct DropArgs {
  unsigned int key;
  int thr;      // 0: no dropout at this site
  float scale;  // 1 / (1 - rate) as float32
};

__host__ __device__ __forceinline__ unsigned int pd_fmix32(unsigned int h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The multiplier of element i: 0 or scale (1 when the site has no dropout).
__device__ __forceinline__ float drop_mul(const DropArgs& d, unsigned int i) {
  if (d.thr <= 0) return 1.f;
  const unsigned int bits = pd_fmix32(pd_fmix32(i) ^ d.key) & 0x7FFFFFu;
  return bits >= (unsigned int)d.thr ? d.scale : 0.f;
}

// Exact GELU (torch nn.GELU) and its derivative Phi(a) + a phi(a).
__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_grad(float a) {
  return 0.5f * (1.f + erff(a * 0.70710678118654752f)) +
         a * expf(-0.5f * a * a) * 0.39894228040143268f;
}
