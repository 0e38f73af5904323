// Helpers shared by the Hopper kernels of posediffusion_tpu_torch.
//
// Every kernel has a plain C entry point (extern "C", pointers and the
// stream as void*) that returns cudaGetLastError() right after its launch,
// so the ctypes wrapper in ops/kernels.py can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PD_API extern "C" __attribute__((visibility("default")))

// Round-to-nearest-even through bfloat16, like jnp.astype(jnp.bfloat16) and
// torch's .to(torch.bfloat16): the value stays a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SWIGLU = 3 };

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

// SwiGLU's gate (linear.cu's gated epilogue, train.cu swiglu_bwd): silu(x)
// = x / (1 + exp(-x)) and the sigmoid its derivative s (1 + x (1 - s)) reads,
// as ops/kernels.py silu and swiglu_bwd_plain compute them.
__device__ __forceinline__ float silu_f(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

// ---- tensor cores (mma.sync) and asynchronous copies, shared by the
// attention forward and backward (attention.cu, attention_bwd.cu) and the
// weight gradient (linear.cu)
//
// Fragment layouts, g = lane / 4, t = lane % 4 (PTX ISA, mma.m16n8k8 .tf32
// and mma.m16n8k16 .bf16): the accumulator c[0..3] holds rows g, g, g + 8,
// g + 8 and columns 2t, 2t + 1, 2t, 2t + 1 of the 16 x 8 tile. tf32 A (16 x
// 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8):
// b0 (t, g), b1 (t + 4, g). bf16 A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8,
// 2t..), a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..); B (16 x 8): b0 (2t..2t+1,
// g), b1 (2t+8..2t+9, g); a register holds two bf16, the lower column in
// its low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32.f32 gives for every finite x, by an integer add and a mask
// (the instruction compiles to these two and a NaN test and select; a NaN x
// still gives a NaN lo below, so a product with it stays NaN)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo (about 2^-21 relative): hi rounded to TF32, lo = x - hi
// exactly, whose low 13 bits the tensor core drops (truncation to TF32).
// A 3xTF32 product sums hi.hi + hi.lo + lo.hi (lo.lo, ~2^-22, is dropped).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zeros when !valid (src must still be a
// mapped address: callers clamp it)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// one float, for rows that are not 16-byte aligned or end inside a chunk
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// reductions over the four lanes of a quad (one accumulator row's columns)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
