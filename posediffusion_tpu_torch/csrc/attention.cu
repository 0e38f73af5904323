// Softmax attention over a packed QKV buffer, one block per (sequence, head).
//
// Replaces the per-head attention inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (6 heads of
//                                              Dh 64, (N, N) additive bias that
//                                              makes the scale-packed row
//                                              block-diagonal)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (4 heads of
//                                              Dh 128, (N,) key bias from the
//                                              frame mask)
//
// qkv is (B, N, 3D) float32 with q | k | v along the last axis and head h at
// columns h*Dh of each; out is (B, N, D) float32. The softmax is float32:
// scores = q.k * scale + bias, p = exp(s - max) / sum. Masked entries carry
// the bias -1e30 (not -inf), as in the JAX kernels, so no row gives NaN.
// round_bf16 rounds q, k, v and p to bfloat16 before their products, which
// is the cast(...) of the ViT kernel's bf16-activation mode.
//
// Bound: at N = 264, Dh = 64 one head's K and V are 135 KB of float32; the
// work is 2 N^2 Dh FMAs per head, a few GFLOP per layer in all, issued from
// shared memory. Design: the block stages the head's K and V once in
// shared memory (rows padded to Dh + 1 floats, so a warp reading one column
// across 32 keys hits 32 banks); each warp then owns a query row at a time,
// keeps its scores in a per-warp strip, and reduces max and sum with
// shuffles. Nothing leaves shared memory but the output row.
#include "common.cuh"

__global__ void __launch_bounds__(256)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                 int bias_kind, float* __restrict__ out, int N, int H, int Dh,
                 float scale, int round_in) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = H * Dh, ld = Dh + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  float* Ks = smem;
  float* Vs = Ks + N * ld;
  float* qs = Vs + N * ld + warp * (Dh + N);
  float* ps = qs + Dh;

  const float* base = qkv + (size_t)b * N * 3 * D;
  for (int i = threadIdx.x; i < N * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i % Dh;
    float kv = base[(size_t)j * 3 * D + D + h * Dh + d];
    float vv = base[(size_t)j * 3 * D + 2 * D + h * Dh + d];
    if (round_in) {
      kv = round_bf16(kv);
      vv = round_bf16(vv);
    }
    Ks[j * ld + d] = kv;
    Vs[j * ld + d] = vv;
  }
  __syncthreads();

  for (int i = warp; i < N; i += nwarps) {
    for (int d = lane; d < Dh; d += 32) {
      float q = base[(size_t)i * 3 * D + h * Dh + d];
      qs[d] = round_in ? round_bf16(q) : q;
    }
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qs[d], Ks[j * ld + d], s);
      s *= scale;
      if (bias_kind == 1) {
        s += bias[(size_t)i * N + j];
      } else if (bias_kind == 2) {
        s += bias[(size_t)b * N + j];
      }
      ps[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);

    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(ps[j] - mx);
      ps[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) {
      const float p = ps[j] / sum;
      ps[j] = round_in ? round_bf16(p) : p;
    }
    __syncwarp();

    for (int d = lane; d < Dh; d += 32) {
      float o = 0.f;
      for (int j = 0; j < N; ++j) o = fmaf(ps[j], Vs[j * ld + d], o);
      out[((size_t)b * N + i) * D + h * Dh + d] = o;
    }
    __syncwarp();
  }
}

// Bytes of dynamic shared memory the kernel needs (the wrapper checks the
// card's limit with the same formula).
static size_t attention_smem_bytes(int N, int Dh, int threads) {
  return sizeof(float) *
         ((size_t)2 * N * (Dh + 1) + (size_t)(threads / 32) * (Dh + N));
}

// bias_kind: 0 none, 1 (N, N) shared by every sequence, 2 (B, N) per key.
PD_API int pd_attention(const void* qkv, const void* bias, int bias_kind,
                        void* out, int B, int N, int H, int Dh, float scale,
                        int round_in, void* stream) {
  const int threads = 256;
  const size_t smem = attention_smem_bytes(N, Dh, threads);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<<<B * H, threads, smem, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)bias, bias_kind, (float*)out, N, H, Dh,
      scale, round_in);
  return (int)cudaGetLastError();
}
