// Elementwise passes of the train-trunk backward, and the summing pass of
// the per-block weight-gradient partials.
//
// Replaces, inside posediffusion_tpu/ops/vit_train_kernel.py _bwd_call:
//   _mlp_residual_bwd (:330-340)   dact = dhmid * mff mask, then GELU'(a1)
//                                  (through the same erf as the forward) or
//                                  ReLU'(a1): one pass, act_dropout_bwd;
//   :314, :434                     do = dy * the m2 / m1 mask (act none);
//   :937-940                       the sum over the per-batch-chunk weight
//                                  gradient partials (here per row split or
//                                  row block): sum_partials;
//   :314-319, :434-456             DINOv2's LayerScale backward at the m2 and
//                                  m1 sites: do = dy * mask, the gain's
//                                  gradient sum_rows do * o_pre, and the
//                                  cotangent do * gamma: layerscale_bwd.
//
// Bound: memory. act_dropout_bwd reads dh and a1 and writes da1 once
// (135,168 x 1,536 f32 at the ViT's fc1: 2.5 GB a call); the mask is
// recomputed from its counter hash (common.cuh) instead of being stored, as
// the TPU kernel regenerates its masks from (seed, stream). Design: a
// grid-stride loop, one element per thread per step, coalesced.
// sum_partials: one thread per output element adds the S partials in order
// (deterministic; S is at most a few hundred).
// layerscale_bwd: bound by memory too (dy and o_pre read, the cotangent
// written: 821 MB at DINOv2's 178,176 x 384). The TPU kernel recomputes the
// pre-gain output o_pre for the gain gradient; here the forward's product
// saved it (linear's want_pre). A block owns a column per thread and a range
// of rows: loads along a row are coalesced, each thread sums its column's
// do * o_pre in a register over the block's rows, and writes one f32 partial
// per block, which sum_partials adds in order (no atomics: dgamma repeats
// bitwise).
#include "common.cuh"

__global__ void act_dropout_bwd_kernel(const float* __restrict__ dh,
                                       const float* __restrict__ a,
                                       float* __restrict__ out, size_t n,
                                       int act, DropArgs drop) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = dh[i] * drop_mul(drop, (unsigned int)i);
    if (act == ACT_RELU) {
      v = a[i] > 0.f ? v : 0.f;
    } else if (act == ACT_GELU) {
      v *= gelu_grad(a[i]);
    }
    out[i] = v;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int S, size_t L) {
  for (size_t l = blockIdx.x * (size_t)blockDim.x + threadIdx.x; l < L;
       l += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += part[(size_t)k * L + l];
    out[l] = s;
  }
}

// out = dy * mask * gamma; pg[block, c] = sum over the block's rows of
// dy * mask * o_pre in column c. One thread per column (blockDim.x >= D).
__global__ void layerscale_bwd_kernel(const float* __restrict__ dy,
                                      const float* __restrict__ o_pre,
                                      const float* __restrict__ gamma,
                                      float* __restrict__ out,
                                      float* __restrict__ pg, int M, int D,
                                      int rows, DropArgs drop) {
  const int c = threadIdx.x;
  if (c >= D) return;
  const int r0 = blockIdx.x * rows, r1 = min(M, r0 + rows);
  const float gm = gamma[c];
  float acc = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * D + c;
    const float d = dy[i] * drop_mul(drop, (unsigned int)i);
    acc = fmaf(d, o_pre[i], acc);
    out[i] = d * gm;
  }
  pg[(size_t)blockIdx.x * D + c] = acc;
}

static int grid_for(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

// out = dh * mask(drop, i) * act'(a); a may be null when act is none.
PD_API int pd_act_dropout_bwd(const void* dh, const void* a, void* out,
                              long long n, int act, unsigned int drop_key,
                              int drop_thr, float drop_scale, void* stream) {
  if (act != ACT_NONE && a == nullptr) return (int)cudaErrorInvalidValue;
  act_dropout_bwd_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)dh, (const float*)a, (float*)out, (size_t)n, act,
      DropArgs{drop_key, drop_thr, drop_scale});
  return (int)cudaGetLastError();
}

// out[l] = sum over k < S of part[k, l], in order of k.
PD_API int pd_sum_partials(const void* part, void* out, int S, long long L,
                           void* stream) {
  sum_partials_kernel<<<grid_for(L, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, S, (size_t)L);
  return (int)cudaGetLastError();
}

// The LayerScale backward of an (M, D) branch: out = dy * mask * gamma and
// the per-block partials pg (ceil(M / rows), D) of dgamma. D <= 1024.
PD_API int pd_layerscale_bwd(const void* dy, const void* o_pre,
                             const void* gamma, void* out, void* pg, int M,
                             int D, int rows, unsigned int drop_key,
                             int drop_thr, float drop_scale, void* stream) {
  if (D < 1 || D > 1024 || M < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (M + rows - 1) / rows;
  const int threads = (D + 31) / 32 * 32;
  layerscale_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)dy, (const float*)o_pre, (const float*)gamma, (float*)out,
      (float*)pg, M, D, rows, DropArgs{drop_key, drop_thr, drop_scale});
  return (int)cudaGetLastError();
}
