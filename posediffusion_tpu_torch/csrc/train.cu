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
// and, with no TPU counterpart, the backward of DINOv2 ViT-g/14's SwiGLU
// gate h = silu(x1) * x2 (linear.cu's gated epilogue): swiglu_bwd.
//
// Bound: memory. act_dropout_bwd reads dh and a1 and writes da1 once
// (135,168 x 1,536 f32 at the ViT's fc1: 2.5 GB a call, 0.744 ms at 3.35
// TB/s; 8 bytes an element for act none, which reads no a1); the mask is
// recomputed from its counter hash (common.cuh) instead of being stored, as
// the TPU kernel regenerates its masks from (seed, stream). Design: a
// streaming pass at the bytes bound. 128-bit loads and stores with the
// evict-first hints (__ldcs / __stcs: 2.5 GB passes through the 50 MB L2
// once), two float4 of each input in flight a thread before any
// arithmetic, 32-bit indices (n below 2^31: the largest site, ViT-B's fc1
// at 512 images, is 415M elements). The grid covers n, one contiguous run
// of 2,048 elements a block: kernel_probes.py --stream measured that layout
// at 90-91% of the bytes bound at the ViT's fc1 on an H100, as torch.add,
// and a grid of the resident blocks looping over n at 83-85% (1 to 8
// float4 a thread, 128 to 512 threads a block, the hints and an L2
// prefetch hint moved it by under 1%). The n % 4 tail goes to the last
// block in the same launch; operands off a 16-byte boundary take a scalar
// instance of the same kernel (one launch either way). The hash stays per
// element index (two fmix32 an element), so the mask is the forward's and
// kernels.dropout_mask's bit for bit. The activation is a template
// argument: act none compiles without a1's loads.
// sum_partials: one thread per output element adds the S partials in order
// (deterministic; S is at most a few hundred).
// layerscale_bwd: bound by memory too (dy and o_pre read, the cotangent
// written: 821 MB at DINOv2's 178,176 x 384). The TPU kernel recomputes the
// pre-gain output o_pre for the gain gradient; here the forward's product
// saved it (linear's want_pre). A block owns a column per thread and a range
// of rows: loads along a row are coalesced, each thread sums its column's
// do * o_pre in a register over the block's rows, and writes one f32 partial
// per block, which sum_partials adds in order (no atomics: dgamma repeats
// bitwise). Rows wider than 1,024 (ViT-g's 1,536) split their columns over
// the grid's y: 768 threads twice at 1,536.
// swiglu_bwd: bound by memory (dh read, the interleaved pre-activation
// (x1, x2) read, its cotangent written: 20 bytes a hidden element, 2.7 GB a
// call at ViT-g/14's 33,408 x 4,096). The columns are interleaved (x1, x2 of
// hidden column j at 2j, 2j + 1), so the pass is elementwise over the flat
// hidden index i whatever the rows: a thread takes two hidden elements, a
// float2 of dh and a float4 of pre in and a float4 out, streaming hints as
// act_dropout_bwd; the scalar instance for operands off a 16-byte boundary
// (and an odd count's last element).
#include "common.cuh"

constexpr int AD_THREADS = 256;
constexpr int AD_UNROLL = 2;  // float4 (or floats) of each input in flight a thread
constexpr int AD_RUN = AD_THREADS * AD_UNROLL;  // float4 runs (or floats) a block

// one element: dh * mask(i) * act'(a)
template <int ACT>
__device__ __forceinline__ float act_dropout_bwd_one(float dh, float a, unsigned int i,
                                                     const DropArgs& drop) {
  const float v = dh * drop_mul(drop, i);
  if (ACT == ACT_RELU) return a > 0.f ? v : 0.f;
  if (ACT == ACT_GELU) return v * gelu_grad(a);
  return v;
}

// VEC: dh, a and out 16-byte aligned; block b takes float4 runs b AD_RUN
// .. + AD_RUN - 1 of the n / 4 and the last block the n % 4 tail. Else
// block b takes elements b AD_RUN .. + AD_RUN - 1.
template <int ACT, bool VEC>
__global__ void __launch_bounds__(AD_THREADS)
act_dropout_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ a,
                       float* __restrict__ out, unsigned int n, DropArgs drop) {
  const unsigned int first = blockIdx.x * AD_RUN + threadIdx.x;
  if (!VEC) {
    float d[AD_UNROLL], x[AD_UNROLL];
#pragma unroll
    for (int u = 0; u < AD_UNROLL; ++u) {
      const unsigned int i = first + u * AD_THREADS;
      d[u] = i < n ? __ldcs(dh + i) : 0.f;
      x[u] = ACT != ACT_NONE && i < n ? __ldcs(a + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < AD_UNROLL; ++u) {
      const unsigned int i = first + u * AD_THREADS;
      if (i < n) __stcs(out + i, act_dropout_bwd_one<ACT>(d[u], x[u], i, drop));
    }
    return;
  }
  const unsigned int n4 = n / 4;
  const float4* dh4 = reinterpret_cast<const float4*>(dh);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d[AD_UNROLL], x[AD_UNROLL];
#pragma unroll
  for (int u = 0; u < AD_UNROLL; ++u) {
    const unsigned int v = first + u * AD_THREADS;
    d[u] = v < n4 ? __ldcs(dh4 + v) : zero;
    x[u] = ACT != ACT_NONE && v < n4 ? __ldcs(a4 + v) : zero;
  }
#pragma unroll
  for (int u = 0; u < AD_UNROLL; ++u) {
    const unsigned int v = first + u * AD_THREADS;
    const unsigned int i = 4 * v;
    if (v < n4)
      __stcs(out4 + v, make_float4(act_dropout_bwd_one<ACT>(d[u].x, x[u].x, i, drop),
                                   act_dropout_bwd_one<ACT>(d[u].y, x[u].y, i + 1, drop),
                                   act_dropout_bwd_one<ACT>(d[u].z, x[u].z, i + 2, drop),
                                   act_dropout_bwd_one<ACT>(d[u].w, x[u].w, i + 3, drop)));
  }
  const unsigned int i = 4 * n4 + threadIdx.x;  // the tail: at most three elements
  if (blockIdx.x == gridDim.x - 1 && i < n)
    out[i] = act_dropout_bwd_one<ACT>(dh[i], ACT == ACT_NONE ? 0.f : a[i], i, drop);
}

template <int ACT>
int launch_act_dropout_bwd(const float* dh, const float* a, float* out, unsigned int n,
                           DropArgs drop, cudaStream_t s) {
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = al16(dh) && al16(out) && (ACT == ACT_NONE || al16(a));
  const unsigned int runs = vec ? n / 4 : n;
  const int blocks = runs > 0 ? (int)((runs + AD_RUN - 1) / AD_RUN) : 1;
  if (vec)
    act_dropout_bwd_kernel<ACT, true><<<blocks, AD_THREADS, 0, s>>>(dh, a, out, n, drop);
  else
    act_dropout_bwd_kernel<ACT, false><<<blocks, AD_THREADS, 0, s>>>(dh, a, out, n, drop);
  return (int)cudaGetLastError();
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
  const int c = blockIdx.y * blockDim.x + threadIdx.x;  // columns split over y past 1,024
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

// dx1 = dh x2 s (1 + x1 (1 - s)), dx2 = dh silu(x1) = dh x1 s, s = sigmoid(x1)
__device__ __forceinline__ float2 swiglu_bwd_one(float dh, float x1, float x2) {
  const float s = sigmoid_f(x1);
  return make_float2(dh * x2 * (s * (1.f + x1 * (1.f - s))), dh * (x1 * s));
}

// VEC: hidden elements 2v, 2v + 1 a thread (float2 of dh, float4 of pre and
// out), n even; else element v a thread.
template <bool VEC>
__global__ void __launch_bounds__(AD_THREADS)
swiglu_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ pre,
                  float* __restrict__ out, unsigned int n) {
  const unsigned int v = blockIdx.x * AD_THREADS + threadIdx.x;
  if (VEC) {
    if (v >= n / 2) return;
    const float2 d = __ldcs(reinterpret_cast<const float2*>(dh) + v);
    const float4 x = __ldcs(reinterpret_cast<const float4*>(pre) + v);
    const float2 a = swiglu_bwd_one(d.x, x.x, x.y), b = swiglu_bwd_one(d.y, x.z, x.w);
    __stcs(reinterpret_cast<float4*>(out) + v, make_float4(a.x, a.y, b.x, b.y));
    return;
  }
  if (v >= n) return;
  const float2 a = swiglu_bwd_one(dh[v], pre[2 * (size_t)v], pre[2 * (size_t)v + 1]);
  out[2 * (size_t)v] = a.x;
  out[2 * (size_t)v + 1] = a.y;
}

static int grid_for(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

// out = dh * mask(drop, i) * act'(a); a may be null when act is none;
// n below 2^31 (the wrapper refuses more).
PD_API int pd_act_dropout_bwd(const void* dh, const void* a, void* out,
                              long long n, int act, unsigned int drop_key,
                              int drop_thr, float drop_scale, void* stream) {
  if (n < 0 || n >= (1LL << 31) || (act != ACT_NONE && a == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float *D = (const float*)dh, *A = (const float*)a;
  float* O = (float*)out;
  const DropArgs drop{drop_key, drop_thr, drop_scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case ACT_NONE: return launch_act_dropout_bwd<ACT_NONE>(D, A, O, (unsigned int)n, drop, s);
    case ACT_RELU: return launch_act_dropout_bwd<ACT_RELU>(D, A, O, (unsigned int)n, drop, s);
    case ACT_GELU: return launch_act_dropout_bwd<ACT_GELU>(D, A, O, (unsigned int)n, drop, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out[l] = sum over k < S of part[k, l], in order of k.
PD_API int pd_sum_partials(const void* part, void* out, int S, long long L,
                           void* stream) {
  sum_partials_kernel<<<grid_for(L, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, S, (size_t)L);
  return (int)cudaGetLastError();
}

// The LayerScale backward of an (M, D) branch: out = dy * mask * gamma and
// the per-block partials pg (ceil(M / rows), D) of dgamma. D <= 1,536
// (ViT-g/14's), at most 1,024 columns a block (ops/kernels.py
// LAYERSCALE_MAX_D).
PD_API int pd_layerscale_bwd(const void* dy, const void* o_pre,
                             const void* gamma, void* out, void* pg, int M,
                             int D, int rows, unsigned int drop_key,
                             int drop_thr, float drop_scale, void* stream) {
  if (D < 1 || D > 1536 || M < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (M + rows - 1) / rows;
  const int splits = (D + 1023) / 1024;  // column ranges of a row, grid y
  const int threads = ((D + splits - 1) / splits + 31) / 32 * 32;
  layerscale_bwd_kernel<<<dim3(blocks, splits), threads, 0, (cudaStream_t)stream>>>(
      (const float*)dy, (const float*)o_pre, (const float*)gamma, (float*)out,
      (float*)pg, M, D, rows, DropArgs{drop_key, drop_thr, drop_scale});
  return (int)cudaGetLastError();
}

// out (n pairs, interleaved as pre) = the SwiGLU gate's backward of dh (n)
// and pre (2n); n below 2^31 (the wrapper refuses more).
PD_API int pd_swiglu_bwd(const void* dh, const void* pre, void* out, long long n,
                         void* stream) {
  if (n < 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const auto al16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = n % 2 == 0 && al16(dh) && al16(pre) && al16(out);
  const long long runs = vec ? n / 2 : n;
  const int blocks = (int)((runs + AD_THREADS - 1) / AD_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    swiglu_bwd_kernel<true><<<blocks, AD_THREADS, 0, s>>>(
        (const float*)dh, (const float*)pre, (float*)out, (unsigned int)n);
  else
    swiglu_bwd_kernel<false><<<blocks, AD_THREADS, 0, s>>>(
        (const float*)dh, (const float*)pre, (float*)out, (unsigned int)n);
  return (int)cudaGetLastError();
}
