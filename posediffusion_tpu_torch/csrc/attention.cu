// Softmax attention over a packed QKV buffer, tiled over queries and keys.
//
// Replaces the per-head attention inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (6 heads of
//                                              Dh 64, (N, N) additive bias that
//                                              makes the scale-packed row
//                                              block-diagonal)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (4 heads of
//                                              Dh 128, (N,) key bias from the
//                                              frame mask)
//   posediffusion_tpu/ops/vit_train_kernel.py  _attn_residual (:163) in
//                                              _fwd_call, with dropout of the
//                                              normalised p (site attn,
//                                              :201-202) before its bf16 cast
//
// qkv is (B, N, 3D) float32 with q | k | v along the last axis and head h at
// columns h*Dh of each; out is (B, N, D) float32. The softmax is float32:
// scores = q.k * scale + bias, p = exp(s - max) / sum. Masked entries carry
// the bias -1e30 (not -inf), as in the JAX kernels, so no row gives NaN.
// round_bf16 rounds q, k, v and p to bfloat16 before their products, which
// is the cast(...) of the ViT kernel's bf16-activation mode. With dropout,
// p is multiplied by its mask (common.cuh, element ((b H + h) N + i) N + j)
// before that rounding, as the TPU train kernel does.
//
// Bound: shared memory, then FMA issue. At 336px the ViT row holds 593
// tokens, and one head's whole K and V in float32 (the first design) would
// need 329 KB, more than the 227 KB a block may use. So a block owns QB query
// rows of one (sequence, head) and walks the keys in tiles of KT rows; its
// shared memory (K and V tile with rows padded to Dh + 1 floats, so a warp
// reading one column across 32 keys hits 32 banks; the block's q rows; a
// per-warp p strip) does not grow with N. Two passes over the key tiles keep
// the TPU kernel's rounding site exact: the bf16 mode rounds the NORMALISED
// p = e / sum before p.V, and a one-pass online softmax would only know the
// sum at the end. Pass 1 keeps a lane-local running max and sum and merges
// them across the warp; pass 2 recomputes the scores, forms p, rounds it and
// accumulates p.V in registers (RPW rows x Dh / 32 columns per lane).
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;                    // RPW
constexpr int kQueryBlock = kWarps * kRowsPerWarp;  // QB = 32
constexpr int kKeyTile = 64;                        // KT
constexpr int kMaxDh = 128;
constexpr int kCols = kMaxDh / 32;                  // output columns per lane
}  // namespace

__device__ __forceinline__ float attn_bias_at(const float* bias, int kind,
                                              int b, int i, int j, int N) {
  if (kind == 1) return bias[(size_t)i * N + j];
  if (kind == 2) return bias[(size_t)b * N + j];
  return 0.f;
}

__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                 int bias_kind, float* __restrict__ out, int N, int H, int Dh,
                 float scale, int round_in, DropArgs drop) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * kQueryBlock;
  const int D = H * Dh, ld = Dh + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float* Ks = smem;                        // KT x ld
  float* Vs = Ks + kKeyTile * ld;          // KT x ld
  float* Qs = Vs + kKeyTile * ld;          // QB x Dh
  float* Ps = Qs + kQueryBlock * Dh + warp * kRowsPerWarp * kKeyTile;  // RPW x KT

  const float* base = qkv + (size_t)b * N * 3 * D;
  for (int e = threadIdx.x; e < kQueryBlock * Dh; e += kThreads) {
    const int r = e / Dh, d = e % Dh, i = q0 + r;
    float q = i < N ? base[(size_t)i * 3 * D + h * Dh + d] : 0.f;
    Qs[e] = round_in ? round_bf16(q) : q;
  }
  const float* qw = Qs + warp * kRowsPerWarp * Dh;
  const int row0 = q0 + warp * kRowsPerWarp;

  auto stage = [&](float* dst, int off, int j0) {
    for (int e = threadIdx.x; e < kKeyTile * Dh; e += kThreads) {
      const int jj = e / Dh, d = e % Dh, j = j0 + jj;
      float v = j < N ? base[(size_t)j * 3 * D + off + h * Dh + d] : 0.f;
      dst[jj * ld + d] = round_in ? round_bf16(v) : v;
    }
  };
  // Scores of this warp's rows against key jj of the staged tile.
  auto scores = [&](int jj, int j, float (&s)[kRowsPerWarp]) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* kr = Ks + jj * ld;
    for (int d = 0; d < Dh; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qw[r * Dh + d], kv, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = min(row0 + r, N - 1);
      s[r] = s[r] * scale + attn_bias_at(bias, bias_kind, b, i, j, N);
    }
  };

  // ---- pass 1: row max and sum of exp, lane-local then merged
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kKeyTile) {
    __syncthreads();  // the previous tile (or Qs) is complete / consumed
    stage(Ks, D, j0);
    __syncthreads();
    for (int jj = lane; jj < kKeyTile && j0 + jj < N; jj += 32) {
      float s[kRowsPerWarp];
      scores(jj, j0 + jj, s);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float mn = fmaxf(m[r], s[r]);
        l[r] = l[r] * expf(m[r] - mn) + expf(s[r] - mn);
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float mx = warp_max(m[r]);
    // a lane that saw no key holds m = -inf and l = 0: it adds 0
    l[r] = warp_sum(m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mx));
    m[r] = mx;
  }

  // ---- pass 2: p = exp(s - max) / sum, rounded in bf16 mode, then p.V
  float o[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[r][c] = 0.f;
  float* pw = Ps;
  for (int j0 = 0; j0 < N; j0 += kKeyTile) {
    __syncthreads();
    stage(Ks, D, j0);
    stage(Vs, 2 * D, j0);
    __syncthreads();
    for (int jj = lane; jj < kKeyTile; jj += 32) {
      float s[kRowsPerWarp];
      const bool live = j0 + jj < N;
      if (live) scores(jj, j0 + jj, s);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float p = live ? expf(s[r] - m[r]) / l[r] : 0.f;
        if (live && drop.thr > 0)
          p *= drop_mul(drop, (unsigned int)((((size_t)blockIdx.x) * N + row0 + r) * N
                                             + j0 + jj));
        pw[r * kKeyTile + jj] = round_in ? round_bf16(p) : p;
      }
    }
    __syncwarp();
    const int kt = min(kKeyTile, N - j0);
    for (int jj = 0; jj < kt; ++jj) {
      const float* vr = Vs + jj * ld;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) {
          const float v = vr[d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            o[r][c] = fmaf(pw[r * kKeyTile + jj], v, o[r][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row0 + r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) out[((size_t)b * N + i) * D + h * Dh + d] = o[r][c];
    }
  }
}

// Bytes of dynamic shared memory the kernel needs; it does not depend on N
// (the wrapper checks the card's limit with the same formula).
static size_t attention_smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)2 * kKeyTile * (Dh + 1) +
                          (size_t)kQueryBlock * Dh +
                          (size_t)kWarps * kRowsPerWarp * kKeyTile);
}

// bias_kind: 0 none, 1 (N, N) shared by every sequence, 2 (B, N) per key.
PD_API int pd_attention(const void* qkv, const void* bias, int bias_kind,
                        void* out, int B, int N, int H, int Dh, float scale,
                        int round_in, unsigned int drop_key, int drop_thr,
                        float drop_scale, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = attention_smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (N + kQueryBlock - 1) / kQueryBlock);
  attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)bias, bias_kind, (float*)out, N, H, Dh,
      scale, round_in, DropArgs{drop_key, drop_thr, drop_scale});
  return (int)cudaGetLastError();
}
