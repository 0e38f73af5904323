// Backward of softmax attention over a packed QKV buffer: dQKV from dOut.
//
// Replaces the attention backward inside the TPU train kernel
// posediffusion_tpu/ops/vit_train_kernel.py, _attn_residual_bwd (:356), its
// per-head head_bwd (:400-431): p is recomputed from q and k with the bias
// (kind 1, a shared (N, N) bias: the ViT's scale packing; kind 2, a (B, N)
// key bias: the denoiser's frame mask) and the dropout mask of site attn
// (common.cuh, the forward's element index), then
//   dv = p_d^T do,  dp = (do v^T) * mask,  ds = p * (dp - rowsum(dp * p)) * scale,
//   dq = ds k,      dk = ds^T q,
// with p_d = p * mask. In the bf16 mode q, k, v, do, p_d and ds are rounded
// to bf16 before their products, the TPU kernel's cast(...) sites; the
// softmax, rowsum and accumulations stay float32.
//
// qkv (B, N, 3D) and dout (B, N, D) float32 -> dqkv (B, N, 3D) float32 with
// dq | dk | dv in the q | k | v columns of each head.
//
// Bound: FMA issue, like the forward (seven products of Dh-long rows per
// (query, key) pair against two in the forward; no tensor cores yet).
// Design: two kernels and no atomics, so the result repeats bitwise.
//   * dq kernel: a block owns 32 query rows of one (sequence, head); its
//     warps own 4 rows each, as in the forward, and walk the keys in tiles
//     of 64 three times: the row max and sum, rowsum(dp * p), then ds and
//     dq = ds k accumulated in registers. It also writes those three row
//     statistics for the second kernel.
//   * dk/dv kernel: a block owns 32 keys of one (sequence, head), its warps
//     4 keys each; it walks the queries in tiles of 64 with their statistics
//     and accumulates dv = p_d^T do and dk = ds^T q in registers.
// Shared memory does not grow with N (keys and queries are tiled), so any N
// runs: 264 tokens in the ViT, 16 frames in the denoiser.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // query rows (dq) or keys (dk/dv) per warp
constexpr int kBlockRows = kWarps * kRows;  // 32
constexpr int kTile = 64;                // keys (dq) or queries (dk/dv) per tile
constexpr int kMaxDh = 128;
constexpr int kCols = kMaxDh / 32;

__device__ __forceinline__ float bias_of(const float* bias, int kind, int b,
                                         int i, int j, int N) {
  if (kind == 1) return bias[(size_t)i * N + j];
  if (kind == 2) return bias[(size_t)b * N + j];
  return 0.f;
}

__device__ __forceinline__ float rnd(float v, int round_in) {
  return round_in ? round_bf16(v) : v;
}
}  // namespace

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                   const float* __restrict__ bias, int kind,
                   float* __restrict__ dqkv, float* __restrict__ stats, int N,
                   int H, int Dh, float scale, int round_in, DropArgs drop) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBlockRows;
  const int D = H * Dh, ld = Dh + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float* Ks = smem;                        // kTile x ld
  float* Vs = Ks + kTile * ld;             // kTile x ld
  float* Qs = Vs + kTile * ld;             // kBlockRows x Dh
  float* Os = Qs + kBlockRows * Dh;        // kBlockRows x Dh (dout rows)
  float* Ps = Os + kBlockRows * Dh + warp * kRows * kTile;  // kRows x kTile

  const float* base = qkv + (size_t)b * N * 3 * D;
  const float* dbase = dout + (size_t)b * N * D;
  for (int e = threadIdx.x; e < kBlockRows * Dh; e += kThreads) {
    const int r = e / Dh, d = e % Dh, i = q0 + r;
    Qs[e] = i < N ? rnd(base[(size_t)i * 3 * D + h * Dh + d], round_in) : 0.f;
    Os[e] = i < N ? rnd(dbase[(size_t)i * D + h * Dh + d], round_in) : 0.f;
  }
  const float* qw = Qs + warp * kRows * Dh;
  const float* ow = Os + warp * kRows * Dh;
  const int row0 = q0 + warp * kRows;

  auto stage = [&](float* dst, int off, int j0) {
    for (int e = threadIdx.x; e < kTile * Dh; e += kThreads) {
      const int jj = e / Dh, d = e % Dh, j = j0 + jj;
      dst[jj * ld + d] = j < N ? rnd(base[(size_t)j * 3 * D + off + h * Dh + d], round_in) : 0.f;
    }
  };
  // scores s and do.v of this warp's rows against staged key jj
  auto dots = [&](int jj, int j, float (&s)[kRows], float (&dv)[kRows]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dv[r] = 0.f;
    const float* kr = Ks + jj * ld;
    const float* vr = Vs + jj * ld;
    for (int d = 0; d < Dh; ++d) {
      const float kv = kr[d], vv = vr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = fmaf(qw[r * Dh + d], kv, s[r]);
        dv[r] = fmaf(ow[r * Dh + d], vv, dv[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(row0 + r, N - 1);
      s[r] = s[r] * scale + bias_of(bias, kind, b, i, j, N);
    }
  };
  auto drop_at = [&](int r, int j) {
    return drop_mul(drop, (unsigned int)(((size_t)bh * N + row0 + r) * N + j));
  };

  // ---- pass 1: row max and sum of exp (as the forward)
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kTile) {
    __syncthreads();
    stage(Ks, D, j0);
    stage(Vs, 2 * D, j0);
    __syncthreads();
    for (int jj = lane; jj < kTile && j0 + jj < N; jj += 32) {
      float s[kRows], dv[kRows];
      dots(jj, j0 + jj, s, dv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float mn = fmaxf(m[r], s[r]);
        l[r] = l[r] * expf(m[r] - mn) + expf(s[r] - mn);
        m[r] = mn;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float mx = warp_max(m[r]);
    l[r] = warp_sum(m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mx));
    m[r] = mx;
  }

  // ---- pass 2: rowsum(dp * p) over the keys (the tile of the last pass is
  // still staged when N fits one tile; the general case stages again)
  float Dr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) Dr[r] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    if (N > kTile) {
      __syncthreads();
      stage(Ks, D, j0);
      stage(Vs, 2 * D, j0);
      __syncthreads();
    }
    for (int jj = lane; jj < kTile && j0 + jj < N; jj += 32) {
      float s[kRows], dv[kRows];
      dots(jj, j0 + jj, s, dv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = expf(s[r] - m[r]) / l[r];
        Dr[r] = fmaf(dv[r] * drop_at(r, j0 + jj), p, Dr[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) Dr[r] = warp_sum(Dr[r]);

  // ---- pass 3: ds, then dq = ds k
  float dq[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTile) {
    if (N > kTile) {
      __syncthreads();
      stage(Ks, D, j0);
      stage(Vs, 2 * D, j0);
      __syncthreads();
    }
    for (int jj = lane; jj < kTile; jj += 32) {
      float ds[kRows];
      if (j0 + jj < N) {
        float s[kRows], dv[kRows];
        dots(jj, j0 + jj, s, dv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = expf(s[r] - m[r]) / l[r];
          ds[r] = rnd(p * (dv[r] * drop_at(r, j0 + jj) - Dr[r]) * scale, round_in);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r) ds[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) Ps[r * kTile + jj] = ds[r];
    }
    __syncwarp();
    const int kt = min(kTile, N - j0);
    for (int jj = 0; jj < kt; ++jj) {
      const float* kr = Ks + jj * ld;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) {
          const float kv = kr[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) dq[r][c] = fmaf(Ps[r * kTile + jj], kv, dq[r][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = row0 + r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) dqkv[((size_t)b * N + i) * 3 * D + h * Dh + d] = dq[r][c];
    }
    if (lane == 0) {
      float* st = stats + ((size_t)bh * N + i) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = Dr[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ bias, int kind,
                    const float* __restrict__ stats, float* __restrict__ dqkv,
                    int N, int H, int Dh, float scale, int round_in,
                    DropArgs drop) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kBlockRows;
  const int D = H * Dh, ld = Dh + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float* Kb = smem;                        // kBlockRows x Dh
  float* Vb = Kb + kBlockRows * Dh;        // kBlockRows x Dh
  float* Qt = Vb + kBlockRows * Dh;        // kTile x ld
  float* Ot = Qt + kTile * ld;             // kTile x ld (dout rows)
  float* St = Ot + kTile * ld;             // kTile x 3
  float* PD = St + kTile * 3 + warp * 2 * kRows * kTile;  // kRows x kTile
  float* DS = PD + kRows * kTile;                          // kRows x kTile

  const float* base = qkv + (size_t)b * N * 3 * D;
  const float* dbase = dout + (size_t)b * N * D;
  for (int e = threadIdx.x; e < kBlockRows * Dh; e += kThreads) {
    const int r = e / Dh, d = e % Dh, j = k0 + r;
    Kb[e] = j < N ? rnd(base[(size_t)j * 3 * D + D + h * Dh + d], round_in) : 0.f;
    Vb[e] = j < N ? rnd(base[(size_t)j * 3 * D + 2 * D + h * Dh + d], round_in) : 0.f;
  }
  const float* kw = Kb + warp * kRows * Dh;
  const float* vw = Vb + warp * kRows * Dh;
  const int key0 = k0 + warp * kRows;

  float dk[kRows][kCols], dv[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * Dh; e += kThreads) {
      const int ii = e / Dh, d = e % Dh, i = i0 + ii;
      Qt[ii * ld + d] = i < N ? rnd(base[(size_t)i * 3 * D + h * Dh + d], round_in) : 0.f;
      Ot[ii * ld + d] = i < N ? rnd(dbase[(size_t)i * D + h * Dh + d], round_in) : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * 3; e += kThreads) {
      const int i = i0 + e / 3;
      St[e] = i < N ? stats[((size_t)bh * N + i) * 3 + e % 3] : 0.f;
    }
    __syncthreads();
    for (int ii = lane; ii < kTile; ii += 32) {
      const int i = i0 + ii;
      float s[kRows], dpv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dpv[r] = 0.f;
      if (i < N) {
        const float* qr = Qt + ii * ld;
        const float* orow = Ot + ii * ld;
        for (int d = 0; d < Dh; ++d) {
          const float qv = qr[d], ov = orow[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            s[r] = fmaf(qv, kw[r * Dh + d], s[r]);
            dpv[r] = fmaf(ov, vw[r * Dh + d], dpv[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = key0 + r;
        float pd = 0.f, ds = 0.f;
        if (i < N && j < N) {
          const float sc = s[r] * scale + bias_of(bias, kind, b, i, j, N);
          const float p = expf(sc - St[ii * 3]) / St[ii * 3 + 1];
          const float mul = drop_mul(drop, (unsigned int)(((size_t)bh * N + i) * N + j));
          pd = rnd(p * mul, round_in);
          ds = rnd(p * (dpv[r] * mul - St[ii * 3 + 2]) * scale, round_in);
        }
        PD[r * kTile + ii] = pd;
        DS[r * kTile + ii] = ds;
      }
    }
    __syncwarp();
    const int qt = min(kTile, N - i0);
    for (int ii = 0; ii < qt; ++ii) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) {
          const float ov = Ot[ii * ld + d], qv = Qt[ii * ld + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            dv[r][c] = fmaf(PD[r * kTile + ii], ov, dv[r][c]);
            dk[r][c] = fmaf(DS[r * kTile + ii], qv, dk[r][c]);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = key0 + r;
    if (j >= N) continue;
    float* out = dqkv + ((size_t)b * N + j) * 3 * D + h * Dh;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) {
        out[D + d] = dk[r][c];
        out[2 * D + d] = dv[r][c];
      }
    }
  }
}

static size_t dq_smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)2 * kTile * (Dh + 1) + (size_t)2 * kBlockRows * Dh +
                          (size_t)kWarps * kRows * kTile);
}

static size_t dkv_smem_bytes(int Dh) {
  return sizeof(float) * ((size_t)2 * kBlockRows * Dh + (size_t)2 * kTile * (Dh + 1) +
                          (size_t)kTile * 3 + (size_t)kWarps * 2 * kRows * kTile);
}

// stats: scratch of B * H * N * 3 floats. bias_kind as pd_attention's.
PD_API int pd_attention_bwd(const void* qkv, const void* dout, const void* bias,
                            int bias_kind, void* dqkv, void* stats, int B,
                            int N, int H, int Dh, float scale, int round_in,
                            unsigned int drop_key, int drop_thr,
                            float drop_scale, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const DropArgs drop{drop_key, drop_thr, drop_scale};
  const size_t smem1 = dq_smem_bytes(Dh), smem2 = dkv_smem_bytes(Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (N + kBlockRows - 1) / kBlockRows);
  attn_bwd_dq_kernel<<<grid, kThreads, smem1, s>>>(
      (const float*)qkv, (const float*)dout, (const float*)bias, bias_kind,
      (float*)dqkv, (float*)stats, N, H, Dh, scale, round_in, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<<<grid, kThreads, smem2, s>>>(
      (const float*)qkv, (const float*)dout, (const float*)bias, bias_kind,
      (const float*)stats, (float*)dqkv, N, H, Dh, scale, round_in, drop);
  return (int)cudaGetLastError();
}
