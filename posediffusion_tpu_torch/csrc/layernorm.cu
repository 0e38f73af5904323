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
// Bound: memory: x read once and y written once, 2 x 4 bytes an element
// (415 MB, 0.124 ms at HBM rate, at the ViT's train shape 135,168 x 384).
// Forward: a warp owns a row, so the two reductions are register shuffles
// with no shared memory and no block barrier. A lane holds its columns of
// the row in registers: float4 number c of lane l is columns 4 (l + 32 c)
// .. + 3 when D is 128 x NV for NV in 3, 4, 6, 8 (ViT-S, the denoiser,
// ViT-B, D 1,024) and x, g, b and y are 16-byte aligned; otherwise column l
// + 32 c, c < 32, masked past D (any D <= 1,024). So x is read once (the
// mean, the centred variance and the output come from the registers), g
// and b once a warp as float4s (at each row from L1 in the masked
// instance, whose 32 values a lane leave no registers for them), and the
// next row's loads are issued before this row's reductions. y goes out
// with streaming float4 stores (st.global.cs). The grid holds as many
// blocks of 8 warps as fit on the card at once, each warp walking rows
// gridDim x 8 apart. A row wider than 1,024 (no configuration of the port
// has one) takes a strided instance instead: lane l's columns l, l + 32,
// ..., read three times through L1, a warp a row. Two-pass numerics
// as the TPU kernels' _layer_norm: the mean, then the centred variance,
// rsqrt(var + eps), * g + b; eps and the bf16 rounding of the output are
// arguments, so both trunks share the one kernel.
// Backward: bound by memory too (x, dh and the residual cotangent read,
// dx written: 830 MB at the ViT's 135,168 x 384). A warp owns a row at a
// time and recomputes mean and rstd from the saved input, as _ln_bwd does
// from _ln_fwd. The grid is fixed (two blocks of 8 warps per SM of an H100,
// LNB_BLOCKS) and each warp walks rows gridDim x 8 apart, so a call writes
// at most 264 partials whatever the rows. A lane holds its columns of a row
// in registers: float4 number c of lane l is columns 4 (l + 32 c) .. + 3
// when D is 128 x NV for NV in 3, 4, 6, 8 (ViT-S, the denoiser, ViT-B, D
// 1,024) and every pointer is 16-byte aligned; otherwise column l + 32 c,
// c < 32, masked past D (any D <= 1,024). All of a row's loads (x, dh,
// residual) are issued before its first reduction, and at D 384 (NV 3,
// where the registers allow two blocks an SM) the next row's x and dh as
// well. dg = sum(dh * xhat) and db = sum(dh) over
// rows stay in registers across a warp's rows, are merged across the
// block's warps in shared memory in warp order, and are written as one f32
// partial per block, in the (blocks, 2, D) layout the summing pass reads;
// ln_bwd_sum_kernel adds the partials in a fixed order (8 strided runs per
// column, then the 8 runs in order). No atomics, so the result repeats
// bitwise. Rows wider than 1,024, up to ViT-g/14's 1,536 (LNB_WIDE_MAX_D),
// take layernorm_bwd_wide_kernel: the same warp a row and the same sums in
// the same order, but a lane's dg and db sums live in the block's shared
// memory (each warp its own row of it, dynamic: 2 x 8 x D floats) instead
// of registers, which then hold only x and dh of the row (48 floats each:
// float4 number c of lane l is columns 4 (l + 32 c) .. + 3 when D is 1,536
// and aligned; else 48 columns l + 32 c, masked past D); the residual's
// cotangent is read at the store.
#include "common.cuh"

constexpr int LNB_WARPS = 8;             // warps of a block
constexpr int LNB_BLOCKS = 2 * 132;      // most blocks (partials) of a call
constexpr int LNB_MAX_D = 1024;
constexpr int LNB_WIDE_MAX_D = 1536;     // the wide kernel's rows (48 columns a lane)
constexpr int LNB_SUM_RUNS = 8;          // strided runs per column in the sum

__host__ __device__ inline int lnb_blocks(int rows) {
  const int b = (rows + LNB_WARPS - 1) / LNB_WARPS;
  return b < 1 ? 1 : (b < LNB_BLOCKS ? b : LNB_BLOCKS);
}

// Element e of a lane's E = NV * VEC values of a row: column 4 (lane + 32
// (e / 4)) + e % 4 with VEC 4, lane + 32 e with VEC 1.
template <int VEC>
__device__ __forceinline__ int lnb_col(int lane, int e) {
  return VEC == 4 ? 4 * (lane + 32 * (e >> 2)) + (e & 3) : lane + 32 * e;
}

template <int NV, int VEC>
__device__ __forceinline__ void lnb_load(const float* __restrict__ p, float (&v)[NV * VEC],
                                         int lane, int D) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float4 f = reinterpret_cast<const float4*>(p)[lane + 32 * c];
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int d = lane + 32 * e;
      v[e] = d < D ? p[d] : 0.f;
    }
  }
}

__host__ __forceinline__ bool al16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr int LN_WARPS = 8;  // warps of a forward block

// y = (x - mean) rsqrt(var + eps) g + b [rounded to bf16], row by row
template <int NV, int VEC>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, float* __restrict__ y, int rows, int D,
                 float eps, int round_out) {
  constexpr int E = NV * VEC;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * LN_WARPS;
  int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps
  // g and b: in registers with the float4 instances; the masked one (32
  // values a lane) reads them at each row from L1 instead
  constexpr int EG = VEC == 4 ? E : 1;
  float gv[EG], bv[EG], xn[E];
  if constexpr (VEC == 4) {
    lnb_load<NV, VEC>(g, gv, lane, D);
    lnb_load<NV, VEC>(b, bv, lane, D);
  }
  lnb_load<NV, VEC>(x + (size_t)row * D, xn, lane, D);
  for (; row < rows; row += stride) {
    float xv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) xv[e] = xn[e];
    if (row + stride < rows)  // the next row's loads, before this row's reductions
      lnb_load<NV, VEC>(x + (size_t)(row + stride) * D, xn, lane, D);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += xv[e];  // zeros past D
    const float mean = warp_sum(s) / (float)D;
    float v = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (VEC == 4 || lnb_col<VEC>(lane, e) < D) {
        const float t = xv[e] - mean;
        v = fmaf(t, t, v);
      }
    }
    const float r = rsqrtf(warp_sum(v) / (float)D + eps);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (VEC == 4) {
        xv[e] = (xv[e] - mean) * r * gv[e] + bv[e];
      } else {
        const int d = lnb_col<VEC>(lane, e);
        xv[e] = d < D ? (xv[e] - mean) * r * g[d] + b[d] : 0.f;
      }
      if (round_out) xv[e] = round_bf16(xv[e]);
    }
    float* out = y + (size_t)row * D;
    if constexpr (VEC == 4) {
#pragma unroll
      for (int c = 0; c < NV; ++c)
        __stcs(reinterpret_cast<float4*>(out) + lane + 32 * c,
               make_float4(xv[4 * c], xv[4 * c + 1], xv[4 * c + 2], xv[4 * c + 3]));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lnb_col<VEC>(lane, e);
        if (d < D) __stcs(out + d, xv[e]);
      }
    }
  }
}

// rows wider than a warp's registers hold (D > LNB_MAX_D): the columns of a
// row looped through L1 in each of the three passes
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_strided_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ b, float* __restrict__ y, int rows, int D,
                         float eps, int round_out) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
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
  const float r = rsqrtf(warp_sum(v) / (float)D + eps);
  for (int d = lane; d < D; d += 32) {
    float o = (xr[d] - mean) * r * g[d] + b[d];
    if (round_out) o = round_bf16(o);
    __stcs(yr + d, o);
  }
}

template <int NV, int VEC>
int launch_layernorm(const float* x, const float* g, const float* b, float* y, int rows,
                     int D, float eps, int round_out, cudaStream_t s) {
  auto kern = layernorm_kernel<NV, VEC>;
  static int resident = 0;  // blocks of this instance the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, LN_WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
    resident = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int need = (rows + LN_WARPS - 1) / LN_WARPS;
  kern<<<need < resident ? need : resident, LN_WARPS * 32, 0, s>>>(x, g, b, y, rows, D, eps,
                                                                    round_out);
  return (int)cudaGetLastError();
}

// x, y (rows, D); g, b (D,)
PD_API int pd_layernorm(const void* x, const void* g, const void* b, void* y,
                        int rows, int D, float eps, int round_out,
                        void* stream) {
  if (rows < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *X = (const float*)x, *G = (const float*)g, *B = (const float*)b;
  float* Y = (float*)y;
  if (D > LNB_MAX_D) {
    layernorm_strided_kernel<<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, s>>>(
        X, G, B, Y, rows, D, eps, round_out);
    return (int)cudaGetLastError();
  }
  const bool vec = D % 128 == 0 && al16(x) && al16(g) && al16(b) && al16(y);
  switch (vec ? D / 128 : 0) {
    case 3: return launch_layernorm<3, 4>(X, G, B, Y, rows, D, eps, round_out, s);
    case 4: return launch_layernorm<4, 4>(X, G, B, Y, rows, D, eps, round_out, s);
    case 6: return launch_layernorm<6, 4>(X, G, B, Y, rows, D, eps, round_out, s);
    case 8: return launch_layernorm<8, 4>(X, G, B, Y, rows, D, eps, round_out, s);
  }
  return launch_layernorm<32, 1>(X, G, B, Y, rows, D, eps, round_out, s);
}

// dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) [+ res], with
// dxhat = dh g; per block: the dg and db partials over its rows.
template <int NV, int VEC, bool PF>
__global__ void __launch_bounds__(LNB_WARPS * 32, NV * VEC <= 16 ? 2 : 1)
layernorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ dh, const float* __restrict__ res,
                     float* __restrict__ dx, float* __restrict__ part, int rows, int D,
                     float eps, int round_out) {
  constexpr int E = NV * VEC;
  __shared__ float red[LNB_WARPS][LNB_MAX_D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * LNB_WARPS;
  const float inv_d = 1.f / (float)D;
  float accg[E], accb[E], xn[E], dn[E];
#pragma unroll
  for (int e = 0; e < E; ++e) accg[e] = accb[e] = 0.f;

  int row = blockIdx.x * LNB_WARPS + warp;
  if (PF && row < rows) {
    lnb_load<NV, VEC>(x + (size_t)row * D, xn, lane, D);
    lnb_load<NV, VEC>(dh + (size_t)row * D, dn, lane, D);
  }
  for (; row < rows; row += stride) {
    float xv[E], dv[E], rv[E];
    if constexpr (PF) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xv[e] = xn[e];
        dv[e] = dn[e];
      }
      if (row + stride < rows) {  // the next row's loads, before this row's reductions
        lnb_load<NV, VEC>(x + (size_t)(row + stride) * D, xn, lane, D);
        lnb_load<NV, VEC>(dh + (size_t)(row + stride) * D, dn, lane, D);
      }
    } else {
      lnb_load<NV, VEC>(x + (size_t)row * D, xv, lane, D);
      lnb_load<NV, VEC>(dh + (size_t)row * D, dv, lane, D);
    }
    if (res) lnb_load<NV, VEC>(res + (size_t)row * D, rv, lane, D);

    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += xv[e];  // zeros past D
    const float mean = warp_sum(s) * inv_d;
    float v = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (VEC == 4 || lnb_col<VEC>(lane, e) < D) {
        const float t = xv[e] - mean;
        v = fmaf(t, t, v);
      }
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lnb_col<VEC>(lane, e);
      const float xh = (xv[e] - mean) * rstd;
      const float gd = (VEC == 4 || d < D) ? g[d] : 0.f;
      accg[e] = fmaf(dv[e], xh, accg[e]);
      accb[e] += dv[e];
      dv[e] *= gd;  // dxhat; zero past D
      xv[e] = xh;
      s1 += dv[e];
      s2 = fmaf(dv[e], xh, s2);
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    float o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      o[e] = rstd * (dv[e] - m1 - xv[e] * m2);
      if (res) o[e] += rv[e];
      if (round_out) o[e] = round_bf16(o[e]);
    }
    float* out = dx + (size_t)row * D;
    if constexpr (VEC == 4) {
#pragma unroll
      for (int c = 0; c < NV; ++c)
        reinterpret_cast<float4*>(out)[lane + 32 * c] =
            make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lnb_col<VEC>(lane, e);
        if (d < D) out[d] = o[e];
      }
    }
  }
  // dg, then db: the warps' partials of column d added in warp order
  float* pg = part + (size_t)blockIdx.x * 2 * D;
#pragma unroll 1
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lnb_col<VEC>(lane, e);
      if (VEC == 4 || d < D) red[warp][d] = which ? accb[e] : accg[e];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < LNB_WARPS; ++w) t += red[w][d];
      pg[which * D + d] = t;
    }
    __syncthreads();
  }
}

// Rows wider than LNB_MAX_D: layernorm_bwd_kernel's math with the dg / db
// sums of warp w in acc[w][d] and acc[LNB_WARPS + w][d] (shared, 2 x
// LNB_WARPS x D floats), merged in warp order as there.
template <int NV, int VEC>
__global__ void __launch_bounds__(LNB_WARPS * 32, 1)
layernorm_bwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ dh, const float* __restrict__ res,
                          float* __restrict__ dx, float* __restrict__ part, int rows, int D,
                          float eps, int round_out) {
  constexpr int E = NV * VEC;
  extern __shared__ float acc[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ag = acc + (size_t)warp * D;
  float* ab = acc + (size_t)(LNB_WARPS + warp) * D;
  const float inv_d = 1.f / (float)D;
  for (int d = lane; d < D; d += 32) ag[d] = ab[d] = 0.f;
  __syncwarp();
  for (int row = blockIdx.x * LNB_WARPS + warp; row < rows; row += gridDim.x * LNB_WARPS) {
    float xv[E], dv[E];
    lnb_load<NV, VEC>(x + (size_t)row * D, xv, lane, D);
    lnb_load<NV, VEC>(dh + (size_t)row * D, dv, lane, D);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) s += xv[e];  // zeros past D
    const float mean = warp_sum(s) * inv_d;
    float v = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (VEC == 4 || lnb_col<VEC>(lane, e) < D) {
        const float t = xv[e] - mean;
        v = fmaf(t, t, v);
      }
    }
    const float rstd = rsqrtf(warp_sum(v) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lnb_col<VEC>(lane, e);
      const float xh = (xv[e] - mean) * rstd;
      if (VEC == 4 || d < D) {
        ag[d] = fmaf(dv[e], xh, ag[d]);
        ab[d] += dv[e];
        dv[e] *= g[d];  // dxhat
      } else {
        dv[e] = 0.f;
      }
      xv[e] = xh;
      s1 += dv[e];
      s2 = fmaf(dv[e], xh, s2);
    }
    const float m1 = warp_sum(s1) * inv_d, m2 = warp_sum(s2) * inv_d;
    float* out = dx + (size_t)row * D;
    const float* rr = res ? res + (size_t)row * D : nullptr;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lnb_col<VEC>(lane, e);
      if (VEC == 4 || d < D) {
        float o = rstd * (dv[e] - m1 - xv[e] * m2);
        if (rr) o += rr[d];
        if (round_out) o = round_bf16(o);
        out[d] = o;
      }
    }
  }
  __syncthreads();
  float* pg = part + (size_t)blockIdx.x * 2 * D;
  for (int which = 0; which < 2; ++which) {
    const float* a = acc + (size_t)which * LNB_WARPS * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < LNB_WARPS; ++w) t += a[(size_t)w * D + d];
      pg[which * D + d] = t;
    }
  }
}

// out[l] = sum over b < B of part[b, l] for l < L: block (32, LNB_SUM_RUNS)
// owns 32 columns; thread (c, r) adds rows r, r + 8, ... in order, then
// thread (c, 0) adds the 8 runs in order.
__global__ void __launch_bounds__(32 * LNB_SUM_RUNS)
ln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int B, int L) {
  __shared__ float runs[LNB_SUM_RUNS][32];
  const int c = threadIdx.x, r = threadIdx.y;
  const int l = blockIdx.x * 32 + c;
  float t = 0.f;
  if (l < L)
    for (int b = r; b < B; b += LNB_SUM_RUNS) t += part[(size_t)b * L + l];
  runs[r][c] = t;
  __syncthreads();
  if (r == 0 && l < L) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < LNB_SUM_RUNS; ++k) s += runs[k][c];
    out[l] = s;
  }
}

// Blocks (partials) of layernorm_bwd over `rows` rows; ops/kernels.py
// layernorm_bwd_blocks holds the same.
PD_API int pd_layernorm_bwd_blocks(int rows) { return lnb_blocks(rows); }

// x, dh, res (may be null), dx (rows, D); g (D,); part (blocks, 2, D)
// scratch; dgb (2, D): dg then db.
PD_API int pd_layernorm_bwd(const void* x, const void* g, const void* dh,
                            const void* res, void* dx, void* part, void* dgb,
                            int rows, int D, float eps, int round_out,
                            void* stream) {
  if (D < 1 || D > LNB_WIDE_MAX_D || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = lnb_blocks(rows);
  const bool vec = D % 128 == 0 && al16(x) && al16(g) && al16(dh) && al16(res) && al16(dx);
  if (D > LNB_MAX_D) {
    auto* wide = vec && D == 1536 ? &layernorm_bwd_wide_kernel<12, 4>
                                  : &layernorm_bwd_wide_kernel<LNB_WIDE_MAX_D / 32, 1>;
    const int smem = 2 * LNB_WARPS * D * (int)sizeof(float);
    const cudaError_t attr =
        cudaFuncSetAttribute(wide, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    wide<<<blocks, LNB_WARPS * 32, smem, s>>>(
        (const float*)x, (const float*)g, (const float*)dh, (const float*)res, (float*)dx,
        (float*)part, rows, D, eps, round_out);
  } else {
    auto* kernel = &layernorm_bwd_kernel<32, 1, false>;
    if (vec) {
      switch (D / 128) {
        case 3: kernel = &layernorm_bwd_kernel<3, 4, true>; break;
        case 4: kernel = &layernorm_bwd_kernel<4, 4, false>; break;
        case 6: kernel = &layernorm_bwd_kernel<6, 4, false>; break;
        case 8: kernel = &layernorm_bwd_kernel<8, 4, false>; break;
      }
    }
    kernel<<<blocks, LNB_WARPS * 32, 0, s>>>(
        (const float*)x, (const float*)g, (const float*)dh, (const float*)res, (float*)dx,
        (float*)part, rows, D, eps, round_out);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int L = 2 * D;
  ln_bwd_sum_kernel<<<(L + 31) / 32, dim3(32, LNB_SUM_RUNS), 0, s>>>(
      (const float*)part, (float*)dgb, blocks, L);
  return (int)cudaGetLastError();
}
