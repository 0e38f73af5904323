// Tiled GEMM with a fused epilogue, y = epi(a @ W + bias) [+ residual], and
// the weight gradient of the same product, dW = X^T dY and db = colsum(dY).
//
// Replaces every matrix product inside the TPU kernels:
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (qkv, proj,
//                                              fc1 + exact-erf GELU, fc2)
//   posediffusion_tpu/ops/denoiser_kernel.py   encoder_layer_math (in_proj,
//                                              out_proj, linear1 + ReLU,
//                                              linear2), as run by
//   posediffusion_tpu/ops/sampler_kernel.py    _sampler_kernel
//   posediffusion_tpu/ops/vit_train_kernel.py  _fwd_call / _bwd_call: the
//                                              forward products with dropout
//                                              at the m1, mff and m2 sites
//                                              (:101), the dgrad products
//                                              dY W^T and the weight
//                                              gradients X^T dY of
//                                              _mlp_residual_bwd (:278) and
//                                              _attn_residual_bwd (:356)
//
// a is (M, K) float32; W is (K, N), or (N, K) read transposed (trans_w: the
// dgrad product dY W^T with W in its forward layout), float32 or bfloat16;
// bias (N,) or null; gain (N,) or null; residual and y (M, N) float32.
// round_a rounds a to bfloat16 as it is staged (the cast(...) of the TPU
// kernels' bf16 mode). The epilogue, in the TPU kernels' order: + bias,
// [pre <- v], activation, x gain[n] (DINOv2's LayerScale, (a@W + b) * ls at
// vit_train_kernel.py:210-212, :238-240), x dropout mask, [round to bf16,
// + residual, round to bf16 when the residual stream is bf16 (round_out)].
// The gated activation (ACT_SWIGLU, DINOv2 ViT-g/14's SwiGLU feed-forward,
// which the TPU kernels do not have) reads column pairs: the wrapper
// interleaves w12's halves, so x1 and x2 of hidden column j are columns 2j
// and 2j + 1 of the product and land in one thread's float4 of the
// epilogue; y (M, N / 2) gets silu(x1 + b) * (x2 + b) and pre the whole
// (M, N), so the forward writes no (M, N) x12 unless the backward's
// recompute asks for it. No gain, dropout, residual or trans_w with it (the
// wrapper refuses them), and only the TF32 wgmma route takes it, in an
// instance of its own (GATED) with 16-byte aligned outputs, so the ungated
// instance's epilogue is as it was (pd_linear refuses the gate on every
// other route: every w12 product of the train trunk tiles for TMA).
//
// Bound: compute. The ViT's train products (M = 512 images x 264 tokens =
// 135,168 rows, K and N 384 to 1,536) are 40-160 GFLOP each; the serving
// ViT's (M = 20 frames x 264 tokens = 5,280 rows) 1.6-6.2 GFLOP; the
// sampler's (M = 20 rows) are bound by reading the weights once (0.16-0.47
// us at HBM rate) and, in practice, by latency.
// Design: four forward kernels; linear_route (mirrored by
// ops/kernels.py linear_route) picks among the last three.
//   * M <= 32 and W not transposed (the denoiser's 20-row products, TPU
//     kernels 2 and 3): the few-rows route, linear_rows_kernel below. It
//     streams each weight element once with 16-byte copies, splits K over a
//     cluster of 8 blocks and N over enough column tiles to fill the card,
//     and can fold the pre-norm LayerNorm of a into its staging.
//   * bf16 W with round_a (the bf16 serving ViT, TPU kernel 1, and the bf16
//     train mode's forward and dgrad products): bf16 wgmma with A from
//     registers (linear_bf16_wgmma_kernel, 128 x 128 tiles on a
//     persistent grid, a producer warp feeding a TMA ring through mbarriers,
//     two consumer warpgroups that round a to bf16 as they load it).
//   * float32 a and W without round_a, rows TMA can address (16-byte
//     aligned bases, K % 4 == 0, N % 4 == 0): the float32 train trunks'
//     forward, recompute and dgrad products, the f32 serving ViT's and
//     SuperGlue's, down to a single tile (below one tile an SM it still
//     took about half of linear_tf32_kernel's device time on an H100:
//     kernel_probes.py --linear --few-tiles). 3xTF32 on TF32 wgmma (linear_tf32_wgmma_kernel, the same ring, roles and grid
//     as the bf16 tile; tf32_split_kernel first writes W's hi and lo TF32
//     halves K-major into the call's scratch, the consumers split a in
//     registers).
//   * float32 a otherwise (a bf16 W, round_a, rows off 16 bytes or K, N
//     off 4): 3xTF32 mma.sync
//     tiles (linear_tf32_kernel, 128 x 128 a block, a 3-stage cp.async
//     ring), two TF32 products where one operand is exact in TF32 (a bf16
//     W, or a rounded a). The f32 products on the tensor cores: 495 TFLOP/s
//     of TF32 for three products against 67 of float32 FMA. The JAX
//     kernel's f32 dot with a bf16 weight is the same function: the widened
//     weight is exact.
// The weight gradient reduces over all M rows into a small (K, N) result:
// the rows are split into S ranges, one block per (range, output tile)
// writes an f32 partial (S, K, N), and a second pass (train.cu,
// pd_sum_partials) sums the S partials in order. That is the TPU kernel's
// per-batch-chunk partials (:937-940): deterministic, no atomics. In float32
// mode its products are 3xTF32, on TF32 wgmma where TMA can address X and
// dY (wgrad_tf32_wgmma_kernel below), else on mma.sync (wgrad_tf32_kernel);
// in bf16 mode bf16 wgmma (wgrad_bf16_wgmma_kernel in wgrad.cu, both
// operands rounded into shared memory); all three are 128 x 128 tiles and
// take db, the column sum of dY, in the same pass. TF32 wgmma reads B from
// shared memory only K-major: A ((M, K) row-major: a in the forward, dY in
// the dgrad) and the dgrad's W (N, K) are K-major as they lie, the
// forward's W (K, N) is MN-major and is transposed as its TF32 halves are
// written; both operands of the weight gradient (X and dY, contracted over
// rows) are M-major, so its wgmma tile takes X^T as A from registers and
// transposes dY into K-major TF32 halves inside the tile. bf16 wgmma takes
// MN-major operands, so the bf16 routes read W (K, N), X and dY as they
// lie.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"
#include "hopper.cuh"

namespace {

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU) return gelu_f(v);
  return v;
}

struct Epilogue {
  const float* bias;
  const float* gain;
  const float* res;
  float* y;
  float* pre;
  int act;
  int round_out;
  DropArgs drop;

  __device__ __forceinline__ void store(float acc, int m, int n, int N) const {
    const size_t idx = (size_t)m * N + n;
    float v = acc + (bias ? bias[n] : 0.f);
    if (pre) pre[idx] = v;
    v = activate(v, act);
    if (gain) v *= gain[n];
    v *= drop_mul(drop, (unsigned int)idx);
    if (res) {
      if (round_out) v = round_bf16(v);
      v += res[idx];
      if (round_out) v = round_bf16(v);
    }
    y[idx] = v;
  }

  // Columns n .. n + 3 of row m (N % 4 == 0; y, pre and res 16-byte
  // aligned): the same steps as store, with the residual r loaded by the
  // caller.
  __device__ __forceinline__ void store4(float4 acc, float4 r, int m, int n, int N) const {
    const size_t idx = (size_t)m * N + n;
    float v[4] = {acc.x, acc.y, acc.z, acc.w};
    const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += bias ? bias[n + j] : 0.f;
    if (pre) *reinterpret_cast<float4*>(pre + idx) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = activate(v[j], act);
      if (gain) v[j] *= gain[n + j];
      v[j] *= drop_mul(drop, (unsigned int)(idx + j));
      if (res) {
        if (round_out) v[j] = round_bf16(v[j]);
        v[j] += rv[j];
        if (round_out) v[j] = round_bf16(v[j]);
      }
    }
    *reinterpret_cast<float4*>(y + idx) = make_float4(v[0], v[1], v[2], v[3]);
  }

  // The gated activation's columns n .. n + 3 of row m (n % 4 == 0, N % 4
  // == 0, y and pre aligned): x1, x2 of hidden columns n / 2 and n / 2 + 1.
  // The kernels pick it or store4 once an epilogue pass, so store4's pass is
  // the ungated products' own code.
  __device__ __forceinline__ void store4_gated(float4 acc, int m, int n, int N) const {
    const size_t idx = (size_t)m * N + n;
    float4 v = acc;
    if (bias) v = make_float4(v.x + bias[n], v.y + bias[n + 1], v.z + bias[n + 2], v.w + bias[n + 3]);
    if (pre) *reinterpret_cast<float4*>(pre + idx) = v;
    *reinterpret_cast<float2*>(y + idx / 2) = make_float2(silu_f(v.x) * v.y, silu_f(v.z) * v.w);
  }
};

// ---- float32 a on the tensor cores: 3xTF32 mma.sync m16n8k8
//
// y = epi(a @ W), a (M, K) float32 with M > 32 (any M with trans_w); W
// (K, N), or (N, K) read transposed, float32 or bfloat16.
//   * Tiles: 128 x 128 of y, 8 warps of 64 (m) x 32 (n), 16 MMA tiles a
//     warp. The grid is persistent (one block an SM, LT_THREADS threads):
//     block b takes tiles b, b + grid, ..., n fastest (the blocks working
//     at once share a's rows in L2). Every (tile, K slice of 64) step
//     streams through one ring of LT_STAGES slots with cp.async, so the
//     next tile's first slices load during a tile's epilogue. 16-byte
//     copies where a row is 16-byte aligned, element copies otherwise;
//     zeros past M, N and K. One barrier a slice.
//   * Fragments by 128-bit loads: within each 16 of K, MMA depth t of step
//     s is k = 4t + 2s and depth t + 4 is 4t + 2s + 1, so a lane reads a's
//     four k of a row with one float4 ([m][k], rows of 80 floats: 16 mod
//     32 banks); MMA column g of n tile j is column 4g + j of the warp's
//     32, so a lane reads W's four columns of a depth with one float4
//     ([k][n] rows of 128, 16-byte chunks XOR-swizzled by 2 ((k / 4) % 4))
//     or, with trans_w, one depth run of a column ([n][k], rows of 68: 4
//     mod 32). Every quarter-warp then hits 8 distinct 16-byte bank groups:
//     six LDS.128 per 8 of K a warp. A bf16 W stays bf16 in shared memory
//     (rows of 136 or 72) and is widened at the load (8-byte loads).
//   * Precision: hi = tf32(x), lo = x - hi; a product is lo.hi + hi.lo +
//     hi.hi, about 2^-21 relative. A bf16 W (8 mantissa bits) or a rounded
//     a (round_a) is exact in TF32, so its lo is 0 and that MMA is skipped:
//     two products, the same sums. The tensor core truncates each sum into
//     its accumulator, so each 64-wide slice of K goes into a zeroed
//     accumulator that is then added, rounded to nearest, into the running
//     one (as in wgrad_tf32_kernel): the truncations stay relative to a
//     slice's partial sum.
//   * Epilogue: the tile goes from the accumulators into the ring slot just
//     read (rows of 132 floats) and back out in rows, four columns a
//     thread: the residual of four such runs is loaded before the first is
//     computed, and y (and pre) are written as float4 (N % 4 == 0 and
//     aligned outputs; else element by element). The dropout mask depends
//     on (key, element index) only, so this tiling draws the mask of any
//     other.
constexpr int LT_BM = 128, LT_BN = 128, LT_BK = 64;
constexpr int LT_STAGES = 3;  // two slices in flight while one is read
constexpr int LT_THREADS = 256;
constexpr int LT_LDA = LT_BK + 16;  // a [m][k], floats: 16 mod 32 banks
constexpr int LT_LDC = LT_BN + 4;   // the output tile's shared row stride, floats

// The staged W of one slice: [k][n] (ROWS = LT_BK) or, transposed, [n][k]
// (ROWS = LT_BN), LD elements a row; SWZ: 16-byte chunks XOR-swizzled.
template <typename WT, bool TRANS>
struct LtW {
  static constexpr bool F32 = sizeof(WT) == 4;
  static constexpr int ROWS = TRANS ? LT_BN : LT_BK;
  static constexpr int COLS = TRANS ? LT_BK : LT_BN;
  static constexpr int LD = TRANS ? COLS + (F32 ? 4 : 8) : COLS + (F32 ? 0 : 8);
  static constexpr bool SWZ = F32 && !TRANS;
  static constexpr int BYTES = ROWS * LD * (int)sizeof(WT);
};

// a ring slot: a's and W's slices, or the output tile
template <typename WT, bool TRANS>
__host__ __device__ constexpr int lt_stage_bytes() {
  return 4 * LT_BM * LT_LDA + LtW<WT, TRANS>::BYTES > 4 * LT_BM * LT_LDC
             ? 4 * LT_BM * LT_LDA + LtW<WT, TRANS>::BYTES
             : 4 * LT_BM * LT_LDC;
}

// the swizzled position of float column c in row r of a [k][n] f32 tile
__device__ __forceinline__ int lt_swz(int r, int c) {
  return ((c >> 2) ^ (2 * ((r >> 2) & 3))) * 4 + (c & 3);
}

// four W values a lane reads at once, widened to float
__device__ __forceinline__ void lt_ld4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void lt_ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

template <typename WT, bool TRANS, bool ROUND_A>
__global__ void __launch_bounds__(LT_THREADS, 1)
linear_tf32_kernel(const float* __restrict__ A, const WT* __restrict__ W, Epilogue ep,
                   int M, int N, int K, int vec_a, int vec_w, int vec_out) {
  using WS = LtW<WT, TRANS>;
  constexpr int STAGE = lt_stage_bytes<WT, TRANS>();
  constexpr bool W_EXACT = !WS::F32;  // bf16: lo == 0
  extern __shared__ float4 lt_smem4[];
  char* smem = reinterpret_cast<char*>(lt_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int tiles_n = (N + LT_BN - 1) / LT_BN;
  const int tiles = tiles_n * ((M + LT_BM - 1) / LT_BM);
  const int slices = max(1, (K + LT_BK - 1) / LT_BK);
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = mine * slices;  // (tile, slice) steps of this block

  // the origin of the tile of step q
  auto origin = [&](int q, int& m0, int& n0) {
    const int tile = (int)blockIdx.x + (q / slices) * (int)gridDim.x;
    m0 = (tile / tiles_n) * LT_BM;
    n0 = (tile % tiles_n) * LT_BN;
  };

  // step q into ring slot q % LT_STAGES: a, then W
  auto stage = [&](int q) {
    float* as = reinterpret_cast<float*>(smem + (q % LT_STAGES) * STAGE);
    WT* ws = reinterpret_cast<WT*>(as + LT_BM * LT_LDA);
    int m0, n0;
    origin(q, m0, n0);
    const int k0 = (q % slices) * LT_BK;
    if (vec_a) {
      for (int e = tid; e < LT_BM * (LT_BK / 4); e += LT_THREADS) {
        const int r = e / (LT_BK / 4), c = 4 * (e % (LT_BK / 4));
        const bool ok = m0 + r < M && k0 + c < K;  // K % 4 == 0: whole chunks
        cp_async16(as + r * LT_LDA + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
      }
    } else {
      for (int e = tid; e < LT_BM * LT_BK; e += LT_THREADS) {
        const int r = e / LT_BK, c = e % LT_BK;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async4(as + r * LT_LDA + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
      }
    }
    // tile row r is W's row r0 + r (of rlim), column c its column c0 + c (of clim)
    const int r0 = TRANS ? n0 : k0, c0 = TRANS ? k0 : n0;
    const int rlim = TRANS ? N : K, clim = TRANS ? K : N;
    constexpr int VEC = 16 / (int)sizeof(WT);
    if (vec_w) {
      for (int e = tid; e < WS::ROWS * (WS::COLS / VEC); e += LT_THREADS) {
        const int r = e / (WS::COLS / VEC), c = VEC * (e % (WS::COLS / VEC));
        const bool ok = r0 + r < rlim && c0 + c < clim;  // clim % VEC == 0
        const WT* src = ok ? W + (size_t)(r0 + r) * clim + c0 + c : W;
        WT* dst = ws + r * WS::LD + (WS::SWZ ? lt_swz(r, c) : c);
        cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), ok);
      }
    } else {
      for (int e = tid; e < WS::ROWS * WS::COLS; e += LT_THREADS) {
        const int r = e / WS::COLS, c = e % WS::COLS;
        const bool ok = r0 + r < rlim && c0 + c < clim;
        const WT* src = W + (size_t)(r0 + r) * clim + c0 + c;
        WT* dst = ws + r * WS::LD + (WS::SWZ ? lt_swz(r, c) : c);
        if constexpr (W_EXACT) {  // no 2-byte cp.async: a plain copy
          *dst = ok ? *src : WT(0.f);
        } else {
          cp_async4(dst, ok ? src : W, ok);
        }
      }
    }
  };

  float acc[4][4][4], tmp[4][4][4];

#pragma unroll
  for (int q = 0; q < LT_STAGES - 1; ++q) {
    if (q < steps) stage(q);
    cp_async_commit();
  }
  for (int q = 0; q < steps; ++q) {
    cp_async_wait<LT_STAGES - 2>();
    __syncthreads();  // step q is in; slot (q - 1) % LT_STAGES is free
    if (q + LT_STAGES - 1 < steps) stage(q + LT_STAGES - 1);
    cp_async_commit();
    const int slice = q % slices;
    const float* as = reinterpret_cast<const float*>(smem + (q % LT_STAGES) * STAGE);
    const WT* ws = reinterpret_cast<const WT*>(as + LT_BM * LT_LDA);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (slice == 0) acc[i][j][e] = 0.f;
          tmp[i][j][e] = 0.f;
        }
#pragma unroll
    for (int kk = 0; kk < LT_BK; kk += 16) {
      // W at depth kk + 4t + q, column wn + 4g + j of the warp: bv[q][j]
      float bv[4][4];
      if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v[4];
          lt_ld4(ws + (wn + 4 * g + j) * WS::LD + kk + 4 * t, v);
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) bv[q4][j] = v[q4];
        }
      } else {
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int r = kk + 4 * t + q4;
          lt_ld4(ws + r * WS::LD + (WS::SWZ ? lt_swz(r, wn + 4 * g) : wn + 4 * g), bv[q4]);
        }
      }
      // a at row wm + 16i + g + 8h, depths kk + 4t .. + 3: av[i][h]
      float av[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 f = *reinterpret_cast<const float4*>(
              as + (wm + 16 * i + g + 8 * h) * LT_LDA + kk + 4 * t);
          av[i][h][0] = f.x; av[i][h][1] = f.y; av[i][h][2] = f.z; av[i][h][3] = f.w;
        }
#pragma unroll
      for (int st = 0; st < 2; ++st) {  // MMA depth t is k 4t + 2st, t + 4 is 4t + 2st + 1
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if constexpr (W_EXACT) {
              bh[j][u] = __float_as_uint(bv[2 * st + u][j]);
              bl[j][u] = 0u;
            } else {
              split_tf32(bv[2 * st + u][j], bh[j][u], bl[j][u]);
            }
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const float x[4] = {av[i][0][2 * st], av[i][1][2 * st], av[i][0][2 * st + 1],
                              av[i][1][2 * st + 1]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (ROUND_A) {
              ah[e] = __float_as_uint(round_bf16(x[e]));
              al[e] = 0u;
            } else {
              split_tf32(x[e], ah[e], al[e]);
            }
          }
          // term by term over the 4 n tiles: an accumulator's next MMA is
          // 4 MMAs on (lo.hi, hi.lo, hi.hi: the same order for each)
          if constexpr (!ROUND_A) {
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(tmp[i][j], al, bh[j][0], bh[j][1]);
          }
          if constexpr (!W_EXACT) {
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32(tmp[i][j], ah, bl[j][0], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(tmp[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += tmp[i][j][e];
    if (slice != slices - 1) continue;

    // the tile's epilogue: accumulator (m tile i, n tile j) element 2h + c
    // is row wm + 16i + g + 8h, column wn + 8t + 4c + j
    int m0, n0;
    origin(q, m0, n0);
    float* cs = reinterpret_cast<float*>(smem + (q % LT_STAGES) * STAGE);
    __syncthreads();  // the slot's last readers are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          *reinterpret_cast<float4*>(cs + (wm + 16 * i + g + 8 * h) * LT_LDC + wn + 8 * t + 4 * c) =
              make_float4(acc[i][0][2 * h + c], acc[i][1][2 * h + c], acc[i][2][2 * h + c],
                          acc[i][3][2 * h + c]);
    __syncthreads();
    if (vec_out) {
      constexpr int RUNS = LT_BM * LT_BN / 4, U = 4;  // float4 runs; loads in flight
#pragma unroll 1
      for (int e0 = tid; e0 < RUNS; e0 += U * LT_THREADS) {
        float4 v[U], r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * LT_THREADS, row = e / (LT_BN / 4), c = 4 * (e % (LT_BN / 4));
          const int m = m0 + row, n = n0 + c;
          v[u] = *reinterpret_cast<const float4*>(cs + row * LT_LDC + c);
          r[u] = ep.res && m < M && n < N
                     ? *reinterpret_cast<const float4*>(ep.res + (size_t)m * N + n)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * LT_THREADS, row = e / (LT_BN / 4), c = 4 * (e % (LT_BN / 4));
          if (m0 + row < M && n0 + c < N) ep.store4(v[u], r[u], m0 + row, n0 + c, N);
        }
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < LT_BM * LT_BN; e += LT_THREADS) {
        const int row = e / LT_BN, c = e % LT_BN;
        if (m0 + row < M && n0 + c < N) ep.store(cs[row * LT_LDC + c], m0 + row, n0 + c, N);
      }
    }
  }
  cp_async_wait<0>();
}

// ---- bf16 W with round_a on wgmma (sm_90a)
//
// y = epi(round_bf16(a) @ W), a (M, K) float32 with M > 32 (any M with
// trans_w); W bf16 (K, N), or (N, K) read transposed: the TPU kernels'
// cast(...) of a and their preferred_element_type=f32 dots.
//   * Tiles: 128 x 128 of y (ops/kernels.py tabulates the tiles and waves
//     at the serving ViTs' shapes). The grid is persistent (one block an
//     SM): block b takes tiles b, b + grid, ..., n fastest. A tile's 64-wide K slice moves 48
//     KB from L2 (a in float32, two thirds of it) for 1 M MACs: at the
//     ViT's widths that, not the MMAs, bounds the kernel.
//   * Roles: warpgroups 0 and 1 consume, each owning 64 rows of the tile;
//     warp 8 (warpgroup 2) produces. Every (tile, 64-wide K slice) step goes
//     through a ring of Bw::STAGES slots guarded by mbarriers (full: the
//     slot's loads have landed; empty: the 8 consumer warps are done with
//     it), so the producer loads the next tile's first slices while the
//     consumers run a tile's epilogue. setmaxnreg moves registers from the
//     producer's warpgroup (40 a thread) to the consumers' (232).
//   * Loads: TMA (cp.async.bulk.tensor; the tensor maps are encoded on the
//     host through the CUDA driver API's entry point, no -lcuda: a's at each
//     call, W's once per (address, shape) and kept) with the 128-byte swizzle: a as two
//     128-row x 32-float boxes a slice, W as 64 x 64 boxes (the forward: 64
//     columns of N by 64 rows of K, N contiguous) or one 128 x 64 box
//     (trans_w: 128 rows of N by 64 of K, K contiguous); zeros past M, N and
//     K. Where a row is not 16-byte aligned (K % 4, N % 8 (K % 8 with
//     trans_w) or a base off 16 bytes) the producer warp writes the same
//     swizzled layout with element loads instead.
//   * Products: wgmma.mma_async m64n128k16, bf16 x bf16 -> f32, A from
//     registers: a consumer thread reads its fragment's float pairs of a
//     from the slot (two wavefronts a warp-wide 8-byte load, the least) and
//     rounds them with cvt.rn.bf16x2.f32 into the A registers, round_a's
//     rounding site, so a is never written back as bf16. B comes from the
//     slot through a matrix descriptor: the forward's W is MN-major (the
//     transpose bit set; LBO the stride of 64-column blocks, SBO of 8-row
//     groups of K), the dgrad's K-major (SBO the stride of 8-row groups of
//     N). One kernel template serves both.
//   * Precision: a bf16 x bf16 product is exact in float32, and the tensor
//     core truncates each sum into its accumulator, so each 64-wide K slice
//     (four k16 MMAs) goes into a fresh accumulator that is then added,
//     rounded to nearest, into the running one, as in linear_tf32_kernel. A
//     fixed order: the result repeats bitwise.
//   * Epilogue: each consumer warpgroup writes its 64 rows of the tile into
//     its own shared buffer (rows of 128 + 4 floats; not a ring slot, so
//     the loads go on) and walks them in float4 runs through Epilogue::store4,
//     element by element where N % 4 or alignment forbid: one copy of the
//     epilogue's math.
constexpr int BW_BK = 64;                      // K of a slot: one 128-byte row of bf16
constexpr int BW_BN = 128;                     // columns of a tile (m64n128k16)
constexpr int BW_THREADS = 384;                // warpgroups 0, 1 consume; 2 produces
constexpr int BW_MAX_SMEM = 232448;            // bytes of shared memory a block may use

// the tile's shared memory: 1,024 bytes of alignment slack, STAGES ring
// slots (a's BM x 64 float32 slice in two 32-float halves, W's 64 x 128
// bf16 one; multiples of 1,024 bytes), the two warpgroups' epilogue buffers
// (64 rows of 128 + 4 floats each), then the full and empty barriers
// (ops/kernels.py linear_bf16_smem_bytes holds the same)
struct Bw {
  static constexpr int BM = 128;  // rows of a tile: two warpgroups of 64
  static constexpr int A_HALF = BM * 128;
  static constexpr int A_BYTES = 2 * A_HALF;
  static constexpr int STAGE = A_BYTES + BW_BK * BW_BN * 2;
  static constexpr int LDC = BW_BN + 4;  // an epilogue row, floats
  static constexpr int EPI = BM * LDC * 4;
  static constexpr int STAGES = 3;  // as many as fit beside the epilogue buffers
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI + 2 * STAGES * 8;
};


#define BW_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BW_D16(i) BW_D4(i), BW_D4(i + 4), BW_D4(i + 8), BW_D4(i + 12)

// d (+)= a @ B, m64n128k16: a the thread's four bf16x2 A registers, B by its
// descriptor, TB the transpose bit of B (1: MN-major), acc 0 zeroes d first
template <int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : BW_D16(0), BW_D16(16), BW_D16(32), BW_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TB));
}

// d (+)= a @ B, m64n128k8 TF32: a the thread's four TF32 A registers, B
// K-major by its descriptor (TF32 wgmma has no transpose), acc 0 zeroes d
// first
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : BW_D16(0), BW_D16(16), BW_D16(32), BW_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}
#undef BW_D16
#undef BW_D4

// the producer's path without TMA: a's and W's slices of step (m0, n0, k0)
// into the layouts TMA writes, by element loads (zeros past M, N and K)
template <int BM, bool TRANS>
__device__ __forceinline__ void bw_stage_elements(unsigned char* sa, unsigned char* sb,
                                                  const float* A, const __nv_bfloat16* W,
                                                  int m0, int n0, int k0, int M, int N, int K,
                                                  int lane) {
  for (int e = lane; e < BM * BW_BK; e += 32) {
    const int r = e / BW_BK, c = e % BW_BK;
    const bool ok = m0 + r < M && k0 + c < K;
    *reinterpret_cast<float*>(sa + (c >> 5) * BM * 128 + bw_swz(r, 4 * (c & 31))) =
        ok ? A[(size_t)(m0 + r) * K + k0 + c] : 0.f;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int e = lane; e < BW_BK * BW_BN; e += 32) {
    if constexpr (TRANS) {  // row n of the slot, element k
      const int n = e / BW_BK, k = e % BW_BK;
      const bool ok = n0 + n < N && k0 + k < K;
      *reinterpret_cast<__nv_bfloat16*>(sb + bw_swz(n, 2 * k)) =
          ok ? W[(size_t)(n0 + n) * K + k0 + k] : zero;
    } else {  // 64-column block n / 64, row k, element n % 64
      const int k = e / BW_BN, n = e % BW_BN;
      const bool ok = k0 + k < K && n0 + n < N;
      *reinterpret_cast<__nv_bfloat16*>(sb + (n >> 6) * 8192 + bw_swz(k, 2 * (n & 63))) =
          ok ? W[(size_t)(k0 + k) * N + n0 + n] : zero;
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(BW_THREADS, 1)
linear_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ A,
                         const __nv_bfloat16* __restrict__ W, Epilogue ep, int M, int N, int K,
                         int use_tma, int vec_out) {
  using S = Bw;
  extern __shared__ __align__(1024) unsigned char bw_smem[];
  unsigned char* smem = bw_smem + ((1024 - (smem_u32(bw_smem) & 1023)) & 1023);
  float* epi = reinterpret_cast<float*>(smem + S::STAGES * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::STAGES * S::STAGE + S::EPI);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BW_BN - 1) / BW_BN;
  const int tiles = tiles_n * ((M + S::BM - 1) / S::BM);
  const int slices = max(1, (K + BW_BK - 1) / BW_BK);
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = mine * slices;  // (tile, slice) steps of this block

  // the origin of the block's tile i
  auto origin = [&](int i, int& m0, int& n0) {
    const int tile = (int)blockIdx.x + i * (int)gridDim.x;
    m0 = (tile / tiles_n) * S::BM;
    n0 = (tile % tiles_n) * BW_BN;
  };

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: warp 8 loads, 9-11 leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      int stage = 0;
      uint32_t phase = 0;
      for (int q = 0; q < steps; ++q) {
        mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every slot free
        int m0, n0;
        origin(q / slices, m0, n0);
        const int k0 = (q % slices) * BW_BK;
        unsigned char* sa = smem + stage * S::STAGE;
        unsigned char* sb = sa + S::A_BYTES;
        if (use_tma) {
          if (lane == 0) {
            mbar_expect_tx(&full[stage], S::STAGE);
            tma_load_2d(sa, &tm_a, k0, m0, &full[stage]);
            tma_load_2d(sa + S::A_HALF, &tm_a, k0 + 32, m0, &full[stage]);
            if constexpr (TRANS) {
              tma_load_2d(sb, &tm_w, k0, n0, &full[stage]);
            } else {
#pragma unroll
              for (int cb = 0; cb < BW_BN / 64; ++cb)
                tma_load_2d(sb + cb * 8192, &tm_w, n0 + 64 * cb, k0, &full[stage]);
            }
          }
        } else {
          bw_stage_elements<S::BM, TRANS>(sa, sb, A, W, m0, n0, k0, M, N, K, lane);
          // generic-proxy stores, read by wgmma through the async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[stage]);
        }
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + g;  // A rows r0, r0 + 8; r0 % 8 == g
    float* ce = epi + wg * 64 * S::LDC;            // this warpgroup's epilogue rows
    float acc[BW_BN / 2], part[BW_BN / 2];
    for (int i = 0; i < mine; ++i) {  // both warpgroups on each of the block's tiles
      for (int slice = 0; slice < slices; ++slice) {
        const int q = i * slices + slice, stage = q % S::STAGES;
        mbar_wait(&full[stage], (q / S::STAGES) & 1);
        const unsigned char* sa = smem + stage * S::STAGE;
        const uint32_t sb = smem_u32(sa + S::A_BYTES);
        // A of k16 step kk: (r0, c..c+1), (r0 + 8, c..), (r0, c+8..), (r0 + 8,
        // c+8..) with c = 16 kk + 2t, rounded to bf16 pairs (low half: c)
        uint32_t af[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned char* half = sa + (kk >> 1) * S::A_HALF;
          const int b = 64 * (kk & 1) + 8 * t;  // byte of column c in the half's row
          const float2 x0 = *reinterpret_cast<const float2*>(half + bw_swz(r0, b));
          const float2 x1 = *reinterpret_cast<const float2*>(half + bw_swz(r0 + 8, b));
          const float2 x2 = *reinterpret_cast<const float2*>(half + bw_swz(r0, b + 32));
          const float2 x3 = *reinterpret_cast<const float2*>(half + bw_swz(r0 + 8, b + 32));
          af[kk][0] = pack_bf16(x0.x, x0.y);
          af[kk][1] = pack_bf16(x1.x, x1.y);
          af[kk][2] = pack_bf16(x2.x, x2.y);
          af[kk][3] = pack_bf16(x3.x, x3.y);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k16 step kk: 32 bytes into each K-major row, or 16 rows of K
          const uint64_t desc = TRANS ? bw_desc(sb + 32 * kk, 16, 1024)
                                      : bw_desc(sb + 2048 * kk, 8192, 1024);
          wgmma_bf16<TRANS ? 0 : 1>(part, af[kk], desc, kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(part);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
        for (int j = 0; j < BW_BN / 2; ++j) acc[j] = slice == 0 ? part[j] : acc[j] + part[j];
      }

      // the tile's epilogue: accumulator 4j + 2h + c is row r0 + 8h, column
      // 8j + 2t + c of the tile
      int m0, n0;
      origin(i, m0, n0);
      const int wr = (warp & 3) * 16 + g;  // the row in this warpgroup's buffer
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // the last tile's runs are read
#pragma unroll
      for (int j = 0; j < BW_BN / 8; ++j) {
        *reinterpret_cast<float2*>(ce + wr * S::LDC + 8 * j + 2 * t) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(ce + (wr + 8) * S::LDC + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      const int lt = tid & 127, mw = m0 + wg * 64;
      if (vec_out) {
        constexpr int RUNS = 64 * BW_BN / 4, U = 4;  // float4 runs; loads in flight
#pragma unroll 1
        for (int e0 = lt; e0 < RUNS; e0 += U * 128) {
          float4 v[U], r[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * 128, row = e / (BW_BN / 4), c = 4 * (e % (BW_BN / 4));
            const int m = mw + row, n = n0 + c;
            v[u] = *reinterpret_cast<const float4*>(ce + row * S::LDC + c);
            r[u] = ep.res && m < M && n < N
                       ? *reinterpret_cast<const float4*>(ep.res + (size_t)m * N + n)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = e0 + u * 128, row = e / (BW_BN / 4), c = 4 * (e % (BW_BN / 4));
            if (mw + row < M && n0 + c < N) ep.store4(v[u], r[u], mw + row, n0 + c, N);
          }
        }
      } else {
#pragma unroll 1
        for (int e = lt; e < 64 * BW_BN; e += 128) {
          const int row = e / BW_BN, c = e % BW_BN;
          if (mw + row < M && n0 + c < N) ep.store(ce[row * S::LDC + c], mw + row, n0 + c, N);
        }
      }
    }
  }
}


// ---- float32 a and W on TF32 wgmma (sm_90a): 3xTF32
//
// y = epi(a @ W), a (M, K) float32; W float32 (K, N), or (N, K) read
// transposed (the dgrad dY W^T); rows TMA can address (linear_route).
// linear_tf32_kernel's mma.sync tops out at the TF32
// mma.sync issue ceiling (~316 TFLOP/s, 64% of the dense peak:
// kernel_probes.py --mma) and reached a quarter to a third of the 3xTF32
// rate at the train trunks' products; only wgmma reaches the rest. Bound:
// compute, three TF32 products of 2 M K N operations at 495 TFLOP/s (the
// train products are 40-160 GFLOP each).
//   * TF32 wgmma reads B from shared memory only K-major. A ((M, K)
//     row-major: a, or dY in the dgrad) is K-major as it lies; the dgrad's W
//     (N, K) is K-major, the forward's W (K, N) MN-major. tf32_split_kernel
//     first writes W's TF32 halves K-major into a scratch the wrapper
//     allocates for the call (2N rows of K: hi = cvt.rna.tf32(w), lo = w -
//     hi, split_tf32), transposing the forward's W through a shared tile and
//     splitting the dgrad's where it lies. Splitting W in the tile instead,
//     from a TMA-landed float32 slot into shared hi and lo tiles by converter
//     warps, cost the tile 11-18 points of the 3xTF32 rate
//     (measured on an H100 at 700 W); the scratch is at most 4.7 MB on the
//     train path, freed after the call, and its pass a few microseconds
//     against the product's 0.2-2.5 ms.
//   * Tiles, grid and roles as linear_bf16_wgmma_kernel: 128 x 128 of y, a
//     persistent grid (block b takes tiles b, b + grid, ..., n fastest),
//     warpgroups 0 and 1 consume (64 rows of the tile each), warp 8 loads
//     with TMA; setmaxnreg gives the consumers 232 registers, warpgroup 2
//     40. A ring slot (Tw) holds one 32-wide K slice: a (128 x 32 floats),
//     W's hi and its lo (128 rows of n x 32 of k), all with the 128-byte
//     swizzle, so hi and lo lie in wgmma's K-major B layout as they land.
//   * Products: wgmma m64n128k8 tf32 with A from registers: a consumer thread
//     reads its fragment of a from the slot (rows r0 and r0 + 8, columns t
//     and t + 4 of each k8 step) and splits it in registers. Each k8 step
//     runs lo.hi, hi.lo, hi.hi into one accumulator (linear_tf32_kernel's
//     order); lo.lo (~2^-22) is dropped.
//   * Precision: as linear_tf32_kernel, each 64-wide K slice (two slots) goes
//     into an accumulator zeroed by scale-d = 0 and is then added, rounded
//     to nearest, into the running one (the tensor core truncates its sums).
//     A fixed order, no atomics, no split of K: the result repeats bitwise.
//   * Epilogue: each consumer warpgroup passes its 64 x 128 of the tile
//     through its own shared buffer 32 columns at a time (rows of 40 floats:
//     the float2 writes of a half-warp hit 32 banks) into Epilogue::store4,
//     element by element where alignment forbids: the epilogue and dropout
//     mask of the other tiles. (Running a tile's passes behind the next
//     tile's first products measured no faster, so they run in place.)
constexpr int TW_BK = 32;        // K of a slot: one 128-byte row of float32
constexpr int TW_EPI_COLS = 32;  // columns of an epilogue pass

// the tile's shared memory (ops/kernels.py linear_tf32_wgmma_smem_bytes holds
// the same): 1,024 bytes of alignment slack, STAGES slots of a's slice, W's
// hi and its lo (16 KB each, multiples of 1,024 bytes), the two warpgroups'
// epilogue buffers (64 rows of 32 + 8 floats each), then the full and empty
// barriers
struct Tw {
  static constexpr int BM = 128, BN = 128;
  static constexpr int A_BYTES = BM * TW_BK * 4;
  static constexpr int W_BYTES = BN * TW_BK * 4;
  static constexpr int HI = A_BYTES, LO = A_BYTES + W_BYTES;  // offsets in a slot
  static constexpr int STAGE = LO + W_BYTES;
  static constexpr int STAGES = 4;  // as many as fit beside the epilogue buffers
  static constexpr int LDC = TW_EPI_COLS + 8;  // an epilogue row, floats
  static constexpr int EPI = 2 * 64 * LDC * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + EPI + 2 * STAGES * 8;
};

// W's TF32 halves, K-major: rows 0 .. N - 1 of hl hold hi, rows N .. 2N - 1
// lo; row n holds column n of the product's B (K values). TRANS: W (N, K)
// is split where it lies (float4 runs, K % 4 == 0); else W (K, N) goes
// through a 32 x 32 shared tile (32 x 8 threads) so both sides are read and
// written in rows.
template <bool TRANS>
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ W, uint32_t* __restrict__ hl, int N, int K) {
  const size_t total = (size_t)N * K;
  if constexpr (TRANS) {
    for (size_t i = 4 * ((size_t)blockIdx.x * 256 + threadIdx.x); i < total;
         i += 4 * (size_t)gridDim.x * 256) {
      const float4 v = *reinterpret_cast<const float4*>(W + i);
      uint4 h, l;
      split_tf32(v.x, h.x, l.x);
      split_tf32(v.y, h.y, l.y);
      split_tf32(v.z, h.z, l.z);
      split_tf32(v.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hl + i) = h;
      *reinterpret_cast<uint4*>(hl + total + i) = l;
    }
  } else {
    __shared__ float tile[32][33];
    const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
    for (int r = ty; r < 32; r += 8)
      tile[r][tx] = k0 + r < K && n0 + tx < N ? W[(size_t)(k0 + r) * N + n0 + tx] : 0.f;
    __syncthreads();
#pragma unroll
    for (int r = ty; r < 32; r += 8) {
      const int n = n0 + r, k = k0 + tx;
      if (n < N && k < K) {
        uint32_t h, l;
        split_tf32(tile[tx][r], h, l);
        hl[(size_t)n * K + k] = h;
        hl[total + (size_t)n * K + k] = l;
      }
    }
  }
}

template <bool GATED>
__global__ void __launch_bounds__(BW_THREADS, 1)
linear_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_w, Epilogue ep, int M, int N,
                         int K, int vec_out) {
  using S = Tw;
  extern __shared__ __align__(1024) unsigned char tw_smem[];
  unsigned char* smem = tw_smem + ((1024 - (smem_u32(tw_smem) & 1023)) & 1023);
  float* epi = reinterpret_cast<float*>(smem + S::STAGES * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::STAGES * S::STAGE + S::EPI);
  uint64_t* empty = full + S::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + S::BN - 1) / S::BN;
  const int tiles = tiles_n * ((M + S::BM - 1) / S::BM);
  const int slots = (K + TW_BK - 1) / TW_BK;  // K > 0 on this route
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = mine * slots;  // (tile, slot) steps of this block

  // the origin of the block's tile i
  auto origin = [&](int i, int& m0, int& n0) {
    const int tile = (int)blockIdx.x + i * (int)gridDim.x;
    m0 = (tile / tiles_n) * S::BM;
    n0 = (tile % tiles_n) * S::BN;
  };

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: warp 8 loads, 9-11 leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8) {
      for (int q = 0; q < steps; ++q) {
        const int stage = q % S::STAGES;
        mbar_wait(&empty[stage], ((q / S::STAGES) & 1) ^ 1);  // the first pass finds it free
        if (lane == 0) {
          int m0, n0;
          origin(q / slots, m0, n0);
          const int k0 = (q % slots) * TW_BK;
          unsigned char* sa = smem + stage * S::STAGE;
          mbar_expect_tx(&full[stage], S::STAGE);
          tma_load_2d(sa, &tm_a, k0, m0, &full[stage]);
          // hi's rows n0 .. n0 + 127 (past N they are lo's first rows or
          // zeros: columns the epilogue does not store), lo's N + n0 ..
          tma_load_2d(sa + S::HI, &tm_w, k0, n0, &full[stage]);
          tma_load_2d(sa + S::LO, &tm_w, k0, N + n0, &full[stage]);
        }
        __syncwarp();
      }
    }
  } else {  // the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + (warp & 3) * 16 + g;  // A rows r0, r0 + 8; r0 % 8 == g
    float* ce = epi + wg * 64 * S::LDC;            // this warpgroup's epilogue rows
    float acc[S::BN / 2], part[S::BN / 2];
    for (int i = 0; i < mine; ++i) {  // both warpgroups on each of the block's tiles
      for (int sl = 0; sl < slots; ++sl) {
        const int q = i * slots + sl, stage = q % S::STAGES;
        mbar_wait(&full[stage], (q / S::STAGES) & 1);
        const unsigned char* sa = smem + stage * S::STAGE;
        const uint32_t hi = smem_u32(sa + S::HI), lo = smem_u32(sa + S::LO);
        // A of k8 step kk: (r0, c), (r0 + 8, c), (r0, c + 4), (r0 + 8, c + 4)
        // with c = 8 kk + t, split into TF32 halves
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int b = 32 * kk + 4 * t;  // byte of column c in a's row
          const float x[4] = {*reinterpret_cast<const float*>(sa + bw_swz(r0, b)),
                              *reinterpret_cast<const float*>(sa + bw_swz(r0 + 8, b)),
                              *reinterpret_cast<const float*>(sa + bw_swz(r0, b + 16)),
                              *reinterpret_cast<const float*>(sa + bw_swz(r0 + 8, b + 16))};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(x[e], ah[kk][e], al[kk][e]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k8 step kk: 32 bytes into each K-major row of B
          const uint64_t dh = bw_desc(hi + 32 * kk, 16, 1024);
          const uint64_t dl = bw_desc(lo + 32 * kk, 16, 1024);
          wgmma_tf32(part, al[kk], dh, (sl & 1) | kk);  // 0 at a 64-wide slice's start
          wgmma_tf32(part, ah[kk], dl, 1);
          wgmma_tf32(part, ah[kk], dh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(part);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if ((sl & 1) || sl == slots - 1) {
#pragma unroll
          for (int j = 0; j < S::BN / 2; ++j) acc[j] = sl < 2 ? part[j] : acc[j] + part[j];
        }
      }

      // the tile's epilogue: accumulator 4j + 2h + c is row r0 + 8h, column
      // 8j + 2t + c of the tile; pass p takes columns 32p .. 32p + 31
      int m0, n0;
      origin(i, m0, n0);
      const int wr = (warp & 3) * 16 + g;  // the row in this warpgroup's buffer
      const int lt = tid & 127, mw = m0 + wg * 64;
#pragma unroll 1
      for (int p = 0; p < S::BN / TW_EPI_COLS; ++p) {
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");  // the last pass is read
#pragma unroll
        for (int j = 0; j < S::BN / 8; ++j) {
          if (j / (TW_EPI_COLS / 8) != p) continue;
          const int c = 8 * (j % (TW_EPI_COLS / 8)) + 2 * t;
          *reinterpret_cast<float2*>(ce + wr * S::LDC + c) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(ce + (wr + 8) * S::LDC + c) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        const int np = n0 + p * TW_EPI_COLS;
        if (vec_out) {
          constexpr int RUNS = 64 * TW_EPI_COLS / 4, U = RUNS / 128;  // float4 runs, all in flight
          float4 v[U], r[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = lt + u * 128, row = e / (TW_EPI_COLS / 4);
            const int c = 4 * (e % (TW_EPI_COLS / 4));
            const int m = mw + row, n = np + c;
            v[u] = *reinterpret_cast<const float4*>(ce + row * S::LDC + c);
            r[u] = ep.res && m < M && n < N
                       ? *reinterpret_cast<const float4*>(ep.res + (size_t)m * N + n)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          if constexpr (GATED) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int e = lt + u * 128, row = e / (TW_EPI_COLS / 4);
              const int c = 4 * (e % (TW_EPI_COLS / 4));
              if (mw + row < M && np + c < N) ep.store4_gated(v[u], mw + row, np + c, N);
            }
            continue;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int e = lt + u * 128, row = e / (TW_EPI_COLS / 4);
            const int c = 4 * (e % (TW_EPI_COLS / 4));
            if (mw + row < M && np + c < N) ep.store4(v[u], r[u], mw + row, np + c, N);
          }
        } else if constexpr (!GATED) {  // the gated instance runs with vec_out only
#pragma unroll 1
          for (int e = lt; e < 64 * TW_EPI_COLS; e += 128) {
            const int row = e / TW_EPI_COLS, c = e % TW_EPI_COLS;
            if (mw + row < M && np + c < N) ep.store(ce[row * S::LDC + c], mw + row, np + c, N);
          }
        }
      }
    }
  }
}

template <typename WT, bool TRANS, bool ROUND_A>
int launch_tf32(const float* a, const WT* w, const Epilogue& ep, int M, int N, int K,
                cudaStream_t s) {
  auto kern = linear_tf32_kernel<WT, TRANS, ROUND_A>;
  constexpr int smem = LT_STAGES * lt_stage_bytes<WT, TRANS>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((N + LT_BN - 1) / LT_BN) * ((M + LT_BM - 1) / LT_BM);
  if (tiles * ((K + LT_BK - 1) / LT_BK + 1) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec_a = K % 4 == 0 && aligned(a, 16);
  const int vec_w = (TRANS ? K : N) % (16 / (int)sizeof(WT)) == 0 && aligned(w, 16);
  const int vec_out = N % 4 == 0 && aligned(ep.y, 16) && aligned(ep.pre, 16) &&
                      aligned(ep.res, 16);
  const int grid = (int)(tiles < sms ? tiles : sms);  // persistent: one block an SM
  kern<<<grid, LT_THREADS, smem, s>>>(a, w, ep, M, N, K, vec_a, vec_w, vec_out);
  return (int)cudaGetLastError();
}

// W bf16 (exact in TF32: two products) or float32 (two products with
// round_a, three without), transposed or not
template <typename WT, bool ROUND_A>
int launch_tf32_t(const float* a, const WT* w, int trans, const Epilogue& ep, int M,
                  int N, int K, cudaStream_t s) {
  return trans ? launch_tf32<WT, true, ROUND_A>(a, w, ep, M, N, K, s)
               : launch_tf32<WT, false, ROUND_A>(a, w, ep, M, N, K, s);
}


// W's map, encoded once per (address, shape, box) and kept: the map holds
// these and not the data, so a kept one is exact for any weight at that
// address. At most 4,096 are kept (the serving ViT-B's and a train step's
// weights are a few hundred); past that the table starts again.
bool weight_tmap(CUtensorMap* map, const __nv_bfloat16* w, uint64_t rows, uint64_t cols,
                 uint32_t box_rows, uint32_t box_cols) {
  using Key = std::tuple<const void*, uint64_t, uint64_t, uint32_t, uint32_t>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> kept;
  const Key key{w, rows, cols, box_rows, box_cols};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *map = it->second;
    return true;
  }
  if (!tmap_2d(map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, cols, box_rows, box_cols))
    return false;
  if (kept.size() >= 4096) kept.clear();
  kept.emplace(key, *map);
  return true;
}

// setmaxnreg only moves registers within the block's allocation: the wgmma
// tiles' consumers' 232 a thread need the producer's 128 above 40, i.e. a
// launch at 168 (65,536 / 384); with fewer the consumers would wait forever
bool wgmma_regs_ok(const void* kern) {
  cudaFuncAttributes fa{};
  return cudaFuncGetAttributes(&fa, kern) == cudaSuccess &&
         fa.numRegs * BW_THREADS >= 232 * 256 + 40 * 128;
}

template <bool TRANS>
int launch_bf16(const float* a, const __nv_bfloat16* w, const Epilogue& ep, int M, int N, int K,
                cudaStream_t s) {
  using S = Bw;
  static_assert(S::SMEM <= BW_MAX_SMEM, "the ring does not fit");
  auto kern = linear_bf16_wgmma_kernel<TRANS>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  static const bool regs_ok = wgmma_regs_ok((const void*)kern);
  if (!regs_ok) return (int)cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((N + BW_BN - 1) / BW_BN) * ((M + S::BM - 1) / S::BM);
  if (tiles * ((K + BW_BK - 1) / BW_BK + 1) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a{}, tm_w{};
  const int use_tma = K > 0 && K % 4 == 0 && aligned(a, 16) && (TRANS ? K : N) % 8 == 0 &&
                      aligned(w, 16);
  if (use_tma) {
    const bool ok =
        tmap_2d(&tm_a, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, S::BM, 32) &&
        (TRANS ? weight_tmap(&tm_w, w, N, K, BW_BN, BW_BK) : weight_tmap(&tm_w, w, K, N, BW_BK, 64));
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const int vec_out = N % 4 == 0 && aligned(ep.y, 16) && aligned(ep.pre, 16) &&
                      aligned(ep.res, 16);
  const int grid = (int)(tiles < sms ? tiles : sms);  // persistent: one block an SM
  kern<<<grid, BW_THREADS, S::SMEM, s>>>(tm_a, tm_w, a, w, ep, M, N, K, use_tma, vec_out);
  return (int)cudaGetLastError();
}

int launch_bf16_t(const float* a, const __nv_bfloat16* w, int trans, const Epilogue& ep, int M,
                  int N, int K, cudaStream_t s) {
  return trans ? launch_bf16<true>(a, w, ep, M, N, K, s)
               : launch_bf16<false>(a, w, ep, M, N, K, s);
}

// W's halves into hl (2N x K, the wrapper's scratch), then the tile (GATED:
// the instance with the gated epilogue, which takes 16-byte aligned y and pre)
template <bool GATED>
int launch_tf32_wgmma(const float* a, const float* w, int trans, uint32_t* hl, const Epilogue& ep,
                      int M, int N, int K, cudaStream_t s) {
  using S = Tw;
  static_assert(S::SMEM <= BW_MAX_SMEM, "the ring does not fit");
  auto kern = linear_tf32_wgmma_kernel<GATED>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  static const bool regs_ok = wgmma_regs_ok((const void*)kern);
  if (!regs_ok) return (int)cudaErrorInvalidConfiguration;
  if (!hl) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((N + S::BN - 1) / S::BN) * ((M + S::BM - 1) / S::BM);
  if (tiles * ((K + TW_BK - 1) / TW_BK) > 0x7fffffffLL || 2LL * N * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (trans) {
    const long long blocks = ((long long)N * K / 4 + 255) / 256;  // a float4 run a thread
    tf32_split_kernel<true><<<(int)(blocks < 4 * sms ? blocks : 4 * sms), 256, 0, s>>>(w, hl, N, K);
  } else {
    tf32_split_kernel<false><<<dim3((N + 31) / 32, (K + 31) / 32), 256, 0, s>>>(w, hl, N, K);
  }
  const cudaError_t split = cudaGetLastError();
  if (split != cudaSuccess) return (int)split;
  CUtensorMap tm_a{}, tm_w{};
  const bool ok = tmap_2d(&tm_a, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, S::BM, TW_BK) &&
                  tmap_2d(&tm_w, hl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2ULL * N, K, S::BN, TW_BK);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int vec_out = aligned(ep.y, 16) && aligned(ep.pre, 16) && aligned(ep.res, 16);
  const int grid = (int)(tiles < sms ? tiles : sms);  // persistent: one block an SM
  kern<<<grid, BW_THREADS, S::SMEM, s>>>(tm_a, tm_w, ep, M, N, K, vec_out);
  return (int)cudaGetLastError();
}

// The route of pd_linear (ops/kernels.py linear_route mirrors it): bf16
// wgmma for a bf16 W with round_a; TF32 wgmma for a float32 W without
// round_a whose rows TMA can address (16-byte aligned a and W, K and N
// multiples of 4); mma.sync for the rest.
enum { ROUTE_TF32_MMA = 0, ROUTE_TF32_WGMMA = 1, ROUTE_BF16_WGMMA = 2 };

int linear_route(int K, int N, int w_bf16, int round_a, int a_aligned, int w_aligned) {
  if (w_bf16 && round_a) return ROUTE_BF16_WGMMA;
  if (!w_bf16 && !round_a && a_aligned && w_aligned && K > 0 && K % 4 == 0 && N % 4 == 0)
    return ROUTE_TF32_WGMMA;
  return ROUTE_TF32_MMA;
}

// ---- the few-rows route: y = epi(LN?(a) @ W) for M <= 32
//
// At 20 rows a product does 20 FMAs per weight element, so reading W once
// (bytes) and doing its FMAs (operations) both take ~0.5 us on the whole
// card at the largest of the sampler's shapes; what costs is latency and
// too few blocks. The grid is (column tiles of BN, 8) with the 8 blocks of a
// column tile one thread-block cluster, each owning a slice of K:
//   * staging: the block copies its K slice of a (M x slice, f32) and of W
//     (slice x BN, in W's own type) into shared memory with 16-byte
//     cp.async copies, all in flight at once (element copies when a row is
//     not 16-byte aligned: K % 4 or N * sizeof(W) % 16 not 0);
//   * LayerNorm (ln_g != null; the slice is one chunk, K <= 1,024): a and W
//     are two copy groups, so W is still landing while, with a in, 8 lanes
//     of the warp that owns a row take the sum and the centred sum of
//     squares of the block's slice of it; after one cluster barrier lane q
//     of the 8 reads rank q's pair, and shuffles merge them (the mean, then
//     the centred variance: sum over slices of M2_q + n_q (mean_q -
//     mean)^2); the lanes normalise the row in place, then round it to bf16
//     with round_a: the sites of layernorm(round_out) + linear(round_a);
//   * products: warp w owns rows 4w .. 4w+3 (warps past M idle); a lane
//     owns 8 columns (one 16-byte bf16 load from shared memory) and every
//     KL-th k of the slice, so it does 32 f32 FMAs per k with W widened to
//     float32, the JAX kernel's f32 dot with a bf16 weight (no TF32);
//   * reduction, in a fixed order: the KL lanes of a column group by a
//     butterfly of shuffles; then warp w stores its 4 rows into slot `rank`
//     of block w's shared memory (a distributed shared memory store), and
//     after one cluster barrier block w adds its 8 slots in rank order and
//     runs the shared Epilogue on rows 4w .. 4w+3. No atomics: the result
//     repeats bitwise.
// Every weight element is read from device memory once per call.
constexpr int FR_ROWS = 32;      // row limit of the route (ops/kernels.py)
constexpr int FR_THREADS = 256;  // 8 warps x 4 rows
constexpr int FR_CLUSTER = 8;    // blocks of a cluster split K, one per warp
constexpr int FR_KCH = 128;      // k of a slice staged at a time
constexpr int FR_LDA = FR_KCH + 8;  // a row of the staged a: 8 rows' k in 8 banks

namespace cg = cooperative_groups;

__host__ __device__ constexpr int rows_smem_bytes(int bn, int w_bytes) {
  // a chunk (32 x FR_LDA), the cluster's partial tiles of this block's rows
  // (8 x 4 x bn), the slice's row statistics (2 x 32), the LayerNorm's g
  // and b for the slice (2 x FR_KCH), then the W chunk (FR_KCH x bn)
  return 4 * (FR_ROWS * FR_LDA + FR_ROWS * bn + 2 * FR_ROWS + 2 * FR_KCH) +
         FR_KCH * bn * w_bytes;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  w[4] = v.x; w[5] = v.y; w[6] = v.z; w[7] = v.w;
}

// Split cluster barrier: arrive (no ordering) now, wait before the first
// access to another block's shared memory, which must have started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename WT, int BN>
__global__ void __cluster_dims__(1, FR_CLUSTER, 1) __launch_bounds__(FR_THREADS)
linear_rows_kernel(const float* __restrict__ A, const WT* __restrict__ W,
                   Epilogue ep, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, float eps, int M, int N,
                   int K, int round_a, int vec_a, int vec_w) {
  constexpr int CG = BN / 8, KL = 32 / CG;  // column groups, k lanes of a warp
  constexpr int WV = 16 / sizeof(WT);       // W elements in 16 bytes
  constexpr int SLOT = 4 * BN;              // one block's partial of 4 rows
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [FR_ROWS][FR_LDA]
  float* Rs = As + FR_ROWS * FR_LDA;         // [FR_CLUSTER][4][BN]
  float* s_sum = Rs + FR_CLUSTER * SLOT;     // [FR_ROWS] x 2
  float* s_m2 = s_sum + FR_ROWS;
  float* s_g = s_m2 + FR_ROWS;               // [FR_KCH] x 2
  float* s_b = s_g + FR_KCH;
  WT* Ws = reinterpret_cast<WT*>(s_b + FR_KCH);  // [FR_KCH][BN]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int ncols = min(BN, N - n0);
  const int slice = ((K + FR_CLUSTER - 1) / FR_CLUSTER + 3) & ~3;
  const int k0 = min(K, rank * slice), k1 = min(K, k0 + slice);
  const bool ln = ln_g != nullptr;
  if (!ln) cluster_arrive_relaxed();  // with ln, the statistics' barrier

  // rows M .. 4 ceil(M / 4) - 1 feed the last warp's FMAs: keep them zero
  const int mpad = (M + 3) & ~3;
  for (int i = tid; i < (mpad - M) * FR_KCH; i += FR_THREADS)
    As[(M + i / FR_KCH) * FR_LDA + i % FR_KCH] = 0.f;

  auto stage = [&](int kc, int kn) {
    if (vec_a) {
      const int q = kn / 4;  // K % 4 == 0, so every slice is whole float4s
      for (int i = tid; i < M * q; i += FR_THREADS) {
        const int m = i / q, c = 4 * (i % q);
        __pipeline_memcpy_async(As + m * FR_LDA + c, A + (size_t)m * K + kc + c, 16);
      }
    } else {
      for (int i = tid; i < M * kn; i += FR_THREADS) {
        const int m = i / kn, c = i % kn;
        As[m * FR_LDA + c] = A[(size_t)m * K + kc + c];
      }
    }
    __pipeline_commit();  // a, then W: two groups
    if (vec_w) {
      constexpr int CPR = BN / WV;  // 16-byte chunks per row of the tile
      for (int i = tid; i < kn * CPR; i += FR_THREADS) {
        const int r = i / CPR, c = WV * (i % CPR);
        WT* dst = Ws + r * BN + c;
        if (c < ncols)  // N * sizeof(W) % 16 == 0: no chunk straddles N
          __pipeline_memcpy_async(dst, W + (size_t)(kc + r) * N + n0 + c, 16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int i = tid; i < kn * BN; i += FR_THREADS) {
        const int r = i / BN, c = i % BN;
        Ws[r * BN + c] = c < ncols ? W[(size_t)(kc + r) * N + n0 + c] : WT(0.f);
      }
    }
    __pipeline_commit();
  };

  if (k0 < k1) stage(k0, min(FR_KCH, k1 - k0));
  if (ln) {  // the slice is one chunk (the wrapper holds K <= 8 FR_KCH)
    for (int i = tid; i < k1 - k0; i += FR_THREADS) {
      s_g[i] = ln_g[k0 + i];
      s_b[i] = ln_b[k0 + i];
    }
    __pipeline_wait_prior(1);  // a has landed; W may still be in flight
    __syncthreads();
    // row m belongs to the 8 lanes tid / 8 == m of warp m / 4, the warp
    // whose products read it
    const int n = k1 - k0, m = tid >> 3, sub = tid & 7;
    float* x = As + m * FR_LDA;
    float s = 0.f;
    if (m < M)
      for (int c = sub; c < n; c += 8) s += x[c];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mq = n > 0 ? s / (float)n : 0.f;
    float q = 0.f;
    if (m < M)
      for (int c = sub; c < n; c += 8) q += (x[c] - mq) * (x[c] - mq);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    if (m < M && sub == 0) {
      s_sum[m] = s;
      s_m2[m] = q;
    }
    cluster.sync();
    // lane sub merges rank sub's slice; a butterfly gives every lane the
    // same sums (each level adds the same two values on both lanes)
    const int nr = min(K, (sub + 1) * slice) - min(K, sub * slice);
    float sr = 0.f, m2r = 0.f;
    if (m < M) {
      sr = cluster.map_shared_rank(s_sum, sub)[m];
      m2r = cluster.map_shared_rank(s_m2, sub)[m];
    }
    float total = sr;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
    const float mean = total / (float)K;
    const float d = nr > 0 ? sr / (float)nr - mean : 0.f;
    float var = m2r + (float)nr * d * d;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rstd = rsqrtf(var / (float)K + eps);
    if (m < M) {
      for (int c = sub; c < n; c += 8) {
        float v = (x[c] - mean) * rstd * s_g[c] + s_b[c];
        x[c] = round_a ? round_bf16(v) : v;
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  const int row0 = 4 * warp;
  const int cg8 = 8 * (lane % CG), kl = lane / CG;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kc = k0; kc < k1; kc += FR_KCH) {
    const int kn = min(FR_KCH, k1 - kc);
    if (kc > k0) {
      __pipeline_wait_prior(0);
      __syncthreads();
    }
    if (round_a && !ln) {  // with ln, rounded as they were normalised
      for (int i = tid; i < M * kn; i += FR_THREADS) {
        const int m = i / kn, c = i % kn;
        As[m * FR_LDA + c] = round_bf16(As[m * FR_LDA + c]);
      }
      __syncthreads();
    }
    if (row0 < M) {
      const float* ap = As + row0 * FR_LDA;
#pragma unroll 4
      for (int kk = kl; kk < kn; kk += KL) {
        float w[8];
        load8(Ws + kk * BN + cg8, w);
        const float a[4] = {ap[kk], ap[FR_LDA + kk], ap[2 * FR_LDA + kk],
                            ap[3 * FR_LDA + kk]};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    if (kc + FR_KCH < k1) {
      __syncthreads();
      stage(kc + FR_KCH, min(FR_KCH, k1 - kc - FR_KCH));
    }
  }

  if (!ln) cluster_wait();  // every block of the cluster has started
  if (row0 < M) {
#pragma unroll
    for (int o = CG; o < 32; o <<= 1)  // the lanes of one column group
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
    float* slot = cluster.map_shared_rank(Rs, warp) + rank * SLOT + cg8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kl == i) {  // KL >= 4: lane k stores row row0 + k of its columns
        *reinterpret_cast<float4*>(slot + i * BN) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(slot + i * BN + 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
  cluster.sync();  // the slots are full; nothing reads another block after it
  for (int i = tid; i < SLOT; i += FR_THREADS) {
    const int m = 4 * rank + i / BN, c = i % BN;
    if (m >= M || c >= ncols) continue;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < FR_CLUSTER; ++r) v += Rs[r * SLOT + i];
    ep.store(v, m, n0 + c, N);
  }
}

template <typename WT, int BN>
int launch_rows(const float* a, const WT* w, const Epilogue& ep,
                const float* ln_g, const float* ln_b, float eps, int M, int N,
                int K, int round_a, cudaStream_t s) {
  auto kern = linear_rows_kernel<WT, BN>;
  constexpr int smem = rows_smem_bytes(BN, sizeof(WT));
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const int vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_w = ((size_t)N * sizeof(WT)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  dim3 grid((N + BN - 1) / BN, FR_CLUSTER);
  kern<<<grid, FR_THREADS, smem, s>>>(a, w, ep, ln_g, ln_b, eps, M, N, K,
                                      round_a, vec_a, vec_w);
  return (int)cudaGetLastError();
}

template <typename WT>
int launch_rows_bn(const float* a, const WT* w, const Epilogue& ep,
                   const float* ln_g, const float* ln_b, float eps, int M,
                   int N, int K, int bn, int round_a, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_rows<WT, 16>(a, w, ep, ln_g, ln_b, eps, M, N, K, round_a, s);
    case 32: return launch_rows<WT, 32>(a, w, ep, ln_g, ln_b, eps, M, N, K, round_a, s);
    case 64: return launch_rows<WT, 64>(a, w, ep, ln_g, ln_b, eps, M, N, K, round_a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- weight gradient: partial[s] = X[rows of s]^T dY[rows of s]
//
// Block (n tile, k tile, split s). X is (M, K), dY (M, N); the partial
// (S, K, N) and, from the blocks of k tile 0, the bias partial (S, N).

// ---- float32 mode's fallback: 3xTF32 on mma.sync m16n8k8
//
// dW[k][n] = sum_m X[m][k] dY[m][n]: MMA rows are dW's k, MMA columns its n,
// the MMA depth runs over data rows m. mma.sync takes its fragments from
// registers in any order, so this tile needs no transposing stage, and its
// cp.async ring takes rows TMA cannot address (K or N off 4, a base off 16
// bytes: element copies). It stays for those operands (wgrad_route); it
// tops out at the TF32 mma.sync issue ceiling (kernel_probes.py --mma).
//   * Block: a 128 x 128 tile of dW (WG_BK x WG_BN), 8 warps of 64 (k) x 32
//     (n), 16 MMA tiles a warp. The split's rows stream through a ring of
//     WG_STAGES slices of 32 rows of X (32 x 128) and dY (32 x 128) with
//     cp.async: 16-byte copies when a row is 16-byte aligned (K, N % 4 == 0
//     and aligned bases), element copies otherwise, zeros past the split or
//     the matrix. One barrier per slice.
//   * Fragments: the MMA rows of a warp map to dW rows so that a lane's 8
//     rows are two float4 runs (4g .. 4g + 3 and 32 + 4g ..), and its 4
//     columns per 8-column MMA tile one float4 (4g .. 4g + 3, MMA tile nt
//     = component nt): per 8 data rows a lane loads 6 float4s. Shared rows
//     are WG_BK + 8 floats (8 mod 32 banks): the 8 lanes of a quarter-warp
//     (t = 0..3 rows, g = 0..1) hit 8 distinct 4-bank groups.
//   * Precision: each operand splits into hi = tf32(x) and lo = x - hi, a
//     product is hi.lo + lo.hi + hi.hi (three MMAs, about 2^-21 relative).
//     The tensor core truncates each sum into its accumulator, so a slice's
//     32 rows go into a zeroed accumulator and are then added, rounded to
//     nearest, into the running one: the truncations stay relative to a
//     slice's sum, not to the whole split's.
//   * db: the blocks of k tile 0 sum the raw dY values their first four
//     warps load (a lane's rows t and t + 4 of every 8, then the 4 lanes of
//     a column by shuffles), in a fixed order.
constexpr int WG_BK = 128, WG_BN = 128;  // dW tile of a block (k x n)
constexpr int WG_SLICE = 32;             // data rows a stage
constexpr int WG_STAGES = 4;             // three in flight while one is read
constexpr int WG_THREADS = 256;
constexpr int WG_LD = WG_BK + 8;         // shared row stride, floats
constexpr int WG_SMEM = 4 * WG_STAGES * 2 * WG_SLICE * WG_LD;  // 139,264 B
static_assert(WG_BK == WG_BN, "X and dY slices share one layout");

__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tf32_kernel(const float* __restrict__ X, const float* __restrict__ dY,
                  float* __restrict__ pw, float* __restrict__ pb, int M, int K,
                  int N, int rows, int vec_x, int vec_d) {
  extern __shared__ float4 wg_smem4[];
  float* smem = reinterpret_cast<float*>(wg_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n0 = blockIdx.x * WG_BN, k0 = blockIdx.y * WG_BK, s = blockIdx.z;
  const int r0 = s * rows, r1 = min(M, r0 + rows);
  const int slices = (r1 - r0 + WG_SLICE - 1) / WG_SLICE;
  const bool bias = pb != nullptr && blockIdx.y == 0 && warp < 4;  // warp-uniform

  // slice q of the split into ring slot q % WG_STAGES (X then dY)
  auto stage = [&](int q) {
    float* xs = smem + (q % WG_STAGES) * 2 * WG_SLICE * WG_LD;
    float* ds = xs + WG_SLICE * WG_LD;
    const int m0 = r0 + q * WG_SLICE;
    auto copy = [&](float* dst, const float* src, int ld, int c0, int lim, int vec) {
      if (vec) {
        for (int e = tid; e < WG_SLICE * (WG_BK / 4); e += WG_THREADS) {
          const int r = e / (WG_BK / 4), c = 4 * (e % (WG_BK / 4));
          const bool ok = m0 + r < r1 && c0 + c < lim;  // lim % 4 == 0: whole chunks
          cp_async16(dst + r * WG_LD + c, ok ? src + (size_t)(m0 + r) * ld + c0 + c : src, ok);
        }
      } else {
        for (int e = tid; e < WG_SLICE * WG_BK; e += WG_THREADS) {
          const int r = e / WG_BK, c = e % WG_BK;
          const bool ok = m0 + r < r1 && c0 + c < lim;
          cp_async4(dst + r * WG_LD + c, ok ? src + (size_t)(m0 + r) * ld + c0 + c : src, ok);
        }
      }
    };
    copy(xs, X, K, k0, K, vec_x);
    copy(ds, dY, N, n0, N, vec_d);
  };

  float acc[4][4][4], tmp[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int q = 0; q < WG_STAGES - 1; ++q) {
    if (q < slices) stage(q);
    cp_async_commit();
  }
  for (int q = 0; q < slices; ++q) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // slice q is in; slot (q - 1) % WG_STAGES is free
    if (q + WG_STAGES - 1 < slices) stage(q + WG_STAGES - 1);
    cp_async_commit();
    const float* xs = smem + (q % WG_STAGES) * 2 * WG_SLICE * WG_LD;
    const float* ds = xs + WG_SLICE * WG_LD;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmp[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WG_SLICE; kk += 8) {
      // rows kk + t (MMA depth t) and kk + t + 4 (depth t + 4)
      const float* xr = xs + (kk + t) * WG_LD + wk + 4 * g;
      const float* dr = ds + (kk + t) * WG_LD + wn + 4 * g;
      float xa[2][8], db[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 p = *reinterpret_cast<const float4*>(xr + u * 4 * WG_LD);
        const float4 q4 = *reinterpret_cast<const float4*>(xr + u * 4 * WG_LD + 32);
        const float4 d = *reinterpret_cast<const float4*>(dr + u * 4 * WG_LD);
        xa[u][0] = p.x; xa[u][1] = p.y; xa[u][2] = p.z; xa[u][3] = p.w;
        xa[u][4] = q4.x; xa[u][5] = q4.y; xa[u][6] = q4.z; xa[u][7] = q4.w;
        db[u][0] = d.x; db[u][1] = d.y; db[u][2] = d.z; db[u][3] = d.w;
      }
      if (bias) {
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += db[0][j] + db[1][j];
      }
      // B of MMA tile nt: b0 = (depth t, column g) = db[0][nt], b1 = db[1][nt]
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) split_tf32(db[u][j], bh[j][u], bl[j][u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A of MMA tile mt = i: rows g (h 0) and g + 8 (h 1) are dW rows
        // wk + 32 (i / 2) + 4g + 2 (i % 2) + h: components 4 (i / 2) + 2 (i % 2) + h
        const int c = 4 * (i >> 1) + 2 * (i & 1);
        uint32_t ah[4], al[4];
        split_tf32(xa[0][c], ah[0], al[0]);
        split_tf32(xa[0][c + 1], ah[1], al[1]);
        split_tf32(xa[1][c], ah[2], al[2]);
        split_tf32(xa[1][c + 1], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(tmp[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(tmp[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(tmp[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += tmp[i][j][e];
  }
  cp_async_wait<0>();

  // accumulator (mt i, nt j): element e is dW row wk + 32 (i / 2) + 4g +
  // 2 (i % 2) + e / 2, column wn + 8t + 4 (e % 2) + j
  float* out = pw + (size_t)s * K * N;
  const bool vec_out = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wk + 32 * (i >> 1) + 4 * g + 2 * (i & 1) + h;
      if (k >= K) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = n0 + wn + 8 * t + 4 * u;
        float* dst = out + (size_t)k * N + n;
        const float v[4] = {acc[i][0][2 * h + u], acc[i][1][2 * h + u],
                            acc[i][2][2 * h + u], acc[i][3][2 * h + u]};
        if (vec_out && n + 3 < N) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) dst[j] = v[j];
        }
      }
    }
  if (bias) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bsum[j] = quad_sum(bsum[j]);
    if (t == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 4 * g + j;
        if (n < N) pb[(size_t)s * N + n] = bsum[j];
      }
    }
  }
}

// ---- float32 mode on TF32 wgmma (sm_90a): 3xTF32, dY transposed in the tile
//
// partial[s] = X[rows of s]^T dY[rows of s], X (M, K) and dY (M, N) float32
// on 16-byte boundaries with K % 4 == N % 4 == 0 (wgrad_route: rows TMA can
// address). Bound: compute, three TF32 products of 2 M K N operations at 495
// TFLOP/s. wgrad_tf32_kernel's mma.sync ran at 30-33% of that rate at the
// train trunks' widths; this tile at 62-66% (kernel_probes.py --wgrad, an
// H100 at 700 W), where shared memory bounds it (below).
//   * The transpose: dW's rows k are the MMA's rows and the data rows m its
//     depth, so both X^T (k by m) and dY (m by n) lie M-major. TF32 wgmma
//     takes A from registers in any order, but reads B from shared memory
//     only K-major (no transpose bit for 32-bit types), and a transposed
//     copy of dY made before the call would take 1.7-2.2 GB at the train
//     trunks' widest products. So dY is transposed inside the tile: from
//     each float32 slot, warpgroup 2 writes dY's TF32 hi and lo halves as
//     128 rows of n by 32 data rows with the 128-byte swizzle (wgmma's
//     K-major B) into one of two buffers, while the tensor cores run the
//     other.
//   * Roles: warpgroups 0 and 1 consume (64 rows of dW each; setmaxnreg
//     232); warpgroup 2 (40) converts, thread n of it column n of dY, and
//     warp 8's lane 0 also keeps the TMA loads in flight. A consumer warp
//     stalls at each wgmma until the tensor cores take it (1,600 of a
//     slot's ~2,400 clocks, clock64 in the loop), so conversion by the
//     consumers themselves ran at 61-62% between their products and at
//     57-59% after them. Barriers, no block-wide sync: full and empty a
//     ring slot (loaded; its X and dY read), conv and done a buffer
//     (converted; its products done).
//   * Grid: one block per (row split, 128 x 128 tile of dW), the split
//     slowest (kernels.wgrad_rows, as for the other tiles); within a split
//     the tiles go in bands of WT_BAND n tiles, k fastest in a band, so the
//     blocks that run at once read a near-square set of X's and dY's
//     columns from the L2 (with n fastest a wave of ViT-g's w12, 12 x 64
//     tiles, read all 8,192 columns of dY; it measured the same).
//   * A ring slot (Wt) holds 32 data rows: X's 128 columns as four 32 x
//     32-float boxes with the 128-byte swizzle, dY's 128 as one box of
//     512-byte rows; zeros past M, K and N, and rows past the split are
//     zeroed as they are read.
//   * A = X^T from registers: a consumer thread's fragment rows g and g + 8
//     are dW rows 2g and 2g + 1 of its warp's 16, and MMA depths t and t + 4
//     of k8 step kk are data rows 8 kk + 2t and 8 kk + 2t + 1, so a thread
//     reads its four values a step with two 8-byte loads, a half-warp's 16
//     loads on 32 distinct banks (the chunk (g / 2) ^ (m % 8) differs across
//     its lanes), and splits them in registers. The next slot's X is read
//     while a slot's products run.
//   * B = dY: a converter thread reads its column down the slot (a warp
//     reads 32 adjacent floats), splits each value, writes 16-byte runs of
//     four depths (the data rows the A layout puts at adjacent depths; a
//     quarter-warp's 8 rows of n hit 8 distinct chunks) and adds the
//     unsplit values into db's column sum, a slot's sum at a time.
//   * Shared memory is the bound: a slot moves ~192 KB through it (wgmma's
//     reads of B 96 KB, TMA 32, the conversion 48, X's fragments 16) against
//     ~1,536 clocks of tensor work at full rate. Without the converters'
//     stores the tile ran 70-76%, without X's loads 69-71%; the forward
//     tile moves 160 KB a slot and runs at 60-74%.
//   * Products: each k8 step runs lo.hi, hi.lo, hi.hi (wgmma m64n128k8) into
//     one accumulator; lo.lo (~2^-22) is dropped.
//   * Precision: the tensor core truncates its sums, so each WT_GROUP slots
//     (64 data rows) go into an accumulator zeroed by scale-d = 0 that is
//     then added, rounded to nearest, into the running one (128 rows ran a
//     point faster and doubled the emulated error: tests/test_torch_tf32.py).
//     With 64, the benchmark's correct read grad <= 7.5e-5 at ViT-g (limit
//     5e-4) and <= 2.8e-5 at ViT-S (2e-4), change <= 9.1e-4 (1.5e-3, 5e-3).
//     A fixed order, no atomics: the result repeats bitwise.
//   * Epilogue: the accumulators go straight to the partial as float2
//     stores, db from the converter threads.
constexpr int WT_SLICE = 32;  // data rows of a ring slot: four k8 steps
constexpr int WT_GROUP = 2;   // slots summed into one fresh accumulator: 64 rows
constexpr int WT_BAND = 8;    // n tiles of a band of the block order

// the tile's shared memory (pd_linear_wgrad_tf32_smem_bytes; a test works it
// by hand): 1,024 bytes of alignment slack, STAGES ring slots (X's four
// swizzled boxes, dY's 32 x 128 floats), two buffers of dY's TF32 hi and lo
// halves (128 rows of 128 bytes each), then the full and empty barriers of
// the slots and the conv and done barriers of the buffers
struct Wt {
  static constexpr int TILE = 128;                      // dW tile: 128 (k) x 128 (n)
  static constexpr int X_BOX = WT_SLICE * 128;          // 32 rows of 32 floats
  static constexpr int X_BYTES = (TILE / 32) * X_BOX;   // X's 128 columns
  static constexpr int D_BYTES = WT_SLICE * TILE * 4;   // dY's 128 columns
  static constexpr int SLOT = X_BYTES + D_BYTES;
  static constexpr int STAGES = 5;
  static constexpr int HALF = TILE * 128;  // one TF32 half of dY^T: 128 rows of n
  static constexpr int BUF = 2 * HALF;     // hi, then lo
  static constexpr int BUFS = 2;           // slot q's halves in buffer q % 2
  static constexpr int SMEM = 1024 + STAGES * SLOT + BUFS * BUF + 2 * (STAGES + BUFS) * 8;
};

__global__ void __launch_bounds__(BW_THREADS, 1)
wgrad_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_d, float* __restrict__ pw,
                        float* __restrict__ pb, int M, int K, int N, int rows) {
  using S = Wt;
  extern __shared__ __align__(1024) unsigned char wt_smem[];
  unsigned char* smem = wt_smem + ((1024 - (smem_u32(wt_smem) & 1023)) & 1023);
  unsigned char* bufs = smem + S::STAGES * S::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(bufs + S::BUFS * S::BUF);
  uint64_t* empty = full + S::STAGES;
  uint64_t* conv = empty + S::STAGES;  // buffer b holds its slot's halves
  uint64_t* done = conv + S::BUFS;     // buffer b's products are done
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_k = (K + S::TILE - 1) / S::TILE, tiles_n = (N + S::TILE - 1) / S::TILE;
  const int tiles = tiles_k * tiles_n;
  const int tile = (int)(blockIdx.x % tiles), split = (int)(blockIdx.x / tiles);
  const int band = tile / (WT_BAND * tiles_k), in = tile % (WT_BAND * tiles_k);
  const int width = min(WT_BAND, tiles_n - band * WT_BAND);  // n tiles of this band
  const int k0 = (in / width) * S::TILE, n0 = (band * WT_BAND + in % width) * S::TILE;
  const int r0 = split * rows, r1 = min(M, r0 + rows);
  const int slices = (r1 - r0 + WT_SLICE - 1) / WT_SLICE;

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);  // the 8 consumer warps (X) and 4 converter warps (dY)
    }
    for (int b = 0; b < S::BUFS; ++b) {
      mbar_init(&conv[b], 4);  // the converter warps
      mbar_init(&done[b], 8);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // warpgroup 2: converts dY; warp 8's lane 0 also loads with TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int boxes = min(S::TILE / 32, (K - k0 + 31) / 32);  // X's boxes inside K
    auto load = [&](int p) {  // slot p into its stage
      const int stage = p % S::STAGES;
      unsigned char* sx = smem + stage * S::SLOT;
      const int m0 = r0 + p * WT_SLICE;
      mbar_expect_tx(&full[stage], boxes * S::X_BOX + S::D_BYTES);
      for (int b = 0; b < boxes; ++b)
        tma_load_2d(sx + b * S::X_BOX, &tm_x, k0 + 32 * b, m0, &full[stage]);
      tma_load_2d(sx + S::X_BYTES, &tm_d, n0, m0, &full[stage]);
    };
    if (warp == 8 && lane == 0)
      for (int p = 0; p < min(slices, S::STAGES); ++p) load(p);
    const int cn = tid - 256;  // this thread's column of dY
    float bsum = 0.f;
    for (int q = 0; q < slices; ++q) {
      const int stage = q % S::STAGES, b = q % S::BUFS;
      mbar_wait(&full[stage], (q / S::STAGES) & 1);
      if (q >= S::BUFS) mbar_wait(&done[b], ((q / S::BUFS) - 1) & 1);
      const float* sd = reinterpret_cast<const float*>(smem + stage * S::SLOT + S::X_BYTES);
      unsigned char* hi = bufs + b * S::BUF;
      const int live = r1 - (r0 + q * WT_SLICE);  // rows of the slot inside the split
      // 16-byte chunk c of row cn holds depths 4c .. 4c + 3 of the slot, data
      // rows 8 (c / 2) + 2i + c % 2
      float slot_sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 8 * (c >> 1) + 2 * i + (c & 1);
          const float v = r < live ? sd[r * S::TILE + cn] : 0.f;
          slot_sum += v;
          split_tf32(v, h[i], l[i]);
        }
        const int o = bw_swz(cn, 16 * c);
        *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(hi + S::HALF + o) = make_uint4(l[0], l[1], l[2], l[3]);
      }
      bsum += slot_sum;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // generic stores, async reads
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&conv[b]);
        mbar_arrive(&empty[stage]);
      }
      // refill the stage once the consumers have read slot q's X too
      if (warp == 8 && q + S::STAGES < slices) {
        mbar_wait(&empty[stage], (q / S::STAGES) & 1);
        if (lane == 0) load(q + S::STAGES);
        __syncwarp();
      }
    }
    if (pb != nullptr && k0 == 0 && n0 + cn < N) pb[(size_t)split * N + n0 + cn] = bsum;
    return;
  }

  // the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  // A: fragment rows g and g + 8 are dW rows xr and xr + 1, in X's box
  // xr / 32 at byte xc of its rows
  const int xr = 64 * wg + 16 * (warp & 3) + 2 * g;
  const int xb = (xr >> 5) * S::X_BOX, xc = 4 * (xr & 31);
  float acc[S::TILE / 2], part[S::TILE / 2];
#pragma unroll
  for (int j = 0; j < S::TILE / 2; ++j) acc[j] = 0.f;
  // X of slot q at depths t and t + 4 of k8 step kk: data rows 8 kk + 2t + e;
  // the slot's stage is released once read
  float2 xv[4][2];
  auto load_x = [&](int q) {
    const int stage = q % S::STAGES;
    mbar_wait(&full[stage], (q / S::STAGES) & 1);
    const unsigned char* sx = smem + stage * S::SLOT;
    const int live = r1 - (r0 + q * WT_SLICE);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * kk + 2 * t + e;
        xv[kk][e] = m < live ? *reinterpret_cast<const float2*>(sx + xb + bw_swz(m, xc))
                             : make_float2(0.f, 0.f);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };
  // a0 (row g, depth t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
  uint32_t ah[4][4], al[4][4];
  auto split_x = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_tf32(xv[kk][0].x, ah[kk][0], al[kk][0]);
      split_tf32(xv[kk][0].y, ah[kk][1], al[kk][1]);
      split_tf32(xv[kk][1].x, ah[kk][2], al[kk][2]);
      split_tf32(xv[kk][1].y, ah[kk][3], al[kk][3]);
    }
  };
  load_x(0);
  split_x();
  for (int q = 0; q < slices; ++q) {
    const int b = q % S::BUFS;
    mbar_wait(&conv[b], (q / S::BUFS) & 1);
    wgmma_fence();
    const uint32_t bh = smem_u32(bufs + b * S::BUF), bl = bh + S::HALF;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // k8 step kk: 32 bytes into each K-major row of B
      const uint64_t dh = bw_desc(bh + 32 * kk, 16, 1024);
      const uint64_t dl = bw_desc(bl + 32 * kk, 16, 1024);
      wgmma_tf32(part, al[kk], dh, (q % WT_GROUP) | kk);  // 0 at a group's start
      wgmma_tf32(part, ah[kk], dl, 1);
      wgmma_tf32(part, ah[kk], dh, 1);
    }
    wgmma_commit();
    const bool next = q + 1 < slices;
    if (next) load_x(q + 1);
    wgmma_wait_all();  // slot q's products are done: A's registers and the buffer are free
    reg_fence(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[b]);
    if ((q + 1) % WT_GROUP == 0 || !next) {  // a group of slots ends with slot q
#pragma unroll
      for (int j = 0; j < S::TILE / 2; ++j) acc[j] += part[j];
    }
    if (next) split_x();
  }

  // accumulator 4j + 2h + c is dW row k0 + xr + h, column n0 + 8j + 2t + c
  float* out = pw + (size_t)split * K * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = k0 + xr + h;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < S::TILE / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;  // N % 4 == 0: n < N holds n + 1 too
      if (n < N)
        *reinterpret_cast<float2*>(out + (size_t)k * N + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

int launch_wgrad_tf32_wgmma(const float* x, const float* dy, float* pw, float* pb, int M, int K,
                            int N, int rows, cudaStream_t s) {
  using S = Wt;
  static_assert(S::SMEM <= BW_MAX_SMEM, "the ring does not fit");
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  static const bool regs_ok = wgmma_regs_ok((const void*)wgrad_tf32_wgmma_kernel);
  if (!regs_ok) return (int)cudaErrorInvalidConfiguration;
  const long long tiles =
      (long long)((K + S::TILE - 1) / S::TILE) * ((N + S::TILE - 1) / S::TILE);
  const long long blocks = tiles * ((M + rows - 1) / rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x{}, tm_d{};
  if (!tmap_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, WT_SLICE, 32) ||
      !tmap_2d(&tm_d, dy, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, N, WT_SLICE, S::TILE,
               CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  wgrad_tf32_wgmma_kernel<<<(unsigned)blocks, BW_THREADS, S::SMEM, s>>>(tm_x, tm_d, pw, pb, M, K,
                                                                       N, rows);
  return (int)cudaGetLastError();
}

// The route of pd_linear_wgrad (pd_linear_wgrad_route returns it; the tests
// hold a table of it): bf16 wgmma in bf16 mode (wgrad.cu, which also loads rows off 16
// bytes); TF32 wgmma for float32 operands whose rows TMA can address
// (16-byte aligned X and dY, K and N multiples of 4); mma.sync for the rest.
int wgrad_route(int K, int N, int round_in, int x_aligned, int dy_aligned) {
  if (round_in) return ROUTE_BF16_WGMMA;
  if (x_aligned && dy_aligned && K % 4 == 0 && N % 4 == 0) return ROUTE_TF32_WGMMA;
  return ROUTE_TF32_MMA;
}

}  // namespace

// bf16 mode's weight gradient (wgrad.cu)
int wgrad_bf16_tile();
int launch_wgrad_bf16(const float* x, const float* dy, float* pw, float* pb, int M, int K,
                      int N, int rows, cudaStream_t s);

// y = epi(a @ W) above the few-rows route, on the route linear_route picks;
// scratch holds 2 N K floats (W's TF32 halves) where that route is TF32
// wgmma, and may be null otherwise.
PD_API int pd_linear(const void* a, const void* w, int w_bf16, int trans_w,
                     const void* bias, const void* gain, const void* res,
                     void* y, void* pre,
                     int M, int N, int K, int round_a, int act,
                     unsigned int drop_key, int drop_thr, float drop_scale,
                     int round_out, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* A = (const float*)a;
  Epilogue ep{(const float*)bias, (const float*)gain, (const float*)res,
              (float*)y, (float*)pre, act, round_out,
              DropArgs{drop_key, drop_thr, drop_scale}};
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  const int route = linear_route(K, N, w_bf16, round_a, aligned(a, 16), aligned(w, 16));
  // the gate: a forward float32 product of column pairs, nothing after the
  // activation, on the TF32 wgmma tile's instance of its own
  if (act == ACT_SWIGLU) {
    if (route != ROUTE_TF32_WGMMA || trans_w || gain || res || drop_thr > 0 ||
        !aligned(y, 16) || !aligned(pre, 16))
      return (int)cudaErrorInvalidValue;
    return launch_tf32_wgmma<true>(A, (const float*)w, 0, (uint32_t*)scratch, ep, M, N, K, s);
  }
  if (route == ROUTE_BF16_WGMMA)
    return launch_bf16_t(A, (const __nv_bfloat16*)w, trans_w, ep, M, N, K, s);
  if (route == ROUTE_TF32_WGMMA)
    return launch_tf32_wgmma<false>(A, (const float*)w, trans_w, (uint32_t*)scratch, ep, M, N, K,
                                    s);
  if (w_bf16)
    return launch_tf32_t<__nv_bfloat16, false>(A, (const __nv_bfloat16*)w, trans_w, ep, M,
                                               N, K, s);
  if (round_a)
    return launch_tf32_t<float, true>(A, (const float*)w, trans_w, ep, M, N, K, s);
  return launch_tf32_t<float, false>(A, (const float*)w, trans_w, ep, M, N, K, s);
}

// The few-rows route: a (M, K) float32 with M <= 32, W (K, N) float32 or
// bfloat16, the Epilogue's operands as pd_linear's; ln_g and ln_b (K,) (or
// null) fold LayerNorm(a; eps) into the staging (K <= 1,024); bn (16, 32 or 64) the
// columns of a block, chosen by the wrapper (ops/kernels.linear_rows_tile).
PD_API int pd_linear_rows(const void* a, const void* w, int w_bf16,
                          const void* bias, const void* gain, const void* res,
                          void* y, void* pre, const void* ln_g,
                          const void* ln_b, float eps, int M, int N, int K,
                          int bn, int round_a, int act, unsigned int drop_key,
                          int drop_thr, float drop_scale, int round_out,
                          void* stream) {
  if (M < 1 || M > FR_ROWS || N < 1 || K < 1 || act == ACT_SWIGLU)
    return (int)cudaErrorInvalidValue;
  if (ln_g && K > FR_CLUSTER * FR_KCH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Epilogue ep{(const float*)bias, (const float*)gain, (const float*)res,
              (float*)y, (float*)pre, act, round_out,
              DropArgs{drop_key, drop_thr, drop_scale}};
  const float* A = (const float*)a;
  const float* g = (const float*)ln_g;
  const float* b = (const float*)ln_b;
  if (w_bf16)
    return launch_rows_bn(A, (const __nv_bfloat16*)w, ep, g, b, eps, M, N, K, bn,
                          round_a, s);
  return launch_rows_bn(A, (const float*)w, ep, g, b, eps, M, N, K, bn, round_a, s);
}

// Shared memory of the bf16 wgmma tile (ops/kernels.py linear_bf16_smem_bytes
// holds the same).
PD_API int pd_linear_bf16_smem_bytes() { return Bw::SMEM; }

// Shared memory of the TF32 wgmma tile (ops/kernels.py
// linear_tf32_wgmma_smem_bytes holds the same).
PD_API int pd_linear_tf32_wgmma_smem_bytes() { return Tw::SMEM; }

// pd_linear's route for these operands (0 TF32 mma.sync, 1 TF32 wgmma, 2
// bf16 wgmma; ops/kernels.py linear_route mirrors it, and linear asks it
// whether the call needs W's TF32 halves).
PD_API int pd_linear_route(int K, int N, int w_bf16, int round_a, int a_aligned, int w_aligned) {
  return linear_route(K, N, w_bf16, round_a, a_aligned, w_aligned);
}

// The dW tile of a block (ops/kernels.py WGRAD_TILE holds the same): 128 x
// 128 on every route.
PD_API int pd_linear_wgrad_tile(int round_in) {
  static_assert(Wt::TILE == WG_BK && WG_BK == WG_BN, "the float32 routes share one tile");
  return round_in ? wgrad_bf16_tile() : WG_BK;
}

// Shared memory of the TF32 wgmma weight-gradient tile.
PD_API int pd_linear_wgrad_tf32_smem_bytes() { return Wt::SMEM; }

// pd_linear_wgrad's route for these operands (0 TF32 mma.sync, 1 TF32 wgmma,
// 2 bf16 wgmma; ops/kernels.py linear_wgrad asks it to count its launches by
// route).
PD_API int pd_linear_wgrad_route(int K, int N, int round_in, int x_aligned, int dy_aligned) {
  return wgrad_route(K, N, round_in, x_aligned, dy_aligned);
}

// X (M, K), dY (M, N) -> partials pw (S, K, N) and pb (S, N) (pb may be
// null), S = ceil(M / rows), on wgrad_route's route. round_in: both
// operands rounded to bf16 (the bf16 mode, wgmma in wgrad.cu); else float32
// as 3xTF32 MMAs, on TF32 wgmma where TMA can address X and dY.
PD_API int pd_linear_wgrad(const void* x, const void* dy, void* pw, void* pb,
                           int M, int K, int N, int rows, int round_in,
                           void* stream) {
  if (rows < 1 || M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int route = wgrad_route(K, N, round_in, aligned(x, 16), aligned(dy, 16));
  if (route == ROUTE_BF16_WGMMA)
    return launch_wgrad_bf16((const float*)x, (const float*)dy, (float*)pw, (float*)pb, M, K,
                             N, rows, s);
  if (route == ROUTE_TF32_WGMMA)
    return launch_wgrad_tf32_wgmma((const float*)x, (const float*)dy, (float*)pw, (float*)pb, M,
                                   K, N, rows, s);
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int S = (M + rows - 1) / rows;
  const int vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_d = N % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  dim3 grid((N + WG_BN - 1) / WG_BN, (K + WG_BK - 1) / WG_BK, S);
  wgrad_tf32_kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(
      (const float*)x, (const float*)dy, (float*)pw, (float*)pb, M, K, N, rows,
      vec_x, vec_d);
  return (int)cudaGetLastError();
}
