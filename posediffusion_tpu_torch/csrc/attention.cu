// Softmax attention over a packed QKV buffer on the tensor cores
// (mma.sync), flash-attention style: one warp owns 16 query rows, the key
// and value tiles stream through shared memory.
//
// Replaces the TPU kernels
//   posediffusion_tpu/ops/attention.py:66     _pallas_attention (pallas_call
//                                             :73; a (B, N) key mask, which
//                                             SuperGlue's matcher runs)
//   posediffusion_tpu/ops/attention.py:125    _pallas_attention_bias
//                                             (pallas_call :128; an (N, N)
//                                             bias shared by every sequence)
// and the per-head attention inside
//   posediffusion_tpu/ops/vit_kernel.py        _vit_block_kernel (6 heads of
//                                              Dh 64, the (N, N) bias that
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
// columns h*Dh of each; out is (B, N, D) float32. Scores are
// s = (q.k) * scale + bias in float32 (scale after the product, as the TPU
// kernels do), the softmax is float32, and a masked entry carries the bias
// -1e30 (not -inf), so a row whose keys are all masked gets a uniform p.
//
// Two precision modes, both on the tensor cores:
//   * round_in (the bf16 mode): q, k, v are rounded to bfloat16 and both
//     products are m16n8k16 bf16 MMAs with float32 accumulation, exactly the
//     TPU kernels' bf16 dots. The NORMALISED p = e / sum is rounded to bf16
//     before p.V (their probs.astype(v.dtype)); to know the sum first the
//     keys are walked twice: pass 1 keeps each row's running max and sum,
//     pass 2 recomputes the scores (cheap on the tensor cores) and forms p.
//     With dropout, p is multiplied by its mask (common.cuh, element
//     ((b H + h) N + i) N + j) before the rounding.
//   * float32: 3xTF32 m16n8k8 MMAs. Each operand splits into hi = tf32(x)
//     and lo = x - hi (which the tensor core truncates to TF32), and a
//     product sums hi.hi + hi.lo + lo.hi: about 2^-21 relative, where plain
//     TF32 keeps 2^-11. The tensor core truncates each sum it adds into an
//     accumulator, so the small terms of q.k get their own accumulator, and
//     each tile's p.V its own, merged into the output by one rounded FMA
//     (o alpha + tile): over thousands of keys the truncations would drift
//     in a single accumulator. (Heads of 128, whose registers leave no room
//     for it, run only the short denoiser sequences and accumulate p.V in
//     the output directly.) There is no rounding site, so one pass with an
//     online softmax (running max, rescaled sum and output) suffices.
//     Dropout keeps or zeroes e (0/1) and the keep scale multiplies the
//     output with the 1/sum, so a kept p * v is exact where p and v are.
//
// Layout: a block holds 16 x W query rows (W = 1..4 warps, fewer for short
// sequences such as the denoiser's 20 frames) of one (sequence, head). The
// score tile of a warp (16 rows x 64 keys in bf16 mode, x 32 in float32
// mode, whose split fragments take more registers) lives in registers in the
// MMA accumulator layout and becomes the A operand of p.V in registers: in
// bf16 the accumulator pairs are the A fragment as they are; in tf32 the keys
// of each 8-key slice are taken in the order 0,2,4,6 | 1,3,5,7 (V's rows
// likewise), which maps the accumulator onto the A fragment with no shuffle.
// The head dimension is permuted the same way for q.k (bf16: four
// consecutive columns per lane, one 16-byte load; tf32: two, one 8-byte
// load). In bf16 mode q stays in registers as A fragments, loaded once from
// global memory; in float32 mode it is staged in shared memory. K and V
// tiles are copied with cp.async (16 bytes, zero fill past N) into a
// two-stage ring, the next tile in flight while the current one is
// multiplied. Rows are padded (K, and Q, to 16 / 8 words mod 32, V to 4) so
// that the fragment loads are free of bank conflicts, and the head is padded
// with zeros to 32, 64 or 128 columns, so every loop over it unrolls. Each
// tile's bias is loaded before its products (a key bias once per column).
// In float32 mode a tile whose keys are all masked (bias at or below -1e8)
// for a warp's rows, once those rows have seen a live key, adds exactly 0
// and is skipped: a SuperGlue set's padding keypoints are the tail of its
// keys, and the ViT's packing bias masks 40% of its (query, key) cells.
// Shared memory depends on N only through the tile sizes: 141,312 B at most
// (Dh 128, bf16).
//
// Bound, case by case on an H100 (PERF.md): the SuperGlue case (64 x 1,024
// keys, 4 heads of 64, float32) by operations, the 3xTF32 products at
// 3 x 4 D per live (query, key) cell over the 495 TFLOP/s TF32 rate; the
// ViT's bf16 case (20 x 264, 6 heads) by bytes in principle (qkv once), in
// practice by the latency of its few small tiles; the denoiser's 1 x 20
// rows (four blocks) by the host's launch.
//
// Deterministic: no atomics; every sum has a fixed order.
#include <stdint.h>

#include "common.cuh"

namespace {
constexpr int kMaxWarps = 4;  // 16 query rows each
constexpr int kMaxDh = 128;
// A key whose bias is at or below kDeadBias is masked (NEG -1e30 and
// SuperGlue's -1e9 both are); a running max above kLiveMax came from a live
// key (|q.k| scale stays far below 9e7). Then a masked key's e underflows
// to exactly 0.
constexpr float kDeadBias = -1e8f;
constexpr float kLiveMax = -1e7f;

// Keys per staged tile: 64 in bf16 mode; 32 in float32 mode, whose 3xTF32
// fragments take more registers, so that more blocks fit on an SM.
__host__ __device__ constexpr int key_tile(bool bf16) { return bf16 ? 64 : 32; }

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Head columns the registers and shared rows hold: 32, 64 or 128 (the
// kernel's DT = depth / 8); columns past Dh are zeros.
__host__ __device__ constexpr int head_depth(int Dh) {
  return Dh <= 32 ? 32 : Dh <= 64 ? 64 : 128;
}
// Row strides in floats. K (and Q in float32 mode) fragments are 16-byte
// (bf16) or 8-byte (tf32) loads from rows g = lane / 4: a stride of 16 (8)
// mod 32 words puts each quarter-warp (half-warp) on 32 distinct banks. V is
// read one float at a time from rows 2t (+1, +8, +9) and column g: 4 mod 32.
__host__ __device__ constexpr int qk_stride(int depth, bool bf16) {
  return depth + (bf16 ? 16 : 8);
}
__host__ __device__ constexpr int v_stride(int depth) { return depth + 4; }

struct Tiles {
  int warps;   // 16 query rows each
  int kt;      // keys per tile, a multiple of 16
  int stages;  // 2: a ring of two K/V tiles; 1: all keys fit in one tile
};

Tiles tiles_for(int N, bool bf16) {
  Tiles t;
  t.warps = N < 16 * kMaxWarps ? (N + 15) / 16 : kMaxWarps;
  t.kt = N < key_tile(bf16) ? round_up(N, 16) : key_tile(bf16);
  t.stages = N > t.kt ? 2 : 1;
  return t;
}

// Q is staged in shared memory in float32 mode only (bf16 mode keeps its
// fragments in registers).
size_t smem_bytes(int N, int Dh, bool bf16) {
  const Tiles t = tiles_for(N, bf16);
  const int dp = head_depth(Dh), sq = qk_stride(dp, bf16), sv = v_stride(dp);
  return sizeof(float) * ((bf16 ? 0 : (size_t)16 * t.warps * sq) +
                          (size_t)t.stages * t.kt * (sq + sv));
}

__device__ __forceinline__ float attn_bias_at(const float* bias, int kind, int b,
                                              int i, int j, int N) {
  if (kind == 1) return bias[(size_t)i * N + j];
  if (kind == 2) return bias[(size_t)b * N + j];
  return 0.f;
}

// ---- one warp's 16 x 8 NT score tile s = q.k^T (unscaled) in accumulator
// layout: sc[n][e] is row g + 8 (e / 2), key n * 8 + 2 t + e % 2.
// bf16: q from the A fragments qf (k-slice of 16 head columns d0..: lane
// (g, t) holds columns d0 + 4t .. d0 + 4t + 3 as MMA columns 2t, 2t+1, 2t+8,
// 2t+9). tf32: q from the warp's staged rows Qw (k-slice of 8 columns: lane
// (g, t) holds d0 + 2t, d0 + 2t + 1 as MMA columns t and t + 4).
template <bool BF16, int DP, int NT>
__device__ __forceinline__ void qk_tile(float (&sc)[NT][4], const uint32_t (&qf)[DP / 16][4],
                                        const float* Qw, const float* Kt, int sq, int kv,
                                        int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
  if (BF16) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 >= kv) continue;
        const float4 k =
            *reinterpret_cast<const float4*>(Kt + (n * 8 + g) * sq + ks * 16 + 4 * t);
        mma_bf16(sc[n], qf[ks], pack_bf16(k.x, k.y), pack_bf16(k.z, k.w));
      }
    }
  } else {
    // the small terms hi.lo + lo.hi in their own accumulator, added once
    float lo[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[n][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 8) {
      const float2 x = *reinterpret_cast<const float2*>(Qw + g * sq + d0 + 2 * t);
      const float2 y = *reinterpret_cast<const float2*>(Qw + (g + 8) * sq + d0 + 2 * t);
      uint32_t ah[4], al[4];
      split_tf32(x.x, ah[0], al[0]);
      split_tf32(y.x, ah[1], al[1]);
      split_tf32(x.y, ah[2], al[2]);
      split_tf32(y.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 >= kv) continue;
        const float2 k =
            *reinterpret_cast<const float2*>(Kt + (n * 8 + g) * sq + d0 + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(k.x, bh0, bl0);
        split_tf32(k.y, bh1, bl1);
        mma_tf32(lo[n], al, bh0, bh1);
        mma_tf32(lo[n], ah, bl0, bl1);
        mma_tf32(sc[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] += lo[n][e];
  }
}

// ---- o += p V for one tile: p in the accumulator layout of qk_tile, V rows
// from the staged tile (row stride sv).
template <bool BF16, int DT, int NT>
__device__ __forceinline__ void pv_tile(float (&o)[DT][4], const float (&p)[NT][4],
                                        const float* Vt, int sv, int Dh, int kv,
                                        int g, int t) {
  if (BF16) {
    // k-slice of 16 keys = score tiles 2ks and 2ks + 1, as they are
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {
      if (ks * 16 >= kv) continue;
      const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                             pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                             pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                             pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
      const float* v = Vt + (ks * 16 + 2 * t) * sv + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        if (d * 8 >= Dh) continue;
        mma_bf16(o[d], a, pack_bf16(v[d * 8], v[sv + d * 8]),
                 pack_bf16(v[8 * sv + d * 8], v[9 * sv + d * 8]));
      }
    }
  } else {
    // k-slice of 8 keys = score tile n, keys in the order 2t | 2t + 1
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n * 8 >= kv) continue;
      uint32_t ah[4], al[4];
      split_tf32(p[n][0], ah[0], al[0]);
      split_tf32(p[n][2], ah[1], al[1]);
      split_tf32(p[n][1], ah[2], al[2]);
      split_tf32(p[n][3], ah[3], al[3]);
      const float* v = Vt + (n * 8 + 2 * t) * sv + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        if (d * 8 >= Dh) continue;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v[d * 8], bh0, bl0);
        split_tf32(v[sv + d * 8], bh1, bl1);
        mma_tf32(o[d], al, bh0, bh1);
        mma_tf32(o[d], ah, bl0, bl1);
        mma_tf32(o[d], ah, bh0, bh1);
      }
    }
  }
}

// the end of pass 1: the rows' lane-partial sums -> 1 / sum, for pass 2
__device__ __forceinline__ void finish_sum(float (&l)[2]) {
  l[0] = 1.f / quad_sum(l[0]);
  l[1] = 1.f / quad_sum(l[1]);
}
}  // namespace

// grid (B * H, row blocks), block 32 W threads; DT: 8-column tiles of the
// head the registers hold (Dh <= 8 DT).
template <bool BF16, int DT>
__global__ void __launch_bounds__(32 * kMaxWarps)
attention_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                 int bias_kind, float* __restrict__ out, int N, int H, int Dh,
                 float scale, int kt, int stages, DropArgs drop) {
  constexpr int DP = 8 * DT;               // head_depth(Dh)
  constexpr int NT = key_tile(BF16) / 8;  // 8-key score tiles per key tile
  constexpr int sq = qk_stride(DP, BF16), sv = v_stride(DP);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int QB = blockDim.x >> 1;  // 16 rows per warp
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * QB;
  const int D = H * Dh, ld = 3 * D;
  const int qrows = BF16 ? 0 : QB;  // Q is staged in float32 mode only
  float* Qs = smem;                    // qrows x sq
  float* Ks = Qs + qrows * sq;         // stages x kt x sq
  float* Vs = Ks + stages * kt * sq;   // stages x kt x sv
  const float* base = qkv + (size_t)b * N * ld + h * Dh;

  if (DP > Dh)  // the head's zero padding in the Q and K rows: never copied
    for (int r = threadIdx.x; r < qrows + stages * kt; r += blockDim.x)
      for (int c = Dh; c < DP; ++c) smem[r * sq + c] = 0.f;

  // rows [r0, r0 + rows) of the q (col 0), k (D) or v (2D) block, zeros past N
  auto stage = [&](float* dst, int stride, int r0, int rows, int col) {
    const int chunks = Dh >> 2;
    for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
      const int r = e / chunks, c = (e - r * chunks) << 2, i = r0 + r;
      cp_async16(dst + r * stride + c, base + (size_t)min(i, N - 1) * ld + col + c, i < N);
    }
  };
  // bf16: pass 1 (statistics) over the T key tiles, then pass 2 (p.V) over
  // them again; one tile needs one step. f32: one online pass.
  const int T = (N + kt - 1) / kt;
  const int steps = (BF16 && T > 1) ? 2 * T : T;
  auto issue = [&](int s) {
    const int buf = s & 1, j0 = (s % T) * kt;
    stage(Ks + buf * kt * sq, sq, j0, kt, D);
    if (!BF16 || s >= steps - T) stage(Vs + buf * kt * sv, sv, j0, kt, 2 * D);
  };
  if (!BF16) stage(Qs, sq, q0, QB, 0);
  issue(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16;
  const bool live = row0 < N;  // warp-uniform
  const float* Qw = Qs + warp * 16 * sq;
  // bf16: the warp's q rows as A fragments, straight from global memory
  uint32_t qf[DP / 16][4];
  if (BF16) {
    const int ra = min(row0 + g, N - 1), rb = min(row0 + g + 8, N - 1);
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int c = ks * 16 + 4 * t;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x = live && row0 + g < N && c < Dh
                           ? *reinterpret_cast<const float4*>(base + (size_t)ra * ld + c) : z;
      const float4 y = live && row0 + g + 8 < N && c < Dh
                           ? *reinterpret_cast<const float4*>(base + (size_t)rb * ld + c) : z;
      qf[ks][0] = pack_bf16(x.x, x.y);
      qf[ks][1] = pack_bf16(y.x, y.y);
      qf[ks][2] = pack_bf16(x.z, x.w);
      qf[ks][3] = pack_bf16(y.z, y.w);
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int buf = s & 1, j0 = (s % T) * kt;
      const int kv = min(kt, N - j0);
      // the bias of the tile, loaded before the products hide its latency
      // (a key bias once per column)
      float bv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = n * 8 + 2 * t + (e & 1);
          const int i = min(row0 + g + 8 * (e >> 1), N - 1);
          bv[n][e] = e < 2 || bias_kind != 2
                         ? (jj < kv ? attn_bias_at(bias, bias_kind, b, i, j0 + jj, N) : 0.f)
                         : bv[n][e - 2];
        }
      // float32 mode: a tile whose every key is masked for the warp's rows
      // adds exactly 0 once both rows' running max comes from a live key
      // (e = 0, alpha = 1): skipped. Rows that see no live key keep the
      // uniform p of masked keys. (In bf16 mode the check cost more than the
      // few whole 64-key tiles it skipped.)
      bool skip = !BF16 && bias_kind != 0 && m[0] > kLiveMax && m[1] > kLiveMax;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          skip = skip && (n * 8 + 2 * t + (e & 1) >= kv || bv[n][e] <= kDeadBias);
      if (!__all_sync(0xffffffffu, skip)) {
        float sc[NT][4];
        qk_tile<BF16, DP, NT>(sc, qf, Qw, Ks + buf * kt * sq, sq, kv, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = n * 8 + 2 * t + (e & 1) < kv ? sc[n][e] * scale + bv[n][e] : -INFINITY;
        float mt[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = -INFINITY;
#pragma unroll
          for (int n = 0; n < NT; ++n) mt[r] = fmaxf(mt[r], fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
          mt[r] = quad_max(mt[r]);
        }
        if (BF16 && s < T) {  // pass 1: running max and (lane-partial) sum
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], mt[r]);
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < NT; ++n)
              sum += expf(sc[n][2 * r] - mn) + expf(sc[n][2 * r + 1] - mn);
            l[r] = l[r] * expf(m[r] - mn) + sum;
            m[r] = mn;
          }
          if (s == T - 1) finish_sum(l);
        }
        const float* Vt = Vs + buf * kt * sv;
        if (BF16 && s >= steps - T) {  // pass 2: p = e / sum, dropout, then p.V
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, jj = n * 8 + 2 * t + (e & 1), i = row0 + g + 8 * r;
              float p = expf(sc[n][e] - m[r]) * l[r];
              if (drop.thr > 0 && jj < kv && i < N)
                p *= drop_mul(drop, (unsigned int)(((size_t)bh * N + i) * N + j0 + jj));
              sc[n][e] = p;
            }
          pv_tile<BF16, DT, NT>(o, sc, Vt, sv, Dh, kv, g, t);
        }
        if (!BF16) {  // online: rescale to the new max, e kept or dropped (0/1)
          float alpha[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], mt[r]);
            alpha[r] = expf(m[r] - mn);
            m[r] = mn;
            l[r] *= alpha[r];
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1, jj = n * 8 + 2 * t + (e & 1), i = row0 + g + 8 * r;
              float x = expf(sc[n][e] - m[r]);
              l[r] += x;
              if (drop.thr > 0 && jj < kv && i < N &&
                  drop_mul(drop, (unsigned int)(((size_t)bh * N + i) * N + j0 + jj)) == 0.f)
                x = 0.f;
              sc[n][e] = x;
            }
          if (DT <= 8) {
            // the tile's p.V in its own accumulator, merged with one rounded
            // o alpha + tile per element: the tensor core truncates each sum,
            // and over thousands of keys that would drift in o itself
            float pv[DT][4];
#pragma unroll
            for (int d = 0; d < DT; ++d)
#pragma unroll
              for (int e = 0; e < 4; ++e) pv[d][e] = 0.f;
            pv_tile<BF16, DT, NT>(pv, sc, Vt, sv, Dh, kv, g, t);
#pragma unroll
            for (int d = 0; d < DT; ++d)
#pragma unroll
              for (int e = 0; e < 4; ++e) o[d][e] = fmaf(o[d][e], alpha[e >> 1], pv[d][e]);
          } else {
#pragma unroll
            for (int d = 0; d < DT; ++d)
#pragma unroll
              for (int e = 0; e < 4; ++e) o[d][e] *= alpha[e >> 1];
            pv_tile<BF16, DT, NT>(o, sc, Vt, sv, Dh, kv, g, t);
          }
        }
      } else if (BF16 && s == T - 1) {
        finish_sum(l);
      }
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

  if (!live) return;
  float f[2] = {1.f, 1.f};
  if (!BF16) {
    const float keep = drop.thr > 0 ? drop.scale : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) f[r] = keep / quad_sum(l[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i >= N) continue;
    float* dst = out + ((size_t)b * N + i) * D + h * Dh + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (d * 8 >= Dh) continue;
      *reinterpret_cast<float2*>(dst + d * 8) =
          make_float2(o[d][2 * r] * f[r], o[d][2 * r + 1] * f[r]);
    }
  }
}

namespace {
using KernelFn = void (*)(const float*, const float*, int, float*, int, int, int,
                          float, int, int, DropArgs);

template <bool BF16>
KernelFn kernel_for(int Dh) {
  if (Dh <= 32) return attention_kernel<BF16, 4>;
  if (Dh <= 64) return attention_kernel<BF16, 8>;
  return attention_kernel<BF16, 16>;
}
}  // namespace

// Bytes of dynamic shared memory a launch takes (ops/kernels.py
// attention_smem_bytes computes the same).
PD_API int pd_attention_smem_bytes(int N, int Dh, int round_in) {
  return (int)smem_bytes(N, Dh, round_in != 0);
}

// bias_kind: 0 none, 1 (N, N) shared by every sequence, 2 (B, N) per key.
PD_API int pd_attention(const void* qkv, const void* bias, int bias_kind,
                        void* out, int B, int N, int H, int Dh, float scale,
                        int round_in, unsigned int drop_key, int drop_thr,
                        float drop_scale, void* stream) {
  if (Dh < 8 || Dh > kMaxDh || Dh % 8 || N < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const bool bf16 = round_in != 0;
  const Tiles tl = tiles_for(N, bf16);
  const size_t smem = smem_bytes(N, Dh, bf16);
  const KernelFn kernel = bf16 ? kernel_for<true>(Dh) : kernel_for<false>(Dh);
  // the shared-memory allowance each instance was given so far (one card)
  static size_t allowed[2][3];
  size_t& allow = allowed[bf16][head_depth(Dh) / 64];
  if (smem > allow) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allow = smem;
  }
  const int rows = 16 * tl.warps;
  const dim3 grid(B * H, (N + rows - 1) / rows);
  kernel<<<grid, 32 * tl.warps, smem, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)bias, bias_kind, (float*)out, N, H, Dh,
      scale, tl.kt, tl.stages, DropArgs{drop_key, drop_thr, drop_scale});
  return (int)cudaGetLastError();
}
