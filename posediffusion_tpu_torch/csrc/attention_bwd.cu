// Backward of softmax attention over a packed QKV buffer on the tensor cores
// (mma.sync): dQKV from dOut.
//
// Replaces the attention backward inside the TPU train kernel
// posediffusion_tpu/ops/vit_train_kernel.py, _attn_residual_bwd (:356), its
// per-head head_bwd (:400-431): p is recomputed from q and k with the bias
// (kind 1, a shared (N, N) bias: the ViT's scale packing; kind 2, a (B, N)
// key bias: the denoiser's frame mask) and the dropout mask of site attn
// (common.cuh, the forward's element index ((b H + h) N + i) N + j), then
//   dv = p_d^T do,  dp = (do v^T) * mask,  ds = p * (dp - rowsum(dp * p)) * scale,
//   dq = ds k,      dk = ds^T q,
// with p_d = p * mask. In the bf16 mode q, k, v, do, p_d and ds are rounded
// to bf16 before their products, the TPU kernel's cast(...) sites, and the
// products are m16n8k16 bf16 MMAs; the softmax, rowsum and accumulations
// stay float32. In float32 mode every product is 3xTF32 (m16n8k8 MMAs of
// the hi = tf32(x), lo = x - hi halves: hi.lo + lo.hi + hi.hi, about 2^-21
// relative), as in the forward (attention.cu).
//
// qkv (B, N, 3D) and dout (B, N, D) float32 -> dqkv (B, N, 3D) float32 with
// dq | dk | dv in the q | k | v columns of each head. stats: B H N x 3
// floats of scratch that the first kernel fills for the second (each row's
// max, 1 / sum and rowsum(dp * p)).
//
// Bound: operations. Per (query, key) cell the function needs five Dh-long
// products (q.k, do.v, and the three gradient products), 10 D operations
// over the heads; the kernels recompute q.k and do.v twice more (nine
// products), each three TF32 MMAs in float32 mode.
// Design: two kernels and no atomics, so the result repeats bitwise.
//   * dq kernel: a block owns 16 W query rows of one (sequence, head) (W =
//     1..4 warps, 16 rows each); q and do rows sit in shared memory, the
//     K / V tiles stream through a two-stage cp.async ring. Pass 1 computes
//     s = q.k^T scale + bias and dp = do.v^T on the tensor cores and keeps
//     the online row max, sum and D = sum_j dp p_d (rescaled like the
//     forward's output); pass 2 recomputes s and dp, forms ds and adds
//     dq += ds k, the score accumulator turned into A fragments in
//     registers. It writes the rows' statistics.
//   * dk/dv kernel: a block owns 16 W keys; the warp computes the transposed
//     scores s^T = k q^T and dp^T = v do^T for a tile of queries (their
//     statistics staged beside them), forms p_d and ds in registers and
//     adds dv += p_d^T do and dk += ds^T q.
// Fragment layout (common.cuh): within each 8-column tile of a score
// accumulator the columns (keys in the dq kernel, queries in the dk/dv
// kernel) are taken in the order perm = 0 1 2 3 5 4 7 6, so that one padded
// row stride (8 mod 32 words) is free of bank conflicts both where a lane
// reads a row g (the B operand of q.k^T, row perm(g)) and where it reads
// rows perm(2t), perm(2t + 1) (the B operand of ds k, whose depth is the
// columns of the score tile). The head is padded with zeros to 32, 64 or
// 128 columns. In float32 mode the small terms of q.k^T and do.v^T get their
// own accumulator, and each tile's gradient product its own, added to the
// running one rounded to nearest (heads of 128, whose registers leave no
// room, run the denoiser's 16 frames and add into it directly): the tensor
// core truncates each sum it adds into an accumulator.
// A tile whose cells are all masked (bias at or below -1e8) for a warp's
// rows, once those rows' max comes from a live key, adds exactly 0 and is
// skipped in float32 mode. Shared memory does not grow with N (keys and
// queries are tiled), so any N runs: 16 frames in the denoiser, 264 and 348
// tokens in the ViTs, 593 at 336px.
#include "common.cuh"

namespace {
constexpr int kMaxWarps = 4;  // 16 rows (queries or keys) each
constexpr int kMaxDh = 128;
constexpr float kDeadBias = -1e8f;  // as attention.cu
constexpr float kLiveMax = -1e7f;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
// head columns the shared rows hold (zeros past Dh)
__host__ __device__ constexpr int head_depth(int Dh) {
  return Dh <= 32 ? 32 : Dh <= 64 ? 64 : 128;
}
__host__ __device__ constexpr int row_stride(int depth) { return depth + 8; }
// columns of a streamed tile (keys, or queries): 32, or 16 for heads of 128
__host__ __device__ constexpr int col_tile(int depth) { return depth > 64 ? 16 : 32; }
// the column of an 8-column accumulator tile that lane (g, t)'s element c
// (0..7: 2t, 2t + 1) or B row g stands for
__device__ __forceinline__ int perm(int c) { return c ^ ((c >> 2) & 1); }

struct Tiles {
  int warps;   // 16 rows each
  int ct;      // columns per streamed tile, a multiple of 16
  int stages;  // 2: a ring of two tiles; 1: one tile holds all N
};

Tiles tiles_for(int N, int Dh) {
  Tiles t;
  const int tile = col_tile(head_depth(Dh));
  t.warps = N < 16 * kMaxWarps ? (N + 15) / 16 : kMaxWarps;
  t.ct = N < tile ? round_up(N, 16) : tile;
  t.stages = N > t.ct ? 2 : 1;
  return t;
}

// Both kernels: 2 x 16 W resident rows and 2 x stages x ct streamed rows;
// the dk/dv kernel also stages the tile's statistics (3 floats a query).
size_t smem_bytes(int N, int Dh, bool dkv) {
  const Tiles t = tiles_for(N, Dh);
  const int sq = row_stride(head_depth(Dh));
  return sizeof(float) * ((size_t)2 * 16 * t.warps * sq + (size_t)2 * t.stages * t.ct * sq +
                          (dkv ? (size_t)3 * t.stages * t.ct : 0));
}

__device__ __forceinline__ float bias_of(const float* bias, int kind, int b, int i,
                                         int j, int N) {
  if (kind == 1) return bias[(size_t)i * N + j];
  if (kind == 2) return bias[(size_t)b * N + j];
  return 0.f;
}

__device__ __forceinline__ float rnd(float v, bool bf16) { return bf16 ? round_bf16(v) : v; }

// acc[n] (16 x 8 tile n) = A B^T over the head: A the warp's 16 resident
// rows Aw, B the streamed rows Bt (tile n's column c is row n * 8 + perm(c));
// tiles at or past kv are left at zero. tf32: the head slice of 8 columns
// d0..d0+7 is taken as MMA depths (t: 2t, t + 4: 2t + 1), one float2 a row;
// bf16: 16 columns, identity order, two float2s a row.
template <bool BF16, int DP, int NT>
__device__ __forceinline__ void nt_product(float (&acc)[NT][4], const float* Aw,
                                           const float* Bt, int kv, int g, int t) {
  constexpr int sq = row_stride(DP);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* a0 = Aw + g * sq + 2 * t;
  const float* a1 = a0 + 8 * sq;
  const float* br = Bt + perm(g) * sq + 2 * t;
  if (BF16) {
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 16) {
      const float2 x0 = *reinterpret_cast<const float2*>(a0 + d0);
      const float2 y0 = *reinterpret_cast<const float2*>(a1 + d0);
      const float2 x1 = *reinterpret_cast<const float2*>(a0 + d0 + 8);
      const float2 y1 = *reinterpret_cast<const float2*>(a1 + d0 + 8);
      const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(y0.x, y0.y),
                             pack_bf16(x1.x, x1.y), pack_bf16(y1.x, y1.y)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 >= kv) continue;
        const float2 u = *reinterpret_cast<const float2*>(br + n * 8 * sq + d0);
        const float2 v = *reinterpret_cast<const float2*>(br + n * 8 * sq + d0 + 8);
        mma_bf16(acc[n], a, pack_bf16(u.x, u.y), pack_bf16(v.x, v.y));
      }
    }
  } else {
    float lo[NT][4];  // hi.lo + lo.hi, added to hi.hi once
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[n][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < DP; d0 += 8) {
      const float2 x = *reinterpret_cast<const float2*>(a0 + d0);
      const float2 y = *reinterpret_cast<const float2*>(a1 + d0);
      uint32_t ah[4], al[4];
      split_tf32(x.x, ah[0], al[0]);
      split_tf32(y.x, ah[1], al[1]);
      split_tf32(x.y, ah[2], al[2]);
      split_tf32(y.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 >= kv) continue;
        const float2 u = *reinterpret_cast<const float2*>(br + n * 8 * sq + d0);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(u.x, bh0, bl0);
        split_tf32(u.y, bh1, bl1);
        mma_tf32(lo[n], al, bh0, bh1);
        mma_tf32(lo[n], ah, bl0, bl1);
        mma_tf32(acc[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += lo[n][e];
  }
}

// out[d] (16 x 8, head columns d * 8 ..) += P Bt: P in the accumulator
// layout of nt_product (its columns are the depth), Bt the streamed rows of
// the same tile (row n * 8 + perm(c) for column c of tile n). In bf16 mode P
// holds bf16 values already (the rounding site), so packing it is exact.
template <bool BF16, int DT, int NT>
__device__ __forceinline__ void tn_product(float (&out)[DT][4], const float (&p)[NT][4],
                                           const float* Bt, int Dh, int kv, int g,
                                           int t) {
  constexpr int sq = row_stride(8 * DT);
  const int r0 = perm(2 * t) * sq + g, r1 = perm(2 * t + 1) * sq + g;
  if (BF16) {
#pragma unroll
    for (int ks = 0; ks < NT / 2; ++ks) {  // 16 columns: tiles 2ks, 2ks + 1
      if (ks * 16 >= kv) continue;
      const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                             pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                             pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                             pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
      const float* b0 = Bt + ks * 16 * sq;
      const float* b1 = b0 + 8 * sq;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        if (d * 8 >= Dh) continue;
        mma_bf16(out[d], a, pack_bf16(b0[r0 + d * 8], b0[r1 + d * 8]),
                 pack_bf16(b1[r0 + d * 8], b1[r1 + d * 8]));
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {  // 8 columns: depth t <- 2t, t + 4 <- 2t + 1
      if (n * 8 >= kv) continue;
      uint32_t ah[4], al[4];
      split_tf32(p[n][0], ah[0], al[0]);
      split_tf32(p[n][2], ah[1], al[1]);
      split_tf32(p[n][1], ah[2], al[2]);
      split_tf32(p[n][3], ah[3], al[3]);
      const float* b = Bt + n * 8 * sq;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        if (d * 8 >= Dh) continue;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[r0 + d * 8], bh0, bl0);
        split_tf32(b[r1 + d * 8], bh1, bl1);
        mma_tf32(out[d], al, bh0, bh1);
        mma_tf32(out[d], ah, bl0, bl1);
        mma_tf32(out[d], ah, bh0, bh1);
      }
    }
  }
}

// out += P Bt; a tile's sum in its own accumulator first where registers
// allow (heads up to 64), merged with one rounded add per element
template <bool BF16, int DT, int NT>
__device__ __forceinline__ void tn_accumulate(float (&out)[DT][4], const float (&p)[NT][4],
                                              const float* Bt, int Dh, int kv, int g,
                                              int t) {
  if (DT <= 8) {
    float tile[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) tile[d][e] = 0.f;
    tn_product<BF16, DT, NT>(tile, p, Bt, Dh, kv, g, t);
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[d][e] += tile[d][e];
  } else {
    tn_product<BF16, DT, NT>(out, p, Bt, Dh, kv, g, t);
  }
}

// rows [r0, r0 + rows) of one head's columns of a (., ld) matrix into
// shared rows of stride sq, zeros past N (16-byte copies: Dh % 8 == 0 and
// the wrapper holds the bases 16-byte aligned)
__device__ __forceinline__ void stage_rows(float* dst, int sq, const float* src, int ld,
                                           int r0, int rows, int N, int Dh) {
  const int chunks = Dh >> 2;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e - r * chunks) << 2, i = r0 + r;
    cp_async16(dst + r * sq + c, src + (size_t)min(i, N - 1) * ld + c, i < N);
  }
}

// the head's zero padding (columns Dh .. DP) of `rows` shared rows: never copied
__device__ __forceinline__ void zero_pad(float* smem, int rows, int sq, int Dh, int DP) {
  if (DP > Dh)
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      for (int c = Dh; c < DP; ++c) smem[r * sq + c] = 0.f;
}
}  // namespace

// grid (B * H, row blocks of 16 W queries), block 32 W threads; DT: 8-column
// tiles of the padded head.
template <bool BF16, int DT>
__global__ void __launch_bounds__(32 * kMaxWarps)
attn_bwd_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                   const float* __restrict__ bias, int kind, float* __restrict__ dqkv,
                   float* __restrict__ stats, int N, int H, int Dh, float scale, int ct,
                   int stages, DropArgs drop) {
  constexpr int DP = 8 * DT, sq = row_stride(DP), NT = col_tile(DP) / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int R = blockDim.x >> 1;  // 16 rows a warp
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * R;
  const int D = H * Dh, ld = 3 * D;
  float* Qs = smem;                    // R x sq
  float* Os = Qs + R * sq;             // R x sq (dout rows)
  float* Ks = Os + R * sq;             // stages x ct x sq
  float* Vs = Ks + stages * ct * sq;   // stages x ct x sq
  const float* base = qkv + (size_t)b * N * ld + h * Dh;
  const float* obase = dout + (size_t)b * N * D + h * Dh;
  zero_pad(smem, 2 * R + 2 * stages * ct, sq, Dh, DP);

  // step s: pass s / T (statistics, then dq) over key tile s % T
  const int T = (N + ct - 1) / ct;
  const int steps = 2 * T;
  auto issue = [&](int s) {
    const int buf = s & 1, j0 = (s % T) * ct;
    stage_rows(Ks + buf * ct * sq, sq, base + D, ld, j0, ct, N, Dh);
    stage_rows(Vs + buf * ct * sq, sq, base + 2 * D, ld, j0, ct, N, Dh);
  };
  stage_rows(Qs, sq, base, ld, q0, R, N, Dh);
  stage_rows(Os, sq, obase, D, q0, R, N, Dh);
  issue(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16;
  const bool live = row0 < N;  // warp-uniform
  const float* Qw = Qs + warp * 16 * sq;
  const float* Ow = Os + warp * 16 * sq;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float inv_l[2] = {0.f, 0.f}, Dr[2] = {0.f, 0.f};
  float dq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const bool reload = T > 1;  // one tile: staged once, read by both passes
    if (reload && s + 1 < steps) {
      issue(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pass = s / T, j0 = (s % T) * ct;
    const int buf = reload ? s & 1 : 0;
    if (live) {
      const int kv = min(ct, N - j0);
      const float* Kt = Ks + buf * ct * sq;
      const float* Vt = Vs + buf * ct * sq;
      float bv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = n * 8 + perm(2 * t + (e & 1));
          const int i = min(row0 + g + 8 * (e >> 1), N - 1);
          bv[n][e] = e < 2 || kind != 2
                         ? (jj < kv ? bias_of(bias, kind, b, i, j0 + jj, N) : 0.f)
                         : bv[n][e - 2];
        }
      bool skip = !BF16 && kind != 0 && m[0] > kLiveMax && m[1] > kLiveMax;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          skip = skip && (n * 8 + perm(2 * t + (e & 1)) >= kv || bv[n][e] <= kDeadBias);
      if (!__all_sync(0xffffffffu, skip)) {
        float sc[NT][4], dp[NT][4];
        nt_product<BF16, DP, NT>(sc, Qw, Kt, kv, g, t);
        nt_product<BF16, DP, NT>(dp, Ow, Vt, kv, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = n * 8 + perm(2 * t + (e & 1));
            sc[n][e] = jj < kv ? sc[n][e] * scale + bv[n][e] : -INFINITY;
            const int i = row0 + g + 8 * (e >> 1);
            if (drop.thr > 0 && jj < kv && i < N)
              dp[n][e] *= drop_mul(drop, (unsigned int)(((size_t)bh * N + i) * N + j0 + jj));
          }
        if (pass == 0) {  // online max, sum and sum of dp_d e, rescaled together
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mt = -INFINITY;
#pragma unroll
            for (int n = 0; n < NT; ++n) mt = fmaxf(mt, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
            const float mn = fmaxf(m[r], quad_max(mt));
            const float alpha = expf(m[r] - mn);
            float se = 0.f, sd = 0.f;
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float e = expf(sc[n][2 * r + c] - mn);
                se += e;
                sd = fmaf(e, dp[n][2 * r + c], sd);
              }
            l[r] = l[r] * alpha + se;
            dn[r] = dn[r] * alpha + sd;
            m[r] = mn;
          }
        } else {  // ds = p (dp_d - D) scale, then dq += ds k
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float p = expf(sc[n][e] - m[r]) * inv_l[r];
              sc[n][e] = rnd(p * (dp[n][e] - Dr[r]) * scale, BF16);
            }
          tn_accumulate<BF16, DT, NT>(dq, sc, Kt, Dh, kv, g, t);
        }
      }
      if (pass == 0 && s == T - 1) {  // the statistics, for pass 2 and the dk/dv kernel
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv_l[r] = 1.f / quad_sum(l[r]);
          Dr[r] = quad_sum(dn[r]) * inv_l[r];
        }
      }
    }
    __syncthreads();  // the tile is consumed before its buffer is refilled
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + g + 8 * r;
    if (i >= N) continue;
    float* dst = dqkv + ((size_t)b * N + i) * ld + h * Dh + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (d * 8 >= Dh) continue;
      *reinterpret_cast<float2*>(dst + d * 8) = make_float2(dq[d][2 * r], dq[d][2 * r + 1]);
    }
    if (t == 0) {
      float* st = stats + ((size_t)bh * N + i) * 3;
      st[0] = m[r];
      st[1] = inv_l[r];
      st[2] = Dr[r];
    }
  }
}

// grid (B * H, row blocks of 16 W keys), block 32 W threads. Heads up to
// 64 ask for three blocks an SM: the register cap (168) spills 96 bytes in
// float32 mode, and the kernel still ran a fifth faster than as two blocks
// of 240 registers at the ViT's 64 x 264 on an H100, in both modes. Heads
// of 128 (the denoiser's 16 frames, one-warp blocks) keep their registers.
template <bool BF16, int DT>
__global__ void __launch_bounds__(32 * kMaxWarps, (DT > 8 ? 1 : 3))
attn_bwd_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ bias, int kind,
                    const float* __restrict__ stats, float* __restrict__ dqkv, int N,
                    int H, int Dh, float scale, int ct, int stages, DropArgs drop) {
  constexpr int DP = 8 * DT, sq = row_stride(DP), NT = col_tile(DP) / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int R = blockDim.x >> 1;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * R;
  const int D = H * Dh, ld = 3 * D;
  float* Kb = smem;                    // R x sq (this block's keys)
  float* Vb = Kb + R * sq;             // R x sq
  float* Qt = Vb + R * sq;             // stages x ct x sq (query tiles)
  float* Ot = Qt + stages * ct * sq;   // stages x ct x sq (their dout rows)
  float* St = Ot + stages * ct * sq;   // stages x ct x 3 (their statistics)
  const float* base = qkv + (size_t)b * N * ld + h * Dh;
  const float* obase = dout + (size_t)b * N * D + h * Dh;
  const float* sbase = stats + (size_t)bh * N * 3;
  zero_pad(smem, 2 * R + 2 * stages * ct, sq, Dh, DP);

  const int T = (N + ct - 1) / ct;
  auto issue = [&](int s) {
    const int buf = s & 1, i0 = s * ct;
    stage_rows(Qt + buf * ct * sq, sq, base, ld, i0, ct, N, Dh);
    stage_rows(Ot + buf * ct * sq, sq, obase, D, i0, ct, N, Dh);
    for (int e = threadIdx.x; e < 3 * ct; e += blockDim.x) {
      const int i = i0 + e / 3;
      cp_async4(St + buf * ct * 3 + e, sbase + (i < N ? 3 * i + e % 3 : 0), i < N);
    }
  };
  stage_rows(Kb, sq, base + D, ld, k0, R, N, Dh);
  stage_rows(Vb, sq, base + 2 * D, ld, k0, R, N, Dh);
  issue(0);
  cp_async_commit();

  const int key0 = k0 + warp * 16;
  const bool live = key0 < N;  // warp-uniform
  const float* Kw = Kb + warp * 16 * sq;
  const float* Vw = Vb + warp * 16 * sq;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int s = 0; s < T; ++s) {
    if (s + 1 < T) {
      issue(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const int buf = s & 1, i0 = s * ct;
      const int kv = min(ct, N - i0);  // live queries of the tile
      const float* Qtile = Qt + buf * ct * sq;
      const float* Otile = Ot + buf * ct * sq;
      const float* Stile = St + buf * ct * 3;
      // element (n, e): key key0 + g + 8 (e / 2), query i0 + n * 8 + perm(2t + e % 2)
      float bv[NT][4], sm[NT][2], sl[NT][2], sd[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // a tile of fewer than 8 NT queries ends at ct
          const int ii = n * 8 + perm(2 * t + c);
          sm[n][c] = ii < kv ? Stile[3 * ii] : 0.f;
          sl[n][c] = ii < kv ? Stile[3 * ii + 1] : 0.f;
          sd[n][c] = ii < kv ? Stile[3 * ii + 2] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = n * 8 + perm(2 * t + (e & 1));
          const int j = min(key0 + g + 8 * (e >> 1), N - 1);
          bv[n][e] = ii < kv ? bias_of(bias, kind, b, i0 + ii, j, N) : 0.f;
        }
      }
      bool skip = !BF16 && kind != 0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = n * 8 + perm(2 * t + (e & 1));
          skip = skip && (ii >= kv || key0 + g + 8 * (e >> 1) >= N ||
                          (bv[n][e] <= kDeadBias && sm[n][e & 1] > kLiveMax));
        }
      if (!__all_sync(0xffffffffu, skip)) {
        float sc[NT][4], dp[NT][4];
        nt_product<BF16, DP, NT>(sc, Kw, Qtile, kv, g, t);
        nt_product<BF16, DP, NT>(dp, Vw, Otile, kv, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = n * 8 + perm(2 * t + (e & 1));
            const int i = i0 + ii, j = key0 + g + 8 * (e >> 1);
            float pd = 0.f, ds = 0.f;
            if (ii < kv && j < N) {
              const float p = expf(sc[n][e] * scale + bv[n][e] - sm[n][e & 1]) * sl[n][e & 1];
              const float mul = drop_mul(drop, (unsigned int)(((size_t)bh * N + i) * N + j));
              pd = rnd(p * mul, BF16);
              ds = rnd(p * (dp[n][e] * mul - sd[n][e & 1]) * scale, BF16);
            }
            sc[n][e] = pd;
            dp[n][e] = ds;
          }
        tn_accumulate<BF16, DT, NT>(dv, sc, Otile, Dh, kv, g, t);
        tn_accumulate<BF16, DT, NT>(dk, dp, Qtile, Dh, kv, g, t);
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + g + 8 * r;
    if (j >= N) continue;
    float* dst = dqkv + ((size_t)b * N + j) * ld + h * Dh + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (d * 8 >= Dh) continue;
      *reinterpret_cast<float2*>(dst + D + d * 8) = make_float2(dk[d][2 * r], dk[d][2 * r + 1]);
      *reinterpret_cast<float2*>(dst + 2 * D + d * 8) =
          make_float2(dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

namespace {
using DqFn = void (*)(const float*, const float*, const float*, int, float*, float*, int, int,
                      int, float, int, int, DropArgs);
using DkvFn = void (*)(const float*, const float*, const float*, int, const float*, float*,
                       int, int, int, float, int, int, DropArgs);

template <bool BF16>
void kernels_for(int Dh, DqFn& dq, DkvFn& dkv) {
  if (Dh <= 32) {
    dq = attn_bwd_dq_kernel<BF16, 4>;
    dkv = attn_bwd_dkv_kernel<BF16, 4>;
  } else if (Dh <= 64) {
    dq = attn_bwd_dq_kernel<BF16, 8>;
    dkv = attn_bwd_dkv_kernel<BF16, 8>;
  } else {
    dq = attn_bwd_dq_kernel<BF16, 16>;
    dkv = attn_bwd_dkv_kernel<BF16, 16>;
  }
}

// raise a kernel's dynamic shared-memory allowance to `bytes` once per size
cudaError_t allow_smem(const void* kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}
}  // namespace

// Bytes of dynamic shared memory of the larger launch, the dk/dv kernel's
// (ops/kernels.py attention_bwd_smem_bytes computes the same; the layout is
// the same in both modes).
PD_API int pd_attention_bwd_smem_bytes(int N, int Dh) {
  return (int)smem_bytes(N, Dh, true);
}

// stats: scratch of B * H * N * 3 floats. bias_kind as pd_attention's. Dh
// a multiple of 8 up to 128; qkv and dout 16-byte aligned (the wrapper
// checks).
PD_API int pd_attention_bwd(const void* qkv, const void* dout, const void* bias,
                            int bias_kind, void* dqkv, void* stats, int B,
                            int N, int H, int Dh, float scale, int round_in,
                            unsigned int drop_key, int drop_thr,
                            float drop_scale, void* stream) {
  if (Dh < 8 || Dh > kMaxDh || Dh % 8 || N < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf16 = round_in != 0;
  const DropArgs drop{drop_key, drop_thr, drop_scale};
  const Tiles tl = tiles_for(N, Dh);
  const size_t smem1 = smem_bytes(N, Dh, false), smem2 = smem_bytes(N, Dh, true);
  DqFn dq;
  DkvFn dkv;
  if (bf16)
    kernels_for<true>(Dh, dq, dkv);
  else
    kernels_for<false>(Dh, dq, dkv);
  // the allowance each instance was given so far (one card)
  static size_t allowed[2][3][2];
  const int di = head_depth(Dh) / 64;
  cudaError_t err = allow_smem((const void*)dq, smem1, allowed[bf16][di][0]);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem((const void*)dkv, smem2, allowed[bf16][di][1]);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * tl.warps;
  const dim3 grid(B * H, (N + rows - 1) / rows);
  dq<<<grid, 32 * tl.warps, smem1, s>>>(
      (const float*)qkv, (const float*)dout, (const float*)bias, bias_kind, (float*)dqkv,
      (float*)stats, N, H, Dh, scale, tl.ct, tl.stages, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv<<<grid, 32 * tl.warps, smem2, s>>>(
      (const float*)qkv, (const float*)dout, (const float*)bias, bias_kind,
      (const float*)stats, (float*)dqkv, N, H, Dh, scale, tl.ct, tl.stages, drop);
  return (int)cudaGetLastError();
}
