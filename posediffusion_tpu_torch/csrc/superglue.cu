// The final step of the fused SuperGlue matcher: pair scores into the
// dustbin coupling, log-domain Sinkhorn, and mutual-max match extraction.
//
// Replaces the last grid step (s == L2) of
//   posediffusion_tpu/ops/superglue_kernel.py  _superglue_kernel, as run by
//                                              fused_match_pairs (:285)
// whose GNN layers run on csrc/linear.cu and csrc/attention.cu (key bias).
//
// Layout: m is (C, 2, K, D) float32, the final projections of both keypoint
// sets of C pairs; masks are (C, K) float32 0/1. The coupling, and the log
// assignment Z, are (C, K + 1, K + 1): rows and columns 0..K-1 are the
// keypoints, row and column K the dustbin. The TPU kernel pads them to
// K + 8 for its (8, 128) tiling; Hopper needs no such padding, so there is
// none (the padded cells are -1e9 there and change no sum).
//   coupling[i, j] = valid0[i] & valid1[j] ? m0[i] . m1[j] / sqrt(D) : -1e9
//   coupling[i, K] = valid0[i] ? bin : -1e9, coupling[K, j] likewise,
//   coupling[K, K] = bin;
//   norm = -log(ms + ns), log_mu = (valid0 ? norm : -1e9 | log ns + norm),
//   log_nu = (valid1 ? norm : -1e9 | log ms + norm);
//   iters x { u = log_mu - lse_j(cpl + v); v = log_nu - lse_i(cpl + u) }
//   Z = cpl + u + v - norm.
// Matches: over the live block (valid0[i] & valid1[j]), row i matches
// j = its first argmax when i is column j's first argmax and exp(Z[i, j]) >
// threshold. That is the mutual check of the reference match_pair and of
// match_pairs_batched_xla. The TPU kernel's gather-free both-argmax
// (:262-275) differs on exact ties: two rows that tie for a column's maximum
// both match it there. Random weights collapse tokens into such ties, so
// the port follows the reference; the one gather (a column's argmax) is a
// single load per row here.
//
// Bound: at K = 1,024 and C = 32 pairs the scores are 17.2 GFLOP, 52 GFLOP
// of TF32 work as 3xTF32 (0.104 ms at 495 TFLOP/s, less for the dead tiles
// below), against 0.060 ms to read m and write the scores: bound by the
// tensor cores. Each Sinkhorn half-iteration streams the 134 MB coupling
// once from HBM (it does not fit the 50 MB L2): 100 passes, bound by memory
// bandwidth and expf.
// Design of the scores (sg_scores_kernel): S = m0 m1^T on the tensor cores
// as 3xTF32 mma.sync m16n8k8 (hi = tf32(x), lo = x - hi, three MMAs a
// product, a fresh accumulator per 64-wide D slice added rounded to nearest
// into the running sum, since the tensor core truncates), in 128 x 128
// tiles of 8 warps on a persistent grid fed by a 3-stage cp.async ring of
// D slices. That is linear_tf32_kernel's scheme (csrc/linear.cu) with both
// operands K-major, as its trans_w instance: m0's rows and m1's rows are
// contiguous in D, so both are staged as they lie. A tile whose rows, or
// whose columns, are all masked is written as -1e9 without a product
// (exact: every cell there is masked): the marginals pass flags each pair's
// 128-keypoint tiles that hold a valid keypoint, one block lists the live
// tiles in order and the dead ones after them (sg_tiles_kernel), and block b
// of the persistent grid takes list entries b, b + grid, ...: every block
// gets the same number of live tiles to within one, whatever the masks
// (a static split of the tile grid left the blocks with the most live tiles
// setting the time). The tile leaves through its ring slot, each row as
// coalesced runs of scalar stores (the coupling's rows are K + 1 floats:
// not 16-byte aligned); the epilogue takes the rows' validity from four
// ballots and multiplies by 1 / sqrt(D) where that is exact (a power of
// two) in place of a mask load and a division per cell, since the kernel is
// bound by issue more than by the tensor cores (kernel_probes.py --mma:
// mma.sync issues TF32 at about two thirds of the card's dense peak). One
// summation order, no atomics: the scores repeat bitwise.
// The Sinkhorn and match passes, simple first: one launch per
// half-iteration, one warp per row (coalesced) or 32 columns per block with
// 8 warps splitting the rows (coalesced across the columns), an online
// log-sum-exp per lane merged across lanes. No fusion of the passes yet.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e9f;      // a masked cell, as the JAX package's _NEG
constexpr float kDead = -3e38f;    // outside the live block in match extraction
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- (a) scores: S = m0 m1^T / sqrt(D), masked, into the coupling
//
// Fragments as linear_tf32_kernel's trans_w instance: within each 16 of D,
// MMA depth t of step s is d = 4t + 2s and depth t + 4 is 4t + 2s + 1, so
// a lane reads four d of a row with one float4. m0's slice is [i][d] in
// rows of 80 floats (16 mod 32 banks), m1's [j][d] in rows of 68 (4 mod
// 32); MMA column g of n tile j is column 4g + j of the warp's 32. Every
// quarter-warp then reads 8 distinct 16-byte bank groups.
constexpr int SC_BM = 128, SC_BN = 128, SC_BK = 64;
constexpr int SC_STAGES = 3;             // two slices in flight while one is read
constexpr int SC_LDA = SC_BK + 16;       // m0's slice [i][d], floats: 16 mod 32 banks
constexpr int SC_LDB = SC_BK + 4;        // m1's slice [j][d], floats: 4 mod 32 banks
constexpr int SC_LDC = SC_BN + 4;        // the finished tile [i][j], floats
constexpr int SC_STAGE = 4 * (SC_BM * SC_LDA + SC_BN * SC_LDB);  // bytes of a ring slot
constexpr int SC_SMEM = SC_STAGES * SC_STAGE;                     // 227,328 B
constexpr int SC_LIST_THREADS = 1024;    // sg_tiles_kernel: one block
static_assert(SC_BM == SC_BN, "rows and columns share the tile flags");
static_assert(SC_BM == 4 * 32 && SC_BN * 2 == kThreads, "row bits and the epilogue's layout");
static_assert(4 * SC_BM * SC_LDC <= SC_STAGE, "the finished tile fits a ring slot");
static_assert(SC_SMEM <= 232448, "shared memory of one block");

// Tiles of one launch: C pairs of (K / 128 rounded up)^2; the scratch holds
// their flags (C, 2, K / 128 up: a valid keypoint of set 0, set 1 in the
// tile), the tile list and the live count (ops/kernels.py sg_scores_scratch
// holds the same sizes).
__host__ __device__ constexpr int sc_tiles_1d(int K) { return (K + SC_BM - 1) / SC_BM; }
__host__ __device__ constexpr long long sc_tiles(int C, int K) {
  return (long long)C * sc_tiles_1d(K) * sc_tiles_1d(K);
}

// The tile list: tile t = (c * n + bi) * n + bj, n = K / 128 rounded up, is
// live when row tile bi of set 0 and column tile bj of set 1 hold a valid
// keypoint. Live tiles go to list[0 ..] in increasing t, dead ones to
// list[T - 1], list[T - 2], ...; list[T] is the live count. One block:
// chunks of 1,024 tiles, ranked by a block-wide count of the live ones.
__global__ void __launch_bounds__(SC_LIST_THREADS)
sg_tiles_kernel(const int* __restrict__ flags, int* __restrict__ list, int C, int K) {
  __shared__ int warp_live[SC_LIST_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = sc_tiles_1d(K), T = (int)sc_tiles(C, K);
  int live_before = 0;
  for (int b = 0; b < T; b += SC_LIST_THREADS) {
    const int t = b + tid;
    bool live = false;
    if (t < T) {
      const int c = t / (n * n), bi = (t / n) % n, bj = t % n;
      live = flags[(2 * c) * n + bi] && flags[(2 * c + 1) * n + bj];
    }
    const unsigned ball = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ball);
    __syncthreads();
    int rank = __popc(ball & ((1u << lane) - 1)), total = 0;
    for (int w = 0; w < SC_LIST_THREADS / 32; ++w) {
      rank += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (t < T) {
      if (live) list[live_before + rank] = t;
      else list[T - 1 - (b - live_before) - (tid - rank)] = t;  // dead before t: b - live_before + tid - rank
    }
    live_before += total;
    __syncthreads();  // warp_live is read before the next chunk writes it
  }
  if (tid == 0) list[T] = live_before;
}

__global__ void __launch_bounds__(kThreads, 1)
sg_scores_kernel(const float* __restrict__ m, const float* __restrict__ mask0,
                 const float* __restrict__ mask1, const int* __restrict__ list,
                 float* __restrict__ cpl, int C, int K, int D, float sqrt_d, int vec) {
  extern __shared__ float4 sc_smem4[];
  __shared__ unsigned row_ok[SC_BM / 32];  // a tile's rows' validity, bit r % 32 of word r / 32
  char* smem = reinterpret_cast<char*>(sc_smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int n = sc_tiles_1d(K), T = (int)sc_tiles(C, K);
  const int slices = (D + SC_BK - 1) / SC_BK;
  const int G = (int)gridDim.x, b = (int)blockIdx.x;
  const int live = list[T];
  const size_t K1 = (size_t)K + 1;
  // x / sqrt_d, as the plain version divides: a multiplication where
  // 1 / sqrt_d is a power of two (exact, so the same bits), else a division
  const float inv = 1.f / sqrt_d;
  const bool exact_inv = inv * sqrt_d == 1.f && (__float_as_uint(inv) & 0x7fffffu) == 0;

  // tile -> pair c, first row i0, first column j0
  auto decode = [&](int tile, int& c, int& i0, int& j0) {
    c = tile / (n * n);
    i0 = ((tile / n) % n) * SC_BM;
    j0 = (tile % n) * SC_BN;
  };

  // the dead tiles of this block (list entries b + k G at or past `live`):
  // every in-range cell is masked
  for (int u = b < live ? b + (live - b + G - 1) / G * G : b; u < T; u += G) {
    int c, i0, j0;
    decode(list[u], c, i0, j0);
    float* out = cpl + (size_t)c * K1 * K1;
    for (int e = tid; e < SC_BM * SC_BN; e += kThreads) {
      const int r = i0 + e / SC_BN, col = j0 + e % SC_BN;
      if (r < K && col < K) out[r * K1 + col] = kNeg;
    }
  }

  // the live ones: step q is list entry b + (q / slices) G, D slice q % slices
  const int mine = b < live ? (live - 1 - b) / G + 1 : 0;
  const int steps = mine * slices;

  // step q into ring slot q % SC_STAGES
  auto stage = [&](int q) {
    float* as = reinterpret_cast<float*>(smem + (q % SC_STAGES) * SC_STAGE);
    float* bs = as + SC_BM * SC_LDA;
    int c, i0, j0;
    decode(list[b + (q / slices) * G], c, i0, j0);
    const int k0 = (q % slices) * SC_BK;
    const float* A = m + (size_t)c * 2 * K * D;  // set 0
    const float* B = A + (size_t)K * D;          // set 1
    if (vec) {
      for (int e = tid; e < SC_BM * (SC_BK / 4); e += kThreads) {
        const int r = e / (SC_BK / 4), d = 4 * (e % (SC_BK / 4));
        const bool in_d = k0 + d < D;  // D % 4 == 0: whole chunks
        const bool oka = in_d && i0 + r < K, okb = in_d && j0 + r < K;
        cp_async16(as + r * SC_LDA + d, oka ? A + (size_t)(i0 + r) * D + k0 + d : A, oka);
        cp_async16(bs + r * SC_LDB + d, okb ? B + (size_t)(j0 + r) * D + k0 + d : B, okb);
      }
    } else {
      for (int e = tid; e < SC_BM * SC_BK; e += kThreads) {
        const int r = e / SC_BK, d = e % SC_BK;
        const bool in_d = k0 + d < D;
        const bool oka = in_d && i0 + r < K, okb = in_d && j0 + r < K;
        cp_async4(as + r * SC_LDA + d, oka ? A + (size_t)(i0 + r) * D + k0 + d : A, oka);
        cp_async4(bs + r * SC_LDB + d, okb ? B + (size_t)(j0 + r) * D + k0 + d : B, okb);
      }
    }
  };

  float acc[4][4][4], tmp[4][4][4];
#pragma unroll
  for (int q = 0; q < SC_STAGES - 1; ++q) {
    if (q < steps) stage(q);
    cp_async_commit();
  }
  for (int q = 0; q < steps; ++q) {
    cp_async_wait<SC_STAGES - 2>();
    __syncthreads();  // step q is in; slot (q - 1) % SC_STAGES is free
    if (q + SC_STAGES - 1 < steps) stage(q + SC_STAGES - 1);
    cp_async_commit();
    const int slice = q % slices;
    const float* as = reinterpret_cast<const float*>(smem + (q % SC_STAGES) * SC_STAGE);
    const float* bs = as + SC_BM * SC_LDA;
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
    for (int kk = 0; kk < SC_BK; kk += 16) {
      // m1 at depth kk + 4t + q4, column wn + 4g + j of the warp: bv[q4][j]
      float bv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(bs + (wn + 4 * g + j) * SC_LDB + kk + 4 * t);
        bv[0][j] = f.x; bv[1][j] = f.y; bv[2][j] = f.z; bv[3][j] = f.w;
      }
      // m0 at row wm + 16i + g + 8h, depths kk + 4t .. + 3: av[i][h]
      float av[4][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 f = *reinterpret_cast<const float4*>(
              as + (wm + 16 * i + g + 8 * h) * SC_LDA + kk + 4 * t);
          av[i][h][0] = f.x; av[i][h][1] = f.y; av[i][h][2] = f.z; av[i][h][3] = f.w;
        }
#pragma unroll
      for (int st = 0; st < 2; ++st) {  // MMA depth t is d 4t + 2st, t + 4 is 4t + 2st + 1
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) split_tf32(bv[2 * st + u][j], bh[j][u], bl[j][u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const float x[4] = {av[i][0][2 * st], av[i][1][2 * st], av[i][0][2 * st + 1],
                              av[i][1][2 * st + 1]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(x[e], ah[e], al[e]);
          // term by term over the 4 n tiles: lo.hi, hi.lo, hi.hi
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(tmp[i][j], al, bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(tmp[i][j], ah, bl[j][0], bl[j][1]);
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
    int c, i0, j0;
    decode(list[b + (q / slices) * G], c, i0, j0);
    float* cs = reinterpret_cast<float*>(smem + (q % SC_STAGES) * SC_STAGE);
    __syncthreads();  // the slot's last readers are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          *reinterpret_cast<float4*>(cs + (wm + 16 * i + g + 8 * h) * SC_LDC + wn + 8 * t + 4 * cc) =
              make_float4(acc[i][0][2 * h + cc], acc[i][1][2 * h + cc], acc[i][2][2 * h + cc],
                          acc[i][3][2 * h + cc]);
    if (warp < SC_BM / 32) {
      const int row = i0 + 32 * warp + lane;
      const unsigned ok = __ballot_sync(0xffffffffu, row < K && mask0[(size_t)c * K + row] > 0.5f);
      if (lane == 0) row_ok[warp] = ok;
    }
    __syncthreads();
    // a thread owns column tid % 128 and every other row: each warp stores
    // 32 consecutive floats of a row
    const int col = j0 + tid % SC_BN;
    if (col >= K) continue;
    const bool col_ok = mask1[(size_t)c * K + col] > 0.5f;
    float* out = cpl + (size_t)c * K1 * K1 + col;
    const int rows = min(SC_BM, K - i0);
#pragma unroll 4
    for (int r = tid / SC_BN; r < rows; r += kThreads / SC_BN) {
      const float v = cs[r * SC_LDC + tid % SC_BN];
      out[(i0 + r) * K1] = col_ok && (row_ok[r / 32] >> (r % 32) & 1u)
                               ? (exact_inv ? v * inv : v / sqrt_d) : kNeg;
    }
  }
  cp_async_wait<0>();
}

// Dustbin row and column of the coupling, the marginals, and the pair's
// tile flags for the scores (flags (2, K / 128 up) of this pair: 1 where
// the 128-keypoint tile of set 0, set 1 holds a valid keypoint); one block
// a pair.
__global__ void __launch_bounds__(kThreads)
sg_marginals_kernel(const float* __restrict__ mask0, const float* __restrict__ mask1,
                    const float* __restrict__ bin, float* __restrict__ cpl,
                    float* __restrict__ log_mu, float* __restrict__ log_nu,
                    float* __restrict__ norm, int* __restrict__ flags, int K) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = sc_tiles_1d(K);
  const size_t K1 = (size_t)K + 1;
  const float* v0 = mask0 + (size_t)c * K;
  const float* v1 = mask1 + (size_t)c * K;
  int* f0 = flags + (size_t)c * 2 * n;
  int* f1 = f0 + n;
  for (int t = threadIdx.x; t < 2 * n; t += kThreads) f0[t] = 0;
  __syncthreads();
  float s0 = 0.f, s1 = 0.f;
  // a warp's 32 keypoints lie in one 128-keypoint tile
  for (int i0 = warp * 32; i0 < K; i0 += kThreads) {
    const int i = i0 + lane;
    const bool ok0 = i < K && v0[i] > 0.5f, ok1 = i < K && v1[i] > 0.5f;
    s0 += ok0 ? 1.f : 0.f;
    s1 += ok1 ? 1.f : 0.f;
    if (__any_sync(0xffffffffu, ok0) && lane == 0) f0[i0 / SC_BM] = 1;  // the same value from
    if (__any_sync(0xffffffffu, ok1) && lane == 0) f1[i0 / SC_BM] = 1;  // up to four warps
  }
  const float ms = block_sum(s0, red);  // counts: exact in any order
  const float ns = block_sum(s1, red);
  const float nrm = -logf(ms + ns);
  const float b = bin[0];
  float* out = cpl + (size_t)c * K1 * K1;
  float* mu = log_mu + (size_t)c * K1;
  float* nu = log_nu + (size_t)c * K1;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const bool ok0 = v0[i] > 0.5f, ok1 = v1[i] > 0.5f;
    mu[i] = ok0 ? nrm : kNeg;
    nu[i] = ok1 ? nrm : kNeg;
    out[i * K1 + K] = ok0 ? b : kNeg;
    out[K * K1 + i] = ok1 ? b : kNeg;
  }
  if (threadIdx.x == 0) {
    mu[K] = logf(ns) + nrm;
    nu[K] = logf(ms) + nrm;
    out[K * K1 + K] = b;
    norm[c] = nrm;
  }
}

// ---- (b) Sinkhorn
// Online log-sum-exp of one lane: (m, s) with s = sum exp(x - m).
__device__ __forceinline__ void lse_push(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

// u[i] = log_mu[i] - lse_j(cpl[i, j] + v[j]): one warp a row.
__global__ void __launch_bounds__(kThreads)
sg_sinkhorn_rows_kernel(const float* __restrict__ cpl, const float* __restrict__ log_mu,
                        const float* __restrict__ v, float* __restrict__ u, int K1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, row = blockIdx.x * kWarps + warp;
  if (row >= K1) return;  // whole warps leave; no block barrier follows
  const float* r = cpl + ((size_t)c * K1 + row) * K1;
  const float* vc = v + (size_t)c * K1;
  float m = -INFINITY, s = 0.f;
  for (int j = lane; j < K1; j += 32) lse_push(r[j] + vc[j], m, s);
  const float mx = warp_max(m);
  s = warp_sum(m == -INFINITY ? 0.f : s * expf(m - mx));
  if (lane == 0) u[(size_t)c * K1 + row] = log_mu[(size_t)c * K1 + row] - (mx + logf(s));
}

// v[j] = log_nu[j] - lse_i(cpl[i, j] + u[i]): 32 columns a block, the rows
// split over its 8 warps, partials merged through shared memory.
__global__ void __launch_bounds__(kThreads)
sg_sinkhorn_cols_kernel(const float* __restrict__ cpl, const float* __restrict__ log_nu,
                        const float* __restrict__ u, float* __restrict__ v, int K1) {
  __shared__ float pm[kWarps][33], ps[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, col = blockIdx.x * 32 + lane;
  const float* base = cpl + (size_t)c * K1 * K1;
  const float* uc = u + (size_t)c * K1;
  float m = -INFINITY, s = 0.f;
  if (col < K1)
    for (int i = warp; i < K1; i += kWarps) lse_push(base[(size_t)i * K1 + col] + uc[i], m, s);
  pm[warp][lane] = m;
  ps[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= K1) return;
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, pm[w][lane]);
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    tot += pm[w][lane] == -INFINITY ? 0.f : ps[w][lane] * expf(pm[w][lane] - mx);
  v[(size_t)c * K1 + col] = log_nu[(size_t)c * K1 + col] - (mx + logf(tot));
}

// Z = cpl + u + v - norm over the whole (C, K1, K1) tensor.
__global__ void __launch_bounds__(kThreads)
sg_assign_kernel(const float* __restrict__ cpl, const float* __restrict__ u,
                 const float* __restrict__ v, const float* __restrict__ norm,
                 float* __restrict__ Z, int C, int K1) {
  const size_t per = (size_t)K1 * K1, total = per * C;
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const size_t c = e / per, ij = e % per, i = ij / K1, j = ij % K1;
    Z[e] = cpl[e] + u[c * K1 + i] + v[c * K1 + j] - norm[c];
  }
}

// ---- (c) mutual-max matches
// First argmax of each column of Z over the live block; 32 columns a block,
// the rows split over its 8 warps.
__global__ void __launch_bounds__(kThreads)
sg_colarg_kernel(const float* __restrict__ Z, const float* __restrict__ mask0,
                 const float* __restrict__ mask1, int* __restrict__ colarg, int K) {
  __shared__ float pm[kWarps][33];
  __shared__ int pa[kWarps][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, col = blockIdx.x * 32 + lane;
  const size_t K1 = (size_t)K + 1;
  const float* zc = Z + (size_t)c * K1 * K1;
  const float* v0 = mask0 + (size_t)c * K;
  const bool col_ok = col < K && mask1[(size_t)c * K + col] > 0.5f;
  float best = kDead;
  int arg = K;  // past every row: loses every tie below
  if (col_ok)
    for (int i = warp; i < K; i += kWarps)
      if (v0[i] > 0.5f && zc[i * K1 + col] > best) {  // strict: the first maximum
        best = zc[i * K1 + col];
        arg = i;
      }
  pm[warp][lane] = best;
  pa[warp][lane] = arg;
  __syncthreads();
  if (warp != 0 || col >= K) return;
  for (int w = 1; w < kWarps; ++w)
    if (pm[w][lane] > best || (pm[w][lane] == best && pa[w][lane] < arg)) {
      best = pm[w][lane];
      arg = pa[w][lane];
    }
  colarg[(size_t)c * K + col] = arg;
}

// One warp a row: its row max and first argmax over the live block; the row
// is a mutual match when that column's first argmax is the row.
__global__ void __launch_bounds__(kThreads)
sg_rowmatch_kernel(const float* __restrict__ Z, const float* __restrict__ mask0,
                   const float* __restrict__ mask1, const int* __restrict__ colarg,
                   int* __restrict__ matches, float* __restrict__ mscores, int K,
                   float threshold) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y, row = blockIdx.x * kWarps + warp;
  if (row >= K) return;
  const size_t K1 = (size_t)K + 1;
  const float* zr = Z + ((size_t)c * K1 + row) * K1;
  const float* v1 = mask1 + (size_t)c * K;
  const bool row_ok = mask0[(size_t)c * K + row] > 0.5f;
  float best = kDead;
  int arg = K;  // past every column: loses every tie below
  if (row_ok)
    for (int j = lane; j < K; j += 32)
      if (v1[j] > 0.5f && zr[j] > best) {  // strict: a lane keeps its first maximum
        best = zr[j];
        arg = j;
      }
  const float rowmax = warp_max(best);
  int idx = best == rowmax ? arg : K;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) idx = min(idx, __shfl_xor_sync(0xffffffffu, idx, o));
  if (lane != 0) return;
  // idx == K: no live cell in the row, so no match
  const bool mutual = idx < K && colarg[(size_t)c * K + idx] == row;
  const float score = mutual ? expf(rowmax) : 0.f;
  const bool ok = mutual && score > threshold;
  matches[(size_t)c * K + row] = ok ? idx : -1;
  mscores[(size_t)c * K + row] = ok ? score : 0.f;
}

int blocks_for(size_t n) {
  return (int)(n < (size_t)132 * 64 * kThreads ? (n + kThreads - 1) / kThreads
                                               : (size_t)132 * 64);
}

}  // namespace

// Ints of the scores' scratch (tile flags, tile list, live count) for C
// pairs of K keypoints (ops/kernels.py sg_scores_scratch holds the same).
PD_API int pd_sg_scores_scratch(int C, int K) {
  return (int)(2LL * C * sc_tiles_1d(K) + sc_tiles(C, K) + 1);
}

// scratch: pd_sg_scores_scratch(C, K) ints
PD_API int pd_sg_coupling(const void* m, const void* mask0, const void* mask1,
                          const void* bin, void* cpl, void* log_mu, void* log_nu,
                          void* norm, void* scratch, int C, int K, int D, float sqrt_d,
                          void* stream) {
  if (C < 1 || K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (sc_tiles(C, K) * ((D + SC_BK - 1) / SC_BK + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  static const cudaError_t attr = cudaFuncSetAttribute(
      sg_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SC_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;  // persistent: one block an SM (the ring takes the shared memory)
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int* flags = (int*)scratch;
  int* list = flags + 2LL * C * sc_tiles_1d(K);
  sg_marginals_kernel<<<C, kThreads, 0, s>>>(
      (const float*)mask0, (const float*)mask1, (const float*)bin, (float*)cpl,
      (float*)log_mu, (float*)log_nu, (float*)norm, flags, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sg_tiles_kernel<<<1, SC_LIST_THREADS, 0, s>>>(flags, list, C, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = sc_tiles(C, K);
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  sg_scores_kernel<<<(int)(tiles < sms ? tiles : sms), kThreads, SC_SMEM, s>>>(
      (const float*)m, (const float*)mask0, (const float*)mask1, list, (float*)cpl, C, K, D,
      sqrt_d, vec);
  return (int)cudaGetLastError();
}

// v must hold the starting column potentials (zeros); u is scratch.
PD_API int pd_sg_sinkhorn(const void* cpl, const void* log_mu, const void* log_nu,
                          const void* norm, void* u, void* v, void* Z, int C,
                          int K1, int iters, void* stream) {
  if (C < 1 || K1 < 2 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 rows((K1 + kWarps - 1) / kWarps, C), cols((K1 + 31) / 32, C);
  for (int it = 0; it < iters; ++it) {
    sg_sinkhorn_rows_kernel<<<rows, kThreads, 0, s>>>(
        (const float*)cpl, (const float*)log_mu, (const float*)v, (float*)u, K1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sg_sinkhorn_cols_kernel<<<cols, kThreads, 0, s>>>(
        (const float*)cpl, (const float*)log_nu, (const float*)u, (float*)v, K1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sg_assign_kernel<<<blocks_for((size_t)C * K1 * K1), kThreads, 0, s>>>(
      (const float*)cpl, (const float*)u, (const float*)v, (const float*)norm,
      (float*)Z, C, K1);
  return (int)cudaGetLastError();
}

// colarg is (C, K) int32 scratch.
PD_API int pd_sg_matches(const void* Z, const void* mask0, const void* mask1,
                         void* colarg, void* matches, void* mscores, int C, int K,
                         float threshold, void* stream) {
  if (C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  sg_colarg_kernel<<<dim3((K + 31) / 32, C), kThreads, 0, s>>>(
      (const float*)Z, (const float*)mask0, (const float*)mask1, (int*)colarg, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sg_rowmatch_kernel<<<dim3((K + kWarps - 1) / kWarps, C), kThreads, 0, s>>>(
      (const float*)Z, (const float*)mask0, (const float*)mask1,
      (const int*)colarg, (int*)matches, (float*)mscores, K, threshold);
  return (int)cudaGetLastError();
}
