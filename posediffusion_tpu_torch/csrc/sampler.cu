// The fused DDPM sampler's fold-ins: the layer-0 prologue that starts a
// reverse step and the head-MLP epilogue that ends it, as ONE thread-block
// cluster kernel with three entries.
//
// Replaces the l == 0 and l == L-1 branches of
//   posediffusion_tpu/ops/sampler_kernel.py    _sampler_kernel
// where step r's epilogue and step r+1's prologue are consecutive iterations
// of one (steps x layers) grid; the trunk layers in between run in linear.cu
// and attention.cu.
//
// sampler_step_kernel's modes:
//   prologue  h = sin(xE) W_sin + cos(xE) W_cos + x W_x + zf + tc[step],
//             x the (rows, T) pose state, (xE)[d*F + f] = x[d] * 2^f the
//             dim-major, frequency-minor harmonic argument of the 702-wide
//             token [sin | cos | x | t_emb | z | pivot]; the t_emb and z
//             columns arrive already projected as tc (per step) and zf
//             (per row);
//   epilogue  eps = relu(LN(h W0 + b0)) W1 + b1 (the head MLP), then the
//             posterior update in place: x <- cx[step] x - ce[step] eps +
//             noise[step] (noise already scaled by sigma, 0 at t = 0);
//   boundary  the epilogue at step, then the prologue at step + 1 on the
//             new x, in the same launch: x in place, the next h out. The
//             host loop launches it between every two steps (41 launches a
//             step at L = 8 instead of 42).
//
// The cluster's split (SC blocks of 512 threads, 16 where the card
// schedules such a cluster, else 8: kernels.sampler_cluster_size; block c;
// KS = D / SC, HS = HID / SC: 32 and 8 at the model's D 512, HID 128 and
// SC 16; T = 9):
//   epilogue  block c multiplies its K slice h[:, KS c .. +KS) by W0's rows
//             [KS c, +KS) (all HID columns, a 4 x 4 register tile a thread)
//             and stores each 4-column group of that partial into slot c
//             of the block that owns the columns (block c owns hidden
//             columns [HS c, +HS)), through distributed shared memory;
//             -- cluster barrier 1 -- the owner sums its SC slots (four
//             running sums over the ranks, joined in one order) and stores
//             the sums into every block's copy of the (rows x HID) hidden
//             layer; -- barrier 2 -- in every block a half-warp a row adds
//             b0, takes the row's LayerNorm (centred two-pass, eps as
//             given), ReLU and the product with W1 (rows padded to 12
//             floats: three float4 a row), so every block computes the
//             identical new x; block 0 writes it;
//   prologue  block c computes all rows' 2 T F + T features (sin, cos, x;
//             a thread a (row, dim, half of the frequencies)) into shared
//             memory, feature-major, multiplies them by its column slice
//             [KS c, +KS) of [W_sin; W_cos; W_x] (4 x 4 register tiles, the
//             PW rows of the product split into up to KPP ranges summed in
//             order), adds zf and tc and writes those columns of h.
// Rows go in tiles of SR = 32 (the unit of the two barriers; a boundary
// launch adds a third between tiles, since the prologue's partials share
// the slots' memory), so any row count runs in one launch.
//
// Shared memory, in floats, each region rounded up to 128 bytes
// (SAMPLER_REGIONS, in this order; sampler_smem_bytes and
// ops/kernels.sampler_smem_bytes): W0's slice KS x HID | the prologue's
// weight slice, W_sin's and W_cos's T F x KS and W_x's T x KS (PW = 2 T F
// + T rows in all) | h's slice SR x KS | the features
// PW x SR | the slots (SC x SR x HS) or the prologue's partials (KPP x SR x
// KS) | the hidden layer SR x (HID + 16) | zf's slice SR x KS | tc's slice
// KS | x and the step's noise, SR x T each | b0, gh, bh (HID each), W1
// (HID rows of 12), b1 (T) | the two mbarriers. 126,336 bytes at the
// model's widths and SC 16, 199,808 at SC 8: one block an SM.
//
// Copies: the weights once a launch, issued by one thread, completing on
// two mbarriers: W0's slice and the head's vectors as bulk copies, the
// prologue's weight slice as three TMA boxes (KS columns of all rows of
// W_sin, W_cos and W_x; the maps are encoded once per weight address) and
// tc's slice; every weight element of the products is read from device
// memory once a launch across the cluster. Nothing waits for the
// prologue's weights before the prologue, so in a boundary launch they
// land while the epilogue runs. Each tile's slices of h and zf come by
// 16-byte cp.async copies, x, the noise, W1 and b1 by 4-byte ones. The
// weights, h, zf and tc must start on 16-byte boundaries (the wrapper
// raises otherwise).
//
// Order: every sum runs in one fixed order (k ascending inside a range,
// ranges and ranks in order, shuffle butterflies) and nothing is atomic,
// so repeated launches agree bitwise. sin and cos at full precision
// (sincosf, no fast math): the arguments reach x 2^9 and the chain
// multiplies errors by up to 2^9 a step.
//
// Bound: bytes plus the launch latency. A boundary launch moves the weights
// (0.26 MB of W0, W1 and 0.39 MB of the prologue's), h in and out (rows x
// D each), zf and x: 0.75 MB at 20 rows, 0.22 us at 3.35 TB/s, under the
// microseconds of a cluster launch, its copies' latency and its two
// barriers. Its 3.3 M FMAs at 20 rows spread over 16 SMs take under a
// microsecond at the FMA rate.
#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace cg = cooperative_groups;

constexpr int SR = 32;     // rows of a tile
constexpr int ST = 512;    // threads of a block
constexpr int KPP = 6;     // ranges of the prologue's product
constexpr int TD = 9;      // the pose state's width (absT_quaR_logFL)
constexpr int W1P = 12;    // a row of W1 in shared memory, padded to three float4
constexpr int HPL = 8;     // hidden columns a lane holds (HID <= 16 HPL)
constexpr size_t kSamplerMaxSmem = 232448;
enum { MODE_PROLOGUE = 0, MODE_EPILOGUE = 1, MODE_BOUNDARY = 2 };

// a region's floats rounded up to 128 bytes (TMA's shared-memory alignment)
__host__ __device__ constexpr int r32(int n) { return (n + 31) & ~31; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The shared-memory regions in layout order, in floats.
#define SAMPLER_REGIONS(KS, HID, TD, HH, PW)                                         \
  {(KS) * (HID), (HH) * (KS), (HH) * (KS), (TD) * (KS), SR * (KS), (PW) * SR,          \
   imax(SR * (HID), KPP * SR * (KS)), SR * ((HID) + 16), SR * (KS), (KS),              \
   SR * (TD), SR * (TD), 3 * (HID) + (HID) * W1P + (TD), 8}
constexpr int kRegions = 14;

static size_t sampler_smem_bytes(int SC, int D, int HID, int td, int NH) {
  const int KS = D / SC, HH = td * NH, PW = 2 * HH + td;
  const int n[kRegions] = SAMPLER_REGIONS(KS, HID, td, HH, PW);
  size_t floats = 0;
  for (int i = 0; i < kRegions; ++i) floats += r32(n[i]);
  return 4 * floats;
}

struct StepArgs {
  const float *h_in, *w0, *b0, *gh, *bh, *w1, *b1, *coef, *noise;  // epilogue
  const float *zf, *tc;                                             // prologue
  float *x, *h_out;
  int rows, D, HID, NH, step, mode;
  float eps;
};

// The two halves of a cluster barrier (see ggs.cu): arrive.release and
// wait.acquire order this block's shared-memory stores before the other
// blocks' reads after the barrier.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global to this block's shared memory,
// both 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// rows [r0, r0 + 4) x columns [j, j + 4) of A (row stride lda, k-major
// float4 reads at k) times B (row stride ldb): acc += A[:, k0:k1] B[k0:k1, :],
// k in order; k0 and k1 multiples of 4
__device__ __forceinline__ void tile_rows(float (&acc)[4][4], const float* a, int lda,
                                          const float* b, int ldb, int k0, int k1) {
  for (int k = k0; k < k1; k += 4) {
    float4 w[4], h[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = *reinterpret_cast<const float4*>(b + (k + u) * ldb);
      h[u] = *reinterpret_cast<const float4*>(a + u * lda + k);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float hv[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[u][0] = fmaf(hv[kk], w[kk].x, acc[u][0]);
        acc[u][1] = fmaf(hv[kk], w[kk].y, acc[u][1]);
        acc[u][2] = fmaf(hv[kk], w[kk].z, acc[u][2]);
        acc[u][3] = fmaf(hv[kk], w[kk].w, acc[u][3]);
      }
    }
  }
}

// this block's (c) partial of 4 x 4 tile tl (rows 4 (tl / ncg), columns
// 4 (tl % ncg)) of the hidden layer into slot c of the block that owns its
// columns (distributed shared memory)
__device__ __forceinline__ void push_tile(cg::cluster_group& cluster, const float (&acc)[4][4],
                                          float* slots, int tl, int ncg, int nr, int HS, int c) {
  const int r0 = 4 * (tl / ncg), j = 4 * (tl % ncg);
  float* dst = cluster.map_shared_rank(slots, j / HS) + c * SR * HS + j % HS;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (r0 + u < nr)
      *reinterpret_cast<float4*>(dst + (r0 + u) * HS) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

__device__ __forceinline__ float sum16(float v) {  // over the 16 lanes of a half-warp
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int SC>
__global__ void __launch_bounds__(ST) sampler_step_kernel(
    const StepArgs A, const __grid_constant__ CUtensorMap tm_sin,
    const __grid_constant__ CUtensorMap tm_cos, const __grid_constant__ CUtensorMap tm_x) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int D = A.D, HID = A.HID, NH = A.NH;
  const int KS = D / SC, HS = HID / SC, HH = TD * NH, PW = 2 * HH + TD, HP = HID + 16;
  const bool epi = A.mode != MODE_PROLOGUE, pro = A.mode != MODE_EPILOGUE;
  const int pstep = A.mode == MODE_BOUNDARY ? A.step + 1 : A.step;

  extern __shared__ __align__(128) float smem[];
  float* reg[kRegions];
  {
    const int n[kRegions] = SAMPLER_REGIONS(KS, HID, TD, HH, PW);
    float* p = smem;
#pragma unroll
    for (int i = 0; i < kRegions; ++i) {
      reg[i] = p;
      p += r32(n[i]);
    }
  }
  // the prologue's weights in three regions, W_sin's, W_cos's and W_x's
  // rows, each a TMA box's destination on 128 bytes
  float *w0s = reg[0], *wsin_s = reg[1], *wcos_s = reg[2], *wx_s = reg[3], *hs = reg[4],
        *feat = reg[5];
  float *scr = reg[6], *hid = reg[7], *zfs = reg[8], *tcs = reg[9], *xs = reg[10], *ns = reg[11];
  float *b0s = reg[12], *ghs = b0s + HID, *bhs = ghs + HID, *w1s = bhs + HID,
        *b1s = w1s + HID * W1P;
  uint64_t* bars = reinterpret_cast<uint64_t*>(reg[13]);  // the head's weights, the prologue's
  uint64_t *bar_w0 = bars, *bar_wp = bars + 1;

  if (tid == 0) {
    mbar_init(bar_w0, 1);
    mbar_init(bar_wp, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the first store into another block's shared memory waits for it to start
  if (epi) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // ---- the weights, once a launch, by one thread: W0's rows [KS c, +KS)
  // and the head's vectors (bulk copies); the prologue's columns [KS c,
  // +KS) of W_sin, W_cos and W_x (three TMA boxes) and tc's
  if (tid == 0) {
    if (epi) {
      mbar_expect_tx(bar_w0, 4 * (KS * HID + 3 * HID));
      bulk_load(w0s, A.w0 + (size_t)KS * c * HID, 4 * KS * HID, bar_w0);
      bulk_load(b0s, A.b0, 4 * HID, bar_w0);
      bulk_load(ghs, A.gh, 4 * HID, bar_w0);
      bulk_load(bhs, A.bh, 4 * HID, bar_w0);
    }
    if (pro) {
      mbar_expect_tx(bar_wp, 4 * (PW * KS + KS));
      tma_load_2d(wsin_s, &tm_sin, KS * c, 0, bar_wp);
      tma_load_2d(wcos_s, &tm_cos, KS * c, 0, bar_wp);
      tma_load_2d(wx_s, &tm_x, KS * c, 0, bar_wp);
      bulk_load(tcs, A.tc + (size_t)pstep * D + KS * c, 4 * KS, bar_wp);
    }
  }
  float cx = 0.f, ce = 0.f;
  if (epi) {
    cx = A.coef[2 * A.step];
    ce = A.coef[2 * A.step + 1];
    for (int o = tid; o < TD; o += ST) cp_async4(b1s + o, A.b1 + o, true);
    for (int i = tid; i < HID * TD; i += ST) cp_async4(w1s + i / TD * W1P + i % TD, A.w1 + i, true);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }

  for (int t0 = 0; t0 < A.rows; t0 += SR) {
    const int nr = min(SR, A.rows - t0), q4 = KS / 4;
    // ---- this tile's x, noise and slice of h (group 0; the first also
    // W1 and b1) and slice of zf (group 1)
    for (int i = tid; i < nr * TD; i += ST) {
      cp_async4(xs + i, A.x + (size_t)t0 * TD + i, true);
      if (epi) cp_async4(ns + i, A.noise + ((size_t)A.step * A.rows + t0) * TD + i, true);
    }
    if (epi)
      for (int i = tid; i < nr * q4; i += ST)
        cp_async16(hs + 4 * i, A.h_in + (size_t)(t0 + i / q4) * D + KS * c + 4 * (i % q4), true);
    cp_async_commit();
    if (pro)
      for (int i = tid; i < nr * q4; i += ST)
        cp_async16(zfs + 4 * i, A.zf + (size_t)(t0 + i / q4) * D + KS * c + 4 * (i % q4), true);
    cp_async_commit();
    cp_async_wait<1>();

    if (epi) {
      // ---- the (rows x HID) partial h W0 over this block's K slice, a 4 x
      // 4 tile a thread, k in order, into the owners' slots
      mbar_wait(bar_w0, 0);
      __syncthreads();
      const int ncg = HID / 4;
      for (int tl = tid; tl < (nr + 3) / 4 * ncg; tl += ST) {
        float acc[4][4] = {};  // rows past nr: computed, never stored
        tile_rows(acc, hs + 4 * (tl / ncg) * KS, KS, w0s + 4 * (tl % ncg), HID, 0, KS);
        push_tile(cluster, acc, scr, tl, ncg, nr, HS, c);
      }
      cluster_sync_all();  // 1: every partial is in its owner

      // ---- the owned columns: the SC slots (four running sums over the
      // ranks, joined in one order), into every block
      for (int i = tid; i < nr * (HS / 4); i += ST) {
        const int r = i / (HS / 4), jj = 4 * (i % (HS / 4));
        float4 v[4];  // v[u] sums the slots of ranks u, u + 4, ...
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(scr + (u * SR + r) * HS + jj);
        for (int q = 4; q < SC; q += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = add4(v[u], *reinterpret_cast<const float4*>(scr + ((q + u) * SR + r) * HS + jj));
        }
        const float4 sum = add4(add4(v[0], v[1]), add4(v[2], v[3]));
        for (int q = 0; q < SC; ++q)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(hid, q) + r * HP + HS * c + jj) = sum;
      }
      cluster_sync_all();  // 2: every block holds the whole hidden layer

      // ---- a half-warp a row: + b0, LayerNorm, ReLU, eps = g W1 + b1 and
      // the update, every sum in one order (columns in order in a lane,
      // then a butterfly)
      {
        const int r = min(tid >> 4, nr - 1), l = tid & 15;
        const float* g = hid + r * HP;  // the rows past nr repeat row nr - 1, unstored
        float a[HPL];
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < HPL; ++i) {
          const int j = l + 16 * i;
          a[i] = j < HID ? g[j] + b0s[j] : 0.f;
          sum += a[i];
        }
        const float mean = sum16(sum) / (float)HID;
        float m2 = 0.f;
#pragma unroll
        for (int i = 0; i < HPL; ++i)
          if (l + 16 * i < HID) m2 = fmaf(a[i] - mean, a[i] - mean, m2);
        const float rstd = rsqrtf(sum16(m2) / (float)HID + A.eps);
        float e[TD] = {};
#pragma unroll
        for (int i = 0; i < HPL; ++i) {
          const int j = l + 16 * i;
          if (j < HID) {
            const float gv = fmaxf((a[i] - mean) * rstd * ghs[j] + bhs[j], 0.f);
            const float4 w0 = *reinterpret_cast<const float4*>(w1s + j * W1P);
            const float4 w1 = *reinterpret_cast<const float4*>(w1s + j * W1P + 4);
            const float w8 = w1s[j * W1P + 8];
            e[0] = fmaf(gv, w0.x, e[0]);
            e[1] = fmaf(gv, w0.y, e[1]);
            e[2] = fmaf(gv, w0.z, e[2]);
            e[3] = fmaf(gv, w0.w, e[3]);
            e[4] = fmaf(gv, w1.x, e[4]);
            e[5] = fmaf(gv, w1.y, e[5]);
            e[6] = fmaf(gv, w1.z, e[6]);
            e[7] = fmaf(gv, w1.w, e[7]);
            e[8] = fmaf(gv, w8, e[8]);
          }
        }
        float ev = 0.f;
#pragma unroll
        for (int o = 0; o < TD; ++o) {
          const float t = sum16(e[o]);
          if (o == l) ev = t;
        }
        if ((tid >> 4) < nr && l < TD) {
          const int i = r * TD + l;
          const float xn = cx * xs[i] - ce * (ev + b1s[l]) + ns[i];
          xs[i] = xn;
          if (c == 0) A.x[(size_t)t0 * TD + i] = xn;
        }
      }
    }
    __syncthreads();  // x (new in a boundary launch) is in xs

    if (pro) {
      // ---- the features, feature-major: a thread a (row, dim, half of the
      // frequencies), x * 2^f (exact)
      const int fh = (NH + 1) / 2;
      for (int i = tid; i < nr * TD * 2; i += ST) {
        const int r = i % nr, d = (i / nr) % TD, f0 = (i / (nr * TD)) * fh;
        const float xv = xs[r * TD + d];
#pragma unroll 4
        for (int f = f0; f < min(f0 + fh, NH); ++f) {
          float sv, cv;
          sincosf(xv * (float)(1u << f), &sv, &cv);
          feat[(d * NH + f) * SR + r] = sv;
          feat[(HH + d * NH + f) * SR + r] = cv;
        }
        if (f0 == 0) feat[(2 * HH + d) * SR + r] = xv;
      }
      cp_async_wait<0>();
      mbar_wait(bar_wp, 0);
      __syncthreads();
      // ---- their product with this block's columns: 4 x 4 tiles, the PW
      // rows split into kp ranges, each range's partial into scr
      const int ncg = KS / 4, tiles = (nr + 3) / 4 * ncg;
      const int kp = max(1, min(KPP, ST / tiles));
      for (int it = tid; it < tiles * kp; it += ST) {
        const int p = it / tiles, tl = it % tiles;
        const int r0 = 4 * (tl / ncg), j = 4 * (tl % ncg);
        float acc[4][4] = {};
        const int k1 = (p + 1) * PW / kp;
        for (int k = p * PW / kp; k < k1;) {  // the range's rows of W_sin, W_cos, W_x
          const int seg = k < HH ? 0 : k < 2 * HH ? 1 : 2, end = min(k1, (seg + 1) * HH);
          const float* w = (seg == 0 ? wsin_s : seg == 1 ? wcos_s : wx_s) + (k - seg * HH) * KS + j;
#pragma unroll 4
          for (; k < end; ++k, w += KS) {
            const float4 f = *reinterpret_cast<const float4*>(feat + k * SR + r0);
            const float4 wv = *reinterpret_cast<const float4*>(w);
            const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[u][0] = fmaf(fv[u], wv.x, acc[u][0]);
              acc[u][1] = fmaf(fv[u], wv.y, acc[u][1]);
              acc[u][2] = fmaf(fv[u], wv.z, acc[u][2]);
              acc[u][3] = fmaf(fv[u], wv.w, acc[u][3]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<float4*>(scr + (p * SR + r0 + u) * KS + j) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
      __syncthreads();
      // ---- the ranges in order, + zf + tc, to h
      for (int i = tid; i < nr * ncg; i += ST) {
        const int r = i / ncg, j = 4 * (i % ncg);
        float4 v = *reinterpret_cast<const float4*>(scr + r * KS + j);
        for (int p = 1; p < kp; ++p)
          v = add4(v, *reinterpret_cast<const float4*>(scr + (p * SR + r) * KS + j));
        v = add4(add4(v, *reinterpret_cast<const float4*>(zfs + r * KS + j)),
                 *reinterpret_cast<const float4*>(tcs + j));
        *reinterpret_cast<float4*>(A.h_out + (size_t)(t0 + r) * D + KS * c + j) = v;
      }
    }
    __syncthreads();  // the next tile overwrites the slices, x and scr
    // another block's next partials land in scr: wait for every block's
    // prologue to have read it
    if (epi && pro && t0 + SR < A.rows) cluster_sync_all();
  }
}

// W_sin's, W_cos's or W_x's map for boxes of box_cols columns x all rows,
// encoded once per (address, shape, box) and kept: the map holds these and
// not the data, so a kept one is exact for any weight at that address. At
// most 1,024 are kept; past that the table starts again.
static bool weight_map(CUtensorMap* map, const float* w, int rows, int cols, int box_cols) {
  using Key = std::tuple<const void*, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> kept;
  const Key key{w, rows, cols, box_cols};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *map = it->second;
    return true;
  }
  if (!tmap_2d(map, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows, cols, rows, box_cols,
               CU_TENSOR_MAP_SWIZZLE_NONE))
    return false;
  if (kept.size() >= 1024) kept.clear();
  kept.emplace(key, *map);
  return true;
}

// The launch of one cluster of SC blocks: the kernel's attributes set once,
// the configuration and its cluster attribute filled.
template <int SC>
static cudaError_t sampler_config(int D, int HID, int NH, cudaStream_t stream,
                                  cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = sampler_smem_bytes(SC, D, HID, TD, NH);
  if (smem > kSamplerMaxSmem) return cudaErrorInvalidValue;
  static size_t allowed = 0;  // raised once: the sampler calls this 100 times an inference
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(sampler_step_kernel<SC>,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(sampler_step_kernel<SC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(SC);
  cfg->blockDim = dim3(ST);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The widths a mode reads (HID 0 for the prologue, which reads no head, NH
// 0 for the epilogue, which computes no features), or -1 where the kernel
// does not take them: a cluster of 8 or 16, D and HID multiples of 4 SC
// (HID of 16 too) up to 16 HPL, T of 9, F at most 24 (T F rows a TMA box).
static int sampler_widths(int SC, int mode, int* HID, int td, int* NH, int D) {
  if (SC != 8 && SC != 16) return -1;
  if (mode == MODE_PROLOGUE) *HID = 0;
  if (mode == MODE_EPILOGUE) *NH = 0;
  if (D < 4 * SC || D % (4 * SC) || *HID % (4 * SC) || *HID % 16 || *HID > 16 * HPL ||
      td != TD || (mode != MODE_PROLOGUE && *HID < 4 * SC) ||
      (mode != MODE_EPILOGUE && (*NH < 1 || *NH > 24)))
    return -1;
  return 0;
}

// One entry for the three modes; the pointers a mode does not read may be
// null (the prologue's h_in and head, the epilogue's prologue weights and
// h_out). x is updated in place by the epilogue and boundary modes.
// cudaErrorInvalidValue for a cluster or widths the kernel does not take.
PD_API int pd_sampler_step(const void* h_in, const void* w0, const void* b0,
                           const void* gh, const void* bh, const void* w1,
                           const void* b1, const void* coef, const void* noise,
                           const void* wsin, const void* wcos, const void* wx,
                           const void* zf, const void* tc, void* x, void* h_out,
                           int rows, int D, int HID, int td, int NH, int step,
                           int mode, float eps, int cluster, void* stream) {
  if (rows < 1 || mode < MODE_PROLOGUE || mode > MODE_BOUNDARY ||
      sampler_widths(cluster, mode, &HID, td, &NH, D) != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster == 16
                        ? sampler_config<16>(D, HID, NH, (cudaStream_t)stream, &cfg, attr)
                        : sampler_config<8>(D, HID, NH, (cudaStream_t)stream, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_sin{}, tm_cos{}, tm_x{};
  if (mode != MODE_EPILOGUE) {
    const int HH = TD * NH, KS = D / cluster;
    if (!weight_map(&tm_sin, (const float*)wsin, HH, D, KS) ||
        !weight_map(&tm_cos, (const float*)wcos, HH, D, KS) ||
        !weight_map(&tm_x, (const float*)wx, TD, D, KS))
      return (int)cudaErrorInvalidValue;
  }
  StepArgs A;
  A.h_in = (const float*)h_in;
  A.w0 = (const float*)w0;
  A.b0 = (const float*)b0;
  A.gh = (const float*)gh;
  A.bh = (const float*)bh;
  A.w1 = (const float*)w1;
  A.b1 = (const float*)b1;
  A.coef = (const float*)coef;
  A.noise = (const float*)noise;
  A.zf = (const float*)zf;
  A.tc = (const float*)tc;
  A.x = (float*)x;
  A.h_out = (float*)h_out;
  A.rows = rows;
  A.D = D;
  A.HID = HID;
  A.NH = NH;
  A.step = step;
  A.mode = mode;
  A.eps = eps;
  err = cluster == 16
            ? cudaLaunchKernelEx(&cfg, sampler_step_kernel<16>, A, tm_sin, tm_cos, tm_x)
            : cudaLaunchKernelEx(&cfg, sampler_step_kernel<8>, A, tm_sin, tm_cos, tm_x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory of a block of a cluster of SC at these widths.
PD_API int pd_sampler_smem_bytes(int SC, int D, int HID, int td, int NH) {
  return (int)sampler_smem_bytes(SC, D, HID, td, NH);
}

// How many clusters of SC blocks at these widths (HID 0 for the prologue,
// NH 0 for the epilogue) the card can hold at once (0: such a cluster
// cannot be scheduled), or minus a CUDA error.
PD_API int pd_sampler_max_active_clusters(int SC, int D, int HID, int td, int NH) {
  const int mode = HID == 0 ? MODE_PROLOGUE : NH == 0 ? MODE_EPILOGUE : MODE_BOUNDARY;
  if (sampler_widths(SC, mode, &HID, td, &NH, D) != 0) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = SC == 16 ? sampler_config<16>(D, HID, NH, 0, &cfg, attr)
                             : sampler_config<8>(D, HID, NH, 0, &cfg, attr);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = SC == 16 ? cudaOccupancyMaxActiveClusters(&n, sampler_step_kernel<16>, &cfg)
                 : cudaOccupancyMaxActiveClusters(&n, sampler_step_kernel<8>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return -(int)err;
  }
  return n;
}
