// One whole GGS SGD phase per launch: Sampson loss gradient, adaptive clip,
// momentum update and sticky stop for all iterations of the phase.
//
// Replaces the TPU kernels
//   posediffusion_tpu/ops/ggs_kernel.py  ggs_phase_fused (_phase_kernel,
//                                        table resident in VMEM)
//   posediffusion_tpu/ops/ggs_kernel.py  ggs_phase_fused_chunked
//                                        (_phase_kernel_chunked, pair chunks
//                                        streamed, unnormalised gradients
//                                        summed)
// whose iteration is ops/ggs_grad.py loss_and_grad_core. The plain version
// is posediffusion_tpu_torch/ops/ggs_grad.loss_and_grad_core in a Python
// loop (ops/ggs_kernel.py ggs_phase_plain / ggs_phase_chunked_plain).
//
// Bound: latency. A phase is 100 or 200 strictly sequential iterations; one
// iteration at 20 frames is 190 pairs x 128 (or 1,024) padded matches, i.e.
// 24,320 (194,560) Sampson residuals and their adjoints, ~100 FLOP each, over
// a 486 KB (3.9 MB) table that stays in the 50 MB L2 across iterations. The
// table never fits one block's 227 KB of shared memory, so it is read from
// global memory (L2) every iteration; everything else of the iteration
// lives in shared memory. Design, per iteration, stage by stage:
//   1. per frame: quaternion -> R, OpenCV flip, focal exp; then the clamped
//      mean focal length and K^-1's a, b, c, d (one warp, fixed order);
//   2. per pair: G = R2 R1^T, t12, Et, E, U = K^-T E, F (thread per pair);
//      the intermediates the backward reuses stay in shared memory;
//   3. per match: Sampson, keep, count and the nine unnormalised dF sums of
//      each pair (a warp owns a pair, its lanes stride the matches, shuffles
//      reduce);
//   4. per pair: the backward to dR1, dR2, dt1, dt2 and the K^-1 partials;
//   5. per frame: gather over its pairs in a fixed order (the pair lists
//      come from the wrapper; no atomics), then the flip, quaternion and
//      focal adjoints and the update-flag masks;
//   6. divide by the global count, adaptive clip, momentum, sticky stop.
// Everything is float32 without fast-math: JAX pins these products to
// Precision.HIGHEST, and the momentum loop amplifies error.
//
// ggs_phase runs one block of 32 warps, which walk all pairs. Stages 3 and
// 4 are per pair, so ggs_phase_chunked spreads them: its cooperative grid
// gives each block a chunk of pairs (4 warps, 4 pairs by default, 48 blocks
// at 20 frames), and each block writes its pairs' backward rows (stage 4's
// output and the match count, 29 floats a pair; the unnormalised sums) to a
// global buffer double-buffered by iteration parity. After grid.sync() every
// block reads all rows, sums them per frame in the same fixed order and
// applies the same update to its own copy of x, so the copies stay
// identical and one barrier per iteration is enough; block 0 writes the
// result. A pair's sums are reduced in the same order in both kernels (one
// warp, lanes striding the matches), so the two give the same x.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {
constexpr float kLogFlBias = 1.8f;
constexpr float kMinFl = 0.1f;
constexpr float kMaxFl = 20.0f;
constexpr int kPF = 36;    // per-pair forward values kept for the backward
constexpr int kPB = 29;    // per-pair backward values
constexpr int kPart = 10;  // nine dF sums and the count, per pair
constexpr int kSc = 16;    // per-iteration scalars
constexpr int kResidentThreads = 1024;
constexpr int kChunkThreads = 128;
// scalar slots
enum { SC_FX, SC_FY, SC_A, SC_B, SC_C, SC_D, SC_COUNT, SC_STOP, SC_DA, SC_DB,
       SC_DC, SC_DD, SC_XNORM2, SC_GNORM2 };
}  // namespace

struct GGSArgs {
  const float *kp1x, *kp1y, *kp2x, *kp2y, *valid;  // (P, Q)
  const int *pi1, *pi2;                            // (P,) frames of a pair
  const int *fptr, *fent;  // per frame: entries 2 p + role in fent[fptr[n]..fptr[n+1])
  int N, P, Q;
  float h, w;
  int upd_R, upd_T, upd_FL;
  float sampson_max;
  int iters;
  float lr, momentum, alpha, min_matches;
};

struct Smem {
  float *x, *buf, *g, *Rcv, *tcv, *efl, *sc, *pf, *part, *pb;
  int *pi1, *pi2, *fptr, *fent;  // copies of the pair tables
};

// Shared memory of a block that computes Pc pairs' forward and reads all
// P pairs' backward rows.
__host__ __device__ inline size_t ggs_smem_floats(int N, int Pc, int P) {
  return (size_t)N * (9 * 3 + 9 + 3 + 2) + kSc + (size_t)Pc * (kPF + kPart) +
         (size_t)P * kPB + (size_t)4 * P + N + 1;
}

__device__ inline Smem carve(float* base, int N, int Pc, int P) {
  Smem S;
  S.x = base;
  S.buf = S.x + N * 9;
  S.g = S.buf + N * 9;
  S.Rcv = S.g + N * 9;
  S.tcv = S.Rcv + N * 9;
  S.efl = S.tcv + N * 3;
  S.sc = S.efl + N * 2;
  S.pf = S.sc + kSc;
  S.part = S.pf + Pc * kPF;
  S.pb = S.part + Pc * kPart;  // P rows, indexed by the global pair
  S.pi1 = (int*)(S.pb + (size_t)P * kPB);
  S.pi2 = S.pi1 + P;
  S.fent = S.pi2 + P;
  S.fptr = S.fent + 2 * P;
  return S;
}

__device__ __forceinline__ float flip_of(int i) { return i < 2 ? -1.f : 1.f; }

// M with R = I + (2 / |q|^2) M, row-major.
__device__ __forceinline__ void quat_M(float qw, float qx, float qy, float qz,
                                       float* M) {
  M[0] = -(qy * qy + qz * qz);
  M[1] = qx * qy - qz * qw;
  M[2] = qx * qz + qy * qw;
  M[3] = qx * qy + qz * qw;
  M[4] = -(qx * qx + qz * qz);
  M[5] = qy * qz - qx * qw;
  M[6] = qx * qz - qy * qw;
  M[7] = qy * qz + qx * qw;
  M[8] = -(qx * qx + qy * qy);
}

// Stages 1-4 for pairs [p0, p0 + Pc): their backward rows into
// S.pb + p * kPB (unnormalised: dR1, dR2, dt1, dt2, K^-1 partials, count).
__device__ void pair_gradients(const GGSArgs& A, const Smem& S, int p0, int Pc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = nt >> 5;
  const int N = A.N, Q = A.Q;

  // ---- 1. per frame
  for (int n = tid; n < N; n += nt) {
    const float* xn = S.x + n * 9;
    const float qw = xn[3], qx = xn[4], qy = xn[5], qz = xn[6];
    const float s = 2.f / (qw * qw + qx * qx + qy * qy + qz * qz);
    float M[9];
    quat_M(qw, qx, qy, qz, M);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float R_ji = (i == j ? 1.f : 0.f) + s * M[3 * j + i];
        S.Rcv[n * 9 + 3 * i + j] = flip_of(i) * R_ji;
      }
    S.tcv[n * 3 + 0] = -xn[0];
    S.tcv[n * 3 + 1] = -xn[1];
    S.tcv[n * 3 + 2] = xn[2];
    S.efl[n * 2 + 0] = expf(xn[7] + kLogFlBias);
    S.efl[n * 2 + 1] = expf(xn[8] + kLogFlBias);
  }
  __syncthreads();
  if (warp == 0) {
    float f0 = 0.f, f1 = 0.f;
    for (int n = lane; n < N; n += 32) {
      f0 += fminf(fmaxf(S.efl[n * 2 + 0], kMinFl), kMaxFl);
      f1 += fminf(fmaxf(S.efl[n * 2 + 1], kMinFl), kMaxFl);
    }
    f0 = warp_sum(f0);
    f1 = warp_sum(f1);
    if (lane == 0) {
      const float s_img = fminf(A.h, A.w) / 2.f;
      const float fx = f0 / (float)N * s_img, fy = f1 / (float)N * s_img;
      S.sc[SC_FX] = fx;
      S.sc[SC_FY] = fy;
      S.sc[SC_A] = 1.f / fx;
      S.sc[SC_B] = 1.f / fy;
      S.sc[SC_C] = -(A.w / 2.f) / fx;
      S.sc[SC_D] = -(A.h / 2.f) / fy;
    }
  }
  __syncthreads();
  const float a = S.sc[SC_A], b = S.sc[SC_B], c = S.sc[SC_C], d = S.sc[SC_D];

  // ---- 2. per pair: forward
  for (int pl = tid; pl < Pc; pl += nt) {
    const int p = p0 + pl;
    const float* r1 = S.Rcv + S.pi1[p] * 9;
    const float* r2 = S.Rcv + S.pi2[p] * 9;
    const float* t1 = S.tcv + S.pi1[p] * 3;
    const float* t2 = S.tcv + S.pi2[p] * 3;
    float G[9], t12[3], Et[3], E[9], U[9], Fm[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        G[3 * i + j] = r2[3 * i] * r1[3 * j] + r2[3 * i + 1] * r1[3 * j + 1] +
                       r2[3 * i + 2] * r1[3 * j + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      t12[i] = t2[i] - (G[3 * i] * t1[0] + G[3 * i + 1] * t1[1] + G[3 * i + 2] * t1[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      Et[k] = -(G[k] * t12[0] + G[3 + k] * t12[1] + G[6 + k] * t12[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      E[3 * i + 0] = G[3 * i + 1] * Et[2] - G[3 * i + 2] * Et[1];
      E[3 * i + 1] = G[3 * i + 2] * Et[0] - G[3 * i + 0] * Et[2];
      E[3 * i + 2] = G[3 * i + 0] * Et[1] - G[3 * i + 1] * Et[0];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      U[j] = a * E[j];
      U[3 + j] = b * E[3 + j];
      U[6 + j] = c * E[j] + d * E[3 + j] + E[6 + j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Fm[3 * i + 0] = a * U[3 * i];
      Fm[3 * i + 1] = b * U[3 * i + 1];
      Fm[3 * i + 2] = c * U[3 * i] + d * U[3 * i + 1] + U[3 * i + 2];
    }
    float* f = S.pf + pl * kPF;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) f[3 * i + j] = Fm[3 * j + i];  // Fu = Fm^T
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f[9 + 2 * i] = U[3 * i];
      f[10 + 2 * i] = U[3 * i + 1];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) f[15 + k] = E[k];  // rows 0 and 1
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f[21 + k] = Et[k];
      f[33 + k] = t12[k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) f[24 + k] = G[k];
  }
  __syncthreads();

  // ---- 3. per match
  {
    for (int pl = warp; pl < Pc; pl += W) {
      const float* F = S.pf + pl * kPF;
      const float F00 = F[0], F01 = F[1], F02 = F[2], F10 = F[3], F11 = F[4],
                  F12 = F[5], F20 = F[6], F21 = F[7], F22 = F[8];
      float acc[kPart];
#pragma unroll
      for (int k = 0; k < kPart; ++k) acc[k] = 0.f;
      const size_t row = (size_t)(p0 + pl) * Q;
#pragma unroll 4
      for (int q = lane; q < Q; q += 32) {
        const float k1x = A.kp1x[row + q], k1y = A.kp1y[row + q];
        const float k2x = A.kp2x[row + q], k2y = A.kp2y[row + q];
        const float v = A.valid[row + q];
        const float l0 = k1x * F00 + k1y * F10 + F20;  // kp1^T F
        const float l1 = k1x * F01 + k1y * F11 + F21;
        const float l2 = k1x * F02 + k1y * F12 + F22;
        const float r0 = F00 * k2x + F01 * k2y + F02;  // F kp2
        const float r1 = F10 * k2x + F11 * k2y + F12;
        const float ev = l0 * k2x + l1 * k2y + l2;
        const float top = ev * ev;
        const float bot_raw = l0 * l0 + l1 * l1 + r0 * r0 + r1 * r1;
        const float bot = fmaxf(bot_raw, 1e-12f);
        const float samp = top / bot;
        const float keep = samp < A.sampson_max ? v : 0.f;
        const float dtop = keep / bot;
        const float dbot = bot_raw > 1e-12f ? -keep * top / (bot * bot) : 0.f;
        const float dev = 2.f * ev * dtop;
        const float dl0 = dev * k2x + 2.f * l0 * dbot;
        const float dl1 = dev * k2y + 2.f * l1 * dbot;
        const float dl2 = dev;
        const float dr0 = 2.f * r0 * dbot, dr1 = 2.f * r1 * dbot;
        acc[0] += k1x * dl0 + dr0 * k2x;
        acc[1] += k1x * dl1 + dr0 * k2y;
        acc[2] += k1x * dl2 + dr0;
        acc[3] += k1y * dl0 + dr1 * k2x;
        acc[4] += k1y * dl1 + dr1 * k2y;
        acc[5] += k1y * dl2 + dr1;
        acc[6] += dl0;
        acc[7] += dl1;
        acc[8] += dl2;
        acc[9] += keep;
      }
#pragma unroll
      for (int k = 0; k < kPart; ++k) acc[k] = warp_sum(acc[k]);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kPart; ++k) S.part[pl * kPart + k] = acc[k];
      }
    }
  }
  __syncthreads();

  // ---- 4. per pair: backward
  for (int pl = tid; pl < Pc; pl += nt) {
    const float* dFu = S.part + pl * kPart;
    const float cnt = dFu[9];
    const float* f = S.pf + pl * kPF;
    const float* Et = f + 21;
    const float* G = f + 24;
    const float* t12 = f + 33;
    const int p = p0 + pl;
    const float* r1 = S.Rcv + S.pi1[p] * 9;
    const float* r2 = S.Rcv + S.pi2[p] * 9;
    const float* t1 = S.tcv + S.pi1[p] * 3;

    // dFm[i][j] = dFu[j][i]; backward F = U Kinv, then U = Kinv^T E
    float dU[9], dE[9];
    float va = 0.f, vb = 0.f, vc = 0.f, vd = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float m0 = dFu[i], m1 = dFu[3 + i], m2 = dFu[6 + i];
      const float Ui0 = f[9 + 2 * i], Ui1 = f[10 + 2 * i];
      dU[3 * i + 0] = a * m0 + c * m2;
      dU[3 * i + 1] = b * m1 + d * m2;
      dU[3 * i + 2] = m2;
      va += Ui0 * m0;
      vb += Ui1 * m1;
      vc += Ui0 * m2;
      vd += Ui1 * m2;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float E0j = f[15 + j], E1j = f[18 + j];
      dE[j] = a * dU[j] + c * dU[6 + j];
      dE[3 + j] = b * dU[3 + j] + d * dU[6 + j];
      dE[6 + j] = dU[6 + j];
      va += E0j * dU[j];
      vb += E1j * dU[3 + j];
      vc += E0j * dU[6 + j];
      vd += E1j * dU[6 + j];
    }
    // backward E_i = G_i x Et
    float dG[9], dEt[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float g0 = dE[3 * i], g1 = dE[3 * i + 1], g2 = dE[3 * i + 2];
      dG[3 * i + 0] = Et[1] * g2 - Et[2] * g1;
      dG[3 * i + 1] = Et[2] * g0 - Et[0] * g2;
      dG[3 * i + 2] = Et[0] * g1 - Et[1] * g0;
      dEt[0] += g1 * G[3 * i + 2] - g2 * G[3 * i + 1];
      dEt[1] += g2 * G[3 * i + 0] - g0 * G[3 * i + 2];
      dEt[2] += g0 * G[3 * i + 1] - g1 * G[3 * i + 0];
    }
    // backward Et_k = -sum_i G[i][k] t12_i
    float dt12[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dG[3 * i + k] -= dEt[k] * t12[i];
        dt12[i] -= G[3 * i + k] * dEt[k];
      }
    // backward t12_i = t2_i - sum_k G[i][k] t1_k
    float dt1[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dG[3 * i + k] -= dt12[i] * t1[k];
        dt1[k] -= G[3 * i + k] * dt12[i];
      }
    // backward G[i][j] = sum_k R2[3i+k] R1[3j+k]
    float dR1[9], dR2[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) dR1[k] = dR2[k] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dR2[3 * i + k] += dG[3 * i + j] * r1[3 * j + k];
          dR1[3 * j + k] += dG[3 * i + j] * r2[3 * i + k];
        }
    float* o = S.pb + (size_t)p * kPB;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      o[k] = dR1[k];
      o[9 + k] = dR2[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[18 + k] = dt1[k];
      o[21 + k] = dt12[k];  // dt2 = dt12
    }
    o[24] = va;
    o[25] = vb;
    o[26] = vc;
    o[27] = vd;
    o[28] = cnt;
  }
  __syncthreads();
}

// Stage 5 from the backward rows of all A.P pairs in S.pb: the summed
// unnormalised gradient into S.g (N x 9) and the count into S.sc[SC_COUNT].
__device__ void frame_gradients(const GGSArgs& A, const Smem& S) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = A.N;
  if (warp == 0) {
    float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int p = lane; p < A.P; p += 32) {
      const float* o = S.pb + (size_t)p * kPB;
#pragma unroll
      for (int k = 0; k < 5; ++k) v[k] += o[24 + k];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = warp_sum(v[k]);
    if (lane == 0) {
      S.sc[SC_DA] = v[0];
      S.sc[SC_DB] = v[1];
      S.sc[SC_DC] = v[2];
      S.sc[SC_DD] = v[3];
      S.sc[SC_COUNT] = v[4];
    }
  }
  __syncthreads();

  // ---- 5. per frame: gather, then the flip, quaternion and focal adjoints
  for (int n = tid; n < N; n += nt) {
    float dRcv[9], dtcv[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) dRcv[k] = 0.f;
    dtcv[0] = dtcv[1] = dtcv[2] = 0.f;
    for (int e = S.fptr[n]; e < S.fptr[n + 1]; ++e) {
      const int ent = S.fent[e], role = ent & 1;
      const float* o = S.pb + (size_t)(ent >> 1) * kPB;
#pragma unroll
      for (int k = 0; k < 9; ++k) dRcv[k] += o[role * 9 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) dtcv[k] += o[18 + role * 3 + k];
    }
    float* gn = S.g + n * 9;
    const float* xn = S.x + n * 9;
    gn[0] = A.upd_T ? -dtcv[0] : 0.f;
    gn[1] = A.upd_T ? -dtcv[1] : 0.f;
    gn[2] = A.upd_T ? dtcv[2] : 0.f;

    if (A.upd_R) {
      const float qw = xn[3], qx = xn[4], qy = xn[5], qz = xn[6];
      const float n2 = qw * qw + qx * qx + qy * qy + qz * qz;
      const float s = 2.f / n2;
      float M[9], dR[9], dM[9];
      quat_M(qw, qx, qy, qz, M);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 3; ++i) dR[3 * j + i] = flip_of(i) * dRcv[3 * i + j];
      float ds = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        ds += dR[k] * M[k];
        dM[k] = s * dR[k];
      }
      const float dn2 = ds * (-2.f / (n2 * n2));
      float dqw = 2.f * qw * dn2, dqx = 2.f * qx * dn2;
      float dqy = 2.f * qy * dn2, dqz = 2.f * qz * dn2;
      dqx += qy * dM[1] + qz * dM[2] + qy * dM[3] - 2.f * qx * dM[4] - qw * dM[5] +
             qz * dM[6] + qw * dM[7] - 2.f * qx * dM[8];
      dqy += -2.f * qy * dM[0] + qx * dM[1] + qw * dM[2] + qx * dM[3] + qz * dM[5] -
             qw * dM[6] + qz * dM[7] - 2.f * qy * dM[8];
      dqz += -2.f * qz * dM[0] - qw * dM[1] + qx * dM[2] + qw * dM[3] -
             2.f * qz * dM[4] + qy * dM[5] + qx * dM[6] + qy * dM[7];
      dqw += -qz * dM[1] + qy * dM[2] + qz * dM[3] - qx * dM[5] - qy * dM[6] +
             qx * dM[7];
      gn[3] = dqw;
      gn[4] = dqx;
      gn[5] = dqy;
      gn[6] = dqz;
    } else {
      gn[3] = gn[4] = gn[5] = gn[6] = 0.f;
    }

    if (A.upd_FL) {
      const float fx = S.sc[SC_FX], fy = S.sc[SC_FY];
      const float cx = A.w / 2.f, cy = A.h / 2.f, s_img = fminf(A.h, A.w) / 2.f;
      const float dfx = -S.sc[SC_DA] / (fx * fx) + S.sc[SC_DC] * cx / (fx * fx);
      const float dfy = -S.sc[SC_DB] / (fy * fy) + S.sc[SC_DD] * cy / (fy * fy);
      const float df[2] = {dfx * s_img / (float)N, dfy * s_img / (float)N};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float e = S.efl[n * 2 + k];
        const float inside = (e >= kMinFl && e <= kMaxFl) ? 1.f : 0.f;
        gn[7 + k] = df[k] * inside * e;
      }
    } else {
      gn[7] = gn[8] = 0.f;
    }
  }
  __syncthreads();
}

// Divide by the count, clip, momentum, sticky stop; S.sc[SC_COUNT] holds
// the global count and S.g the summed unnormalised gradient.
__device__ void apply_update(const GGSArgs& A, const Smem& S) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = A.N * 9;
  const float count = S.sc[SC_COUNT];
  const float den = fmaxf(count, 1.f);
  if (warp == 0) {
    float sx = 0.f, sg = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float g = S.g[e] / den;
      const float xm = fabsf(g) > 0.f ? S.x[e] : 0.f;
      sx += xm * xm;
      sg += g * g;
    }
    sx = warp_sum(sx);
    sg = warp_sum(sg);
    if (lane == 0) {
      const bool stop_now = A.min_matches > 0.f && count / (float)A.N < A.min_matches;
      S.sc[SC_STOP] = (S.sc[SC_STOP] > 0.5f || stop_now) ? 1.f : 0.f;
      S.sc[SC_XNORM2] = sx;
      S.sc[SC_GNORM2] = sg;
    }
  }
  __syncthreads();
  if (S.sc[SC_STOP] < 0.5f) {
    const float max_norm = A.alpha * sqrtf(S.sc[SC_XNORM2]) / A.lr;
    const float clip = fminf(1.f, max_norm / (sqrtf(S.sc[SC_GNORM2]) + 1e-6f));
    for (int e = tid; e < E; e += blockDim.x) {
      const float g = S.g[e] / den * clip;
      const float bn = A.momentum * S.buf[e] + g;
      S.x[e] = S.x[e] - A.lr * bn;
      S.buf[e] = bn;
    }
  }
  __syncthreads();
}

__device__ void init_state(const GGSArgs& A, const Smem& S, const float* x_in) {
  for (int e = threadIdx.x; e < A.N * 9; e += blockDim.x) {
    S.x[e] = x_in[e];
    S.buf[e] = 0.f;
  }
  for (int p = threadIdx.x; p < A.P; p += blockDim.x) {
    S.pi1[p] = A.pi1[p];
    S.pi2[p] = A.pi2[p];
    S.fent[2 * p] = A.fent[2 * p];
    S.fent[2 * p + 1] = A.fent[2 * p + 1];
  }
  for (int n = threadIdx.x; n <= A.N; n += blockDim.x) S.fptr[n] = A.fptr[n];
  if (threadIdx.x == 0) S.sc[SC_STOP] = 0.f;
  __syncthreads();
}

__global__ void __launch_bounds__(kResidentThreads)
ggs_phase_kernel(GGSArgs A, const float* __restrict__ x_in, float* __restrict__ x_out) {
  extern __shared__ float smem[];
  const Smem S = carve(smem, A.N, A.P, A.P);
  init_state(A, S, x_in);
  for (int it = 0; it < A.iters; ++it) {
    pair_gradients(A, S, 0, A.P);
    frame_gradients(A, S);
    apply_update(A, S);
  }
  for (int e = threadIdx.x; e < A.N * 9; e += blockDim.x) x_out[e] = S.x[e];
}

// rows: 2 x P x kPB floats of global scratch (iteration parity x pair).
__global__ void __launch_bounds__(kChunkThreads)
ggs_phase_chunked_kernel(GGSArgs A, const float* __restrict__ x_in,
                         float* __restrict__ x_out, int chunk, float* rows) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem S = carve(smem, A.N, chunk, A.P);
  const int p0 = blockIdx.x * chunk;
  init_state(A, S, x_in);
  for (int it = 0; it < A.iters; ++it) {
    pair_gradients(A, S, p0, chunk);
    float* buf = rows + (size_t)(it & 1) * A.P * kPB;
    for (int e = threadIdx.x; e < chunk * kPB; e += blockDim.x)
      __stcg(buf + (size_t)p0 * kPB + e, S.pb[(size_t)p0 * kPB + e]);
    grid.sync();
#pragma unroll 8
    for (int e = threadIdx.x; e < A.P * kPB; e += blockDim.x) S.pb[e] = __ldcg(buf + e);
    __syncthreads();
    frame_gradients(A, S);
    apply_update(A, S);
  }
  if (blockIdx.x == 0)
    for (int e = threadIdx.x; e < A.N * 9; e += blockDim.x) x_out[e] = S.x[e];
}

static GGSArgs make_args(const void* kp1x, const void* kp1y, const void* kp2x,
                         const void* kp2y, const void* valid, const void* pi1,
                         const void* pi2, const void* fptr, const void* fent,
                         int N, int P, int Q, int h, int w, int upd_R, int upd_T,
                         int upd_FL, float sampson_max, int iters, float lr,
                         float momentum, float alpha, float min_matches) {
  GGSArgs A;
  A.kp1x = (const float*)kp1x;
  A.kp1y = (const float*)kp1y;
  A.kp2x = (const float*)kp2x;
  A.kp2y = (const float*)kp2y;
  A.valid = (const float*)valid;
  A.pi1 = (const int*)pi1;
  A.pi2 = (const int*)pi2;
  A.fptr = (const int*)fptr;
  A.fent = (const int*)fent;
  A.N = N;
  A.P = P;
  A.Q = Q;
  A.h = (float)h;
  A.w = (float)w;
  A.upd_R = upd_R;
  A.upd_T = upd_T;
  A.upd_FL = upd_FL;
  A.sampson_max = sampson_max;
  A.iters = iters;
  A.lr = lr;
  A.momentum = momentum;
  A.alpha = alpha;
  A.min_matches = min_matches;
  return A;
}

#define GGS_PARAMS                                                            \
  const void *x_in, void *x_out, const void *kp1x, const void *kp1y,          \
      const void *kp2x, const void *kp2y, const void *valid, const void *pi1, \
      const void *pi2, const void *fptr, const void *fent, int N, int P,      \
      int Q, int h, int w, int upd_R, int upd_T, int upd_FL,                  \
      float sampson_max, int iters, float lr, float momentum, float alpha,    \
      float min_matches
#define GGS_MAKE_ARGS                                                          \
  make_args(kp1x, kp1y, kp2x, kp2y, valid, pi1, pi2, fptr, fent, N, P, Q, h, \
            w, upd_R, upd_T, upd_FL, sampson_max, iters, lr, momentum, alpha, \
            min_matches)

// Bytes of dynamic shared memory of one block over Pc pairs (the wrapper
// checks them against the card's limit with the same formula).
static size_t ggs_smem_bytes(int N, int Pc, int P) {
  return sizeof(float) * ggs_smem_floats(N, Pc, P);
}

PD_API int pd_ggs_phase(GGS_PARAMS, void* stream) {
  const GGSArgs A = GGS_MAKE_ARGS;
  const size_t smem = ggs_smem_bytes(N, P, P);
  cudaError_t err = cudaFuncSetAttribute(
      ggs_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ggs_phase_kernel<<<1, kResidentThreads, smem, (cudaStream_t)stream>>>(
      A, (const float*)x_in, (float*)x_out);
  return (int)cudaGetLastError();
}

// P must be a multiple of chunk; rows holds 2 x P x 29 floats of scratch. The launch is refused (cudaErrorCooperativeLaunchTooLarge)
// when the P / chunk blocks cannot all be resident at once.
PD_API int pd_ggs_phase_chunked(GGS_PARAMS, int chunk, void* rows, void* stream) {
  GGSArgs A = GGS_MAKE_ARGS;
  if (chunk < 1 || P % chunk != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ggs_smem_bytes(N, chunk, P);
  cudaError_t err = cudaFuncSetAttribute(ggs_phase_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float* xi = (const float*)x_in;
  float* xo = (float*)x_out;
  float* rw = (float*)rows;
  void* args[] = {&A, &xi, &xo, &chunk, &rw};
  err = cudaLaunchCooperativeKernel((const void*)ggs_phase_chunked_kernel,
                                    dim3(P / chunk), dim3(kChunkThreads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
