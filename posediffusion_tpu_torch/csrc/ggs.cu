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
// loop (ops/kernels.py ggs_phase_plain / ggs_phase_chunked_plain).
//
// Bound: latency. A phase is 100 or 200 strictly sequential iterations; one
// iteration at 20 frames is 190 pairs x 128 (or 1,024) padded matches, i.e.
// 24,320 (194,560) Sampson residuals and their adjoints, ~120 FLOP each. An
// iteration's time is its chain of dependent instructions, exchanges and
// barriers, so the design keeps that chain short.
//
// Both entry points launch ggs_cluster_kernel as ONE thread-block cluster
// (cudaLaunchKernelEx): pd_ggs_phase as a cluster of one block that owns all
// pairs, pd_ggs_phase_chunked as a cluster of C blocks (16 where the card
// schedules it, else 8; the wrapper asks pd_ggs_max_active_clusters), block
// r owning pairs [r Pb, (r + 1) Pb) of the padded P = C Pb, a warp a pair
// (at most 12 warps; more pairs loop). Every block keeps its own copy of x
// (N x 9), the momentum and the frames' poses, and applies the same update
// to them, so the copies stay identical; block 0 writes the result.
//
// At launch each block loads its pairs' slice of the five (P, Q) planes
// (kp1x, kp1y, kp2x, kp2y, valid) into shared memory once, when it fits
// beside the rest (ggs_resident: 20 frames at 128 padded matches is 30 KB a
// block over 16 blocks); otherwise the same code reads the slice from
// global memory (L2) through the same pointers (1,024 matches a pair).
//
// One iteration: ONE cluster barrier and TWO block barriers on its path,
// and the two halves of a second cluster barrier around them:
//   -- cluster wait (the previous iteration's arrive: every block has read
//      the rows that this one overwrites; all blocks arrived ~1 us ago);
//   1. pair stage, a warp per pair: the pair's two frames' poses (kept per
//      frame) and the tied focal length (the clamped mean over all N
//      frames, lanes in the same order and the same shuffles in every
//      warp), the forward to F = Kinv^T E Kinv; the lanes take the matches
//      four at a time (their IEEE divisions in flight together) for the
//      Sampson residuals, the nine unnormalised dF sums and the count
//      (butterfly shuffles); then, in every lane, the backward to dR1, dR2,
//      dt1, dt2 and the four K^-1 partials: the pair's row, which lanes
//      2 r and 2 r + 1 store into block r's shared memory through DSMEM
//      (map_shared_rank; 24 floats as float4s, the other 5 by column);
//   -- cluster barrier (every pair's row is in every block);
//   2. gather stage, all in the block's own shared memory: every warp sums
//      the count and the K^-1 partials over all P pairs (lanes striding the
//      pairs, then butterflies: the same in every warp); a half-warp a
//      frame, lanes 0-11 sum the frame's 12 rotation and translation
//      adjoints over its entries in fent order, then the flip, quaternion
//      and focal adjoints, the division by the count and the frame's shares
//      of the clip's two norms;
//   -- cluster arrive (this block has read the rows), block barrier;
//   3. update, a warp per frame: the norms from the frames' shares (frame
//      order, the same in every warp), the sticky stop, the adaptive clip,
//      the momentum step and the frame's new pose;
//   -- block barrier. A stopped phase leaves the loop (x no longer moves).
// No atomics: every sum runs in a fixed order that does not depend on the
// cluster size, so the two entry points give the same x bitwise, and
// repeated runs agree bitwise. Everything is float32 without fast-math:
// JAX pins these products to Precision.HIGHEST, and the momentum loop
// amplifies error.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {
constexpr float kLogFlBias = 1.8f;
constexpr float kMinFl = 0.1f;
constexpr float kMaxFl = 20.0f;
constexpr int kRow = 24;  // a pair's dR1, dR2, dt1, dt2: six float4s
constexpr int kTail = 5;  // and its K^-1 partials va..vd and count, stored by column
constexpr int kPart = 10; // nine dF sums and the count, per pair
constexpr int kMaxWarps = 12;  // 168 registers a thread
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxCluster = 16;
constexpr int kMB = 4;  // matches a lane takes at once (their divisions in flight)
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may use
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

// The five planes of a block's slice of the table, row pl of pair p0 + pl:
// in shared memory when resident, else in global memory.
struct Table {
  const float *kp1x, *kp1y, *kp2x, *kp2y, *valid;
};

struct Smem {
  float *x, *buf, *g, *pose, *part, *stop, *rows, *tail, *tab;
  int *pi1, *pi2, *fptr, *fent;  // the block's pairs' frames; the frame lists
};

// Launch arithmetic of a block that owns Pb of the P pairs (mirrored by
// ops/kernels.py ggs_smem_bytes).
__host__ __device__ inline int ggs_warps(int Pb) { return Pb < kMaxWarps ? Pb : kMaxWarps; }

__host__ __device__ inline size_t ggs_base_floats(int N, int Pb, int P) {
  const size_t n = (size_t)P * (kRow + kTail) + (size_t)41 * N + 1 + (size_t)2 * Pb +
                   (N + 1) + (size_t)2 * P;
  return (n + 3) & ~(size_t)3;  // the table starts on 16 bytes
}

__host__ __device__ inline size_t ggs_table_floats(int Pb, int Q) { return (size_t)5 * Pb * Q; }

__host__ __device__ inline bool ggs_resident(int N, int Pb, int P, int Q) {
  return 4 * (ggs_base_floats(N, Pb, P) + ggs_table_floats(Pb, Q)) <= kMaxSmem;
}

__host__ __device__ inline size_t ggs_smem_bytes(int N, int Pb, int P, int Q) {
  return 4 * (ggs_base_floats(N, Pb, P) +
              (ggs_resident(N, Pb, P, Q) ? ggs_table_floats(Pb, Q) : 0));
}

__device__ inline Smem carve(float* base, int N, int Pb, int P) {
  Smem S;
  S.rows = base;  // all P pairs' rows, written by their owners, 16-byte aligned
  S.tail = S.rows + P * kRow;  // kTail x P
  S.x = S.tail + P * kTail;
  S.buf = S.x + N * 9;
  S.g = S.buf + N * 9;     // the normalised gradient
  S.pose = S.g + N * 9;    // per frame R_cv (9) and t_cv (3) of the current x
  S.part = S.pose + N * 12;  // per frame: its share of |x masked|^2 and |g|^2
  S.stop = S.part + N * 2;
  S.pi1 = (int*)(S.stop + 1);
  S.pi2 = S.pi1 + Pb;
  S.fptr = S.pi2 + Pb;
  S.fent = S.fptr + N + 1;
  S.tab = base + ggs_base_floats(N, Pb, P);
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

// Frame n's OpenCV rotation R_cv (row-major) and translation t_cv.
__device__ __forceinline__ void frame_pose(const float* x, int n, float* R, float* t) {
  const float* xn = x + n * 9;
  const float qw = xn[3], qx = xn[4], qy = xn[5], qz = xn[6];
  const float s = 2.f / (qw * qw + qx * qx + qy * qy + qz * qz);
  float M[9];
  quat_M(qw, qx, qy, qz, M);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float R_ji = (i == j ? 1.f : 0.f) + s * M[3 * j + i];
      R[3 * i + j] = flip_of(i) * R_ji;
    }
  t[0] = -xn[0];
  t[1] = -xn[1];
  t[2] = xn[2];
}

// Frame n's pose into S.pose from S.x: R_cv then t_cv.
__device__ __forceinline__ void store_pose(const Smem& S, int n) {
  float R[9], t[3];
  frame_pose(S.x, n, R, t);
#pragma unroll
  for (int k = 0; k < 9; ++k) S.pose[n * 12 + k] = R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) S.pose[n * 12 + 9 + k] = t[k];
}

__device__ __forceinline__ float frame_focal(const float* x, int n, int k) {
  return expf(x[n * 9 + 7 + k] + kLogFlBias);
}

// The tied focal lengths fx, fy: the clamped mean over the N frames, lanes
// striding the frames and one butterfly, the same in every warp.
__device__ __forceinline__ void mean_focal(const GGSArgs& A, const float* x,
                                           float& fx, float& fy) {
  const int lane = threadIdx.x & 31;
  float f0 = 0.f, f1 = 0.f;
  for (int n = lane; n < A.N; n += 32) {
    f0 += fminf(fmaxf(frame_focal(x, n, 0), kMinFl), kMaxFl);
    f1 += fminf(fmaxf(frame_focal(x, n, 1), kMinFl), kMaxFl);
  }
  f0 = warp_sum(f0);
  f1 = warp_sum(f1);
  const float s_img = fminf(A.h, A.w) / 2.f;
  fx = f0 / (float)A.N * s_img;
  fy = f1 / (float)A.N * s_img;
}

// The two halves of a cluster barrier: arrive (release: this thread's
// earlier reads and writes of shared memory are done), then wait (acquire)
// before touching what the others were using.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 1. The block's pairs, a warp each: their rows (unnormalised: dR1, dR2,
// dt1, dt2, the K^-1 partials va..vd, the count) into pair p's place in
// every block of the cluster. fx, fy: the tied focal lengths of this x, for
// the gather.
__device__ void pair_stage(const GGSArgs& A, const Smem& S, cg::cluster_group& cluster,
                           const Table tb, int p0, int Pb, float& fx, float& fy) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int Q = A.Q, C = (int)cluster.num_blocks();
  mean_focal(A, S.x, fx, fy);
  const float a = 1.f / fx, b = 1.f / fy;
  const float c = -(A.w / 2.f) / fx, d = -(A.h / 2.f) / fy;

  for (int pl = warp; pl < Pb; pl += W) {
    float r1[9], r2[9], t1[3], t2[3];
    const float* f1 = S.pose + S.pi1[pl] * 12;
    const float* f2 = S.pose + S.pi2[pl] * 12;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      r1[k] = f1[k];
      r2[k] = f2[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t1[k] = f1[9 + k];
      t2[k] = f2[9 + k];
    }
    // ---- forward: G = R2 R1^T, t12, Et, E, U = K^-T E, F
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
    // Fu = Fm^T: kp1^T Fu kp2 = 0
    const float F00 = Fm[0], F01 = Fm[3], F02 = Fm[6], F10 = Fm[1], F11 = Fm[4],
                F12 = Fm[7], F20 = Fm[2], F21 = Fm[5], F22 = Fm[8];

    // ---- per match: lanes stride the matches, kMB at a time so that their
    // divisions are in flight together; butterflies reduce
    float acc[kPart];
#pragma unroll
    for (int k = 0; k < kPart; ++k) acc[k] = 0.f;
    const size_t row = (size_t)pl * Q;
    const float *p1x = tb.kp1x + row, *p1y = tb.kp1y + row, *p2x = tb.kp2x + row,
                *p2y = tb.kp2y + row, *pv = tb.valid + row;
    for (int q0 = lane; q0 < Q; q0 += 32 * kMB) {
      float k1x[kMB], k1y[kMB], k2x[kMB], k2y[kMB], v[kMB];
      float l0[kMB], l1[kMB], l2[kMB], r0[kMB], r1_[kMB], ev[kMB], top[kMB], bot_raw[kMB],
          bot[kMB], keep[kMB], dtop[kMB], dbot[kMB];
#pragma unroll
      for (int j = 0; j < kMB; ++j) {
        const int q = q0 + 32 * j;
        const bool in = q < Q;
        k1x[j] = in ? p1x[q] : 0.f;
        k1y[j] = in ? p1y[q] : 0.f;
        k2x[j] = in ? p2x[q] : 0.f;
        k2y[j] = in ? p2y[q] : 0.f;
        v[j] = in ? pv[q] : 0.f;
        l0[j] = k1x[j] * F00 + k1y[j] * F10 + F20;  // kp1^T F
        l1[j] = k1x[j] * F01 + k1y[j] * F11 + F21;
        l2[j] = k1x[j] * F02 + k1y[j] * F12 + F22;
        r0[j] = F00 * k2x[j] + F01 * k2y[j] + F02;  // F kp2
        r1_[j] = F10 * k2x[j] + F11 * k2y[j] + F12;
        ev[j] = l0[j] * k2x[j] + l1[j] * k2y[j] + l2[j];
        top[j] = ev[j] * ev[j];
        bot_raw[j] = l0[j] * l0[j] + l1[j] * l1[j] + r0[j] * r0[j] + r1_[j] * r1_[j];
        bot[j] = fmaxf(bot_raw[j], 1e-12f);
      }
#pragma unroll
      for (int j = 0; j < kMB; ++j) keep[j] = top[j] / bot[j] < A.sampson_max ? v[j] : 0.f;
#pragma unroll
      for (int j = 0; j < kMB; ++j) dtop[j] = keep[j] / bot[j];
#pragma unroll
      for (int j = 0; j < kMB; ++j)
        dbot[j] = bot_raw[j] > 1e-12f ? -keep[j] * top[j] / (bot[j] * bot[j]) : 0.f;
#pragma unroll
      for (int j = 0; j < kMB; ++j) {
        if (q0 + 32 * j >= Q) break;
        const float dev = 2.f * ev[j] * dtop[j];
        const float dl0 = dev * k2x[j] + 2.f * l0[j] * dbot[j];
        const float dl1 = dev * k2y[j] + 2.f * l1[j] * dbot[j];
        const float dl2 = dev;
        const float dr0 = 2.f * r0[j] * dbot[j], dr1 = 2.f * r1_[j] * dbot[j];
        acc[0] += k1x[j] * dl0 + dr0 * k2x[j];
        acc[1] += k1x[j] * dl1 + dr0 * k2y[j];
        acc[2] += k1x[j] * dl2 + dr0;
        acc[3] += k1y[j] * dl0 + dr1 * k2x[j];
        acc[4] += k1y[j] * dl1 + dr1 * k2y[j];
        acc[5] += k1y[j] * dl2 + dr1;
        acc[6] += dl0;
        acc[7] += dl1;
        acc[8] += dl2;
        acc[9] += keep[j];
      }
    }
#pragma unroll
    for (int k = 0; k < kPart; ++k) acc[k] = warp_sum(acc[k]);
    const float* dFu = acc;  // dFu[3 i + j]; dFm[i][j] = dFu[j][i]

    // ---- backward F = U Kinv, then U = Kinv^T E (every lane, lane 0 stores)
    float dU[9], dE[9];
    float va = 0.f, vb = 0.f, vc = 0.f, vd = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float m0 = dFu[i], m1 = dFu[3 + i], m2 = dFu[6 + i];
      const float Ui0 = U[3 * i], Ui1 = U[3 * i + 1];
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
      const float E0j = E[j], E1j = E[3 + j];
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
    // the row into every block of the cluster: lane 2 r + h writes floats
    // [12 h, 12 h + 12) of block r's copy as three float4s, and two (h = 0)
    // or three of the tail's five values
    const float o[kRow] = {dR1[0], dR1[1], dR1[2], dR1[3], dR1[4], dR1[5], dR1[6], dR1[7],
                           dR1[8], dR2[0], dR2[1], dR2[2], dR2[3], dR2[4], dR2[5], dR2[6],
                           dR2[7], dR2[8], dt1[0], dt1[1], dt1[2], dt12[0], dt12[1],
                           dt12[2]};  // dt2 = dt12
    if ((lane >> 1) < C) {
      const bool h = lane & 1;
      const int p = p0 + pl;
      float* blk = cluster.map_shared_rank(S.rows, lane >> 1);
      float4* dst = reinterpret_cast<float4*>(blk + (size_t)p * kRow) + 3 * h;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        dst[i] = h ? make_float4(o[12 + 4 * i], o[13 + 4 * i], o[14 + 4 * i], o[15 + 4 * i])
                   : make_float4(o[4 * i], o[1 + 4 * i], o[2 + 4 * i], o[3 + 4 * i]);
      float* tail = blk + (size_t)A.P * kRow + p;
      if (h) {
        tail[2 * A.P] = vc;
        tail[3 * A.P] = vd;
        tail[4 * A.P] = acc[9];
      } else {
        tail[0] = va;
        tail[A.P] = vb;
      }
    }
  }
}

// 2. From all P rows of this iteration in the block's own shared memory,
// every warp: the count and the K^-1 partials over the pairs (lanes striding
// the pairs, then butterflies: the same in every warp); then, a half-warp a
// frame, the frame's gradient: lanes 0-11 sum its 12 rotation and
// translation adjoints over its entries in fent order, the flip, quaternion
// and focal adjoints follow, divided by the count; into S.g with the frame's
// shares of the clip's two norms (its nine terms in order) in S.part.
// Returns the count.
__device__ float gather_stage(const GGSArgs& A, const Smem& S, float fx, float fy) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int N = A.N;
  float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = lane; p < A.P; p += 32) {
#pragma unroll
    for (int k = 0; k < kTail; ++k) v[k] += S.tail[k * A.P + p];
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = warp_sum(v[k]);
  const float count = v[4], den = fmaxf(count, 1.f);
  const float cx = A.w / 2.f, cy = A.h / 2.f, s_img = fminf(A.h, A.w) / 2.f;
  const float dfx = -v[0] / (fx * fx) + v[2] * cx / (fx * fx);
  const float dfy = -v[1] / (fy * fy) + v[3] * cy / (fy * fy);
  const float df[2] = {dfx * s_img / (float)N, dfy * s_img / (float)N};

  // a half-warp a frame: frames 2 w + h, 2 w + h + 2 W, ... on half h of warp w
  const int half = lane >> 4, hl = lane & 15;
  for (int n0 = 2 * warp; n0 < N; n0 += 2 * W) {
    const bool active = n0 + half < N;
    const int n = active ? n0 + half : n0;
    // lane k < 9 of the half: dRcv[k] (role r reads o[9 r + k]); 9 <= k < 12:
    // dtcv[k - 9] (o[18 + 3 r + k - 9])
    float s = 0.f;
    if (hl < 12) {
      const int k = hl < 9 ? hl : 9 + hl, kr = hl < 9 ? 9 : 3;
      const int e1 = S.fptr[n + 1];
      for (int eb = S.fptr[n]; eb < e1; eb += 8) {  // eight loads in flight, then the adds
        float t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ent = eb + j < e1 ? S.fent[eb + j] : 0;
          t[j] = S.rows[(ent >> 1) * kRow + k + (ent & 1) * kr];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (eb + j < e1) s += t[j];
      }
    }
    float dRcv[9], dtcv[3], g[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) dRcv[k] = __shfl_sync(0xffffffffu, s, k, 16);
#pragma unroll
    for (int k = 0; k < 3; ++k) dtcv[k] = __shfl_sync(0xffffffffu, s, 9 + k, 16);
    const float* xn = S.x + n * 9;
    g[0] = A.upd_T ? -dtcv[0] : 0.f;
    g[1] = A.upd_T ? -dtcv[1] : 0.f;
    g[2] = A.upd_T ? dtcv[2] : 0.f;
    if (A.upd_R) {
      const float qw = xn[3], qx = xn[4], qy = xn[5], qz = xn[6];
      const float n2 = qw * qw + qx * qx + qy * qy + qz * qz;
      const float sq = 2.f / n2;
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
        dM[k] = sq * dR[k];
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
      g[3] = dqw;
      g[4] = dqx;
      g[5] = dqy;
      g[6] = dqz;
    } else {
      g[3] = g[4] = g[5] = g[6] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float ef = frame_focal(S.x, n, k);
      const float inside = (ef >= kMinFl && ef <= kMaxFl) ? 1.f : 0.f;
      g[7 + k] = A.upd_FL ? df[k] * inside * ef : 0.f;
    }
    float sx = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      g[k] = g[k] / den;
      const float xm = fabsf(g[k]) > 0.f ? xn[k] : 0.f;
      sx += xm * xm;
      sg += g[k] * g[k];
    }
    if (hl == 0 && active) {
#pragma unroll
      for (int k = 0; k < 9; ++k) S.g[n * 9 + k] = g[k];
      S.part[2 * n] = sx;
      S.part[2 * n + 1] = sg;
    }
  }
  return count;
}

// 3. Every warp: the clip's norms from the frames' shares (lanes striding
// the frames, then butterflies: the same in every warp), the sticky stop,
// then momentum and step for the warp's own frames, and their new poses.
__device__ void update_stage(const GGSArgs& A, const Smem& S, float count, bool stopped) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int N = A.N;
  float sx = 0.f, sg = 0.f;
  for (int n = lane; n < N; n += 32) {
    sx += S.part[2 * n];
    sg += S.part[2 * n + 1];
  }
  sx = warp_sum(sx);
  sg = warp_sum(sg);
  const bool stop = stopped || (A.min_matches > 0.f && count / (float)N < A.min_matches);
  if (threadIdx.x == 0) S.stop[0] = stop ? 1.f : 0.f;
  if (stop) return;
  const float max_norm = A.alpha * sqrtf(sx) / A.lr;
  const float clip = fminf(1.f, max_norm / (sqrtf(sg) + 1e-6f));
  for (int n = warp; n < N; n += W) {
    if (lane < 9) {
      const int e = n * 9 + lane;
      const float bn = A.momentum * S.buf[e] + S.g[e] * clip;
      S.x[e] = S.x[e] - A.lr * bn;
      S.buf[e] = bn;
    }
    __syncwarp();
    if (lane == 0) store_pose(S, n);
  }
}

// A cluster of P / Pb blocks (one for pd_ggs_phase), 32 ggs_warps(Pb)
// threads each.
__global__ void __launch_bounds__(kMaxThreads)
ggs_cluster_kernel(GGSArgs A, const float* __restrict__ x_in, float* __restrict__ x_out,
                   int Pb) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = A.N, Q = A.Q;
  const Smem S = carve(smem, N, Pb, A.P);
  const int p0 = rank * Pb;

  for (int e = tid; e < N * 9; e += nt) {
    S.x[e] = x_in[e];
    S.buf[e] = 0.f;
  }
  for (int pl = tid; pl < Pb; pl += nt) {
    S.pi1[pl] = A.pi1[p0 + pl];
    S.pi2[pl] = A.pi2[p0 + pl];
  }
  for (int n = tid; n <= N; n += nt) S.fptr[n] = A.fptr[n];
  for (int e = tid; e < 2 * A.P; e += nt) S.fent[e] = A.fent[e];
  if (tid == 0) S.stop[0] = 0.f;
  const size_t slice = (size_t)Pb * Q, off = (size_t)p0 * Q;
  Table tb = {A.kp1x + off, A.kp1y + off, A.kp2x + off, A.kp2y + off, A.valid + off};
  if (ggs_resident(N, Pb, A.P, Q)) {
    const float* src[5] = {tb.kp1x, tb.kp1y, tb.kp2x, tb.kp2y, tb.valid};
#pragma unroll
    for (int k = 0; k < 5; ++k)
      for (size_t i = tid; i < slice; i += nt) S.tab[k * slice + i] = src[k][i];
    tb = Table{S.tab, S.tab + slice, S.tab + 2 * slice, S.tab + 3 * slice,
               S.tab + 4 * slice};
  }
  __syncthreads();
  for (int n = tid; n < N; n += nt) store_pose(S, n);
  cluster.sync();  // every block has started and holds its tables and poses

  for (int it = 0; it < A.iters; ++it) {
    float fx, fy;
    if (it > 0) cluster_wait();  // every block has read the previous rows
    pair_stage(A, S, cluster, tb, p0, Pb, fx, fy);
    cluster.sync();  // every pair's row is in every block
    const bool stopped = S.stop[0] > 0.5f;
    const float count = gather_stage(A, S, fx, fy);
    cluster_arrive();  // this block has read the rows (the next writes wait)
    __syncthreads();
    update_stage(A, S, count, stopped);
    __syncthreads();
    if (S.stop[0] > 0.5f) break;  // x and the momentum stay as they are
  }
  if (rank == 0)
    for (int e = tid; e < N * 9; e += nt) x_out[e] = S.x[e];
  if (A.iters > 0) cluster_wait();  // pairs the last arrive
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

// The launch of a cluster of C blocks over Pb pairs each (P = C Pb): the
// kernel's attributes set, the configuration and its cluster attribute
// filled. Returns cudaErrorInvalidValue for a shape the kernel refuses.
static cudaError_t ggs_config(int N, int Pb, int P, int Q, int C, cudaStream_t stream,
                              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (N < 2 || Pb < 1 || Q < 1 || C < 1 || C > kMaxCluster || P != C * Pb)
    return cudaErrorInvalidValue;
  const size_t smem = ggs_smem_bytes(N, Pb, P, Q);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ggs_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ggs_cluster_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C);
  cfg->blockDim = dim3(32 * ggs_warps(Pb));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

static int ggs_launch(const GGSArgs& A, const void* x_in, void* x_out, int Pb,
                      void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = ggs_config(A.N, Pb, A.P, A.Q, A.P / Pb, (cudaStream_t)stream,
                               &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, ggs_cluster_kernel, A, (const float*)x_in,
                           (float*)x_out, Pb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Kernel 6: one block owns all P pairs (a cluster of one).
PD_API int pd_ggs_phase(GGS_PARAMS, void* stream) {
  return ggs_launch(GGS_MAKE_ARGS, x_in, x_out, P, stream);
}

// Kernel 7: a cluster of P / chunk blocks, chunk pairs each; P must be a
// multiple of chunk and the cluster at most 16 blocks.
PD_API int pd_ggs_phase_chunked(GGS_PARAMS, int chunk, void* stream) {
  if (chunk < 1 || P % chunk != 0) return (int)cudaErrorInvalidValue;
  return ggs_launch(GGS_MAKE_ARGS, x_in, x_out, chunk, stream);
}

// Bytes of dynamic shared memory of a block over Pb of P pairs (the table
// slice included when it is resident).
PD_API int pd_ggs_smem_bytes(int N, int Pb, int P, int Q) {
  return (int)ggs_smem_bytes(N, Pb, P, Q);
}

// How many clusters of C blocks over Pb pairs each the card can hold at
// once (0: such a cluster cannot be scheduled), or minus a CUDA error.
PD_API int pd_ggs_max_active_clusters(int N, int Pb, int Q, int C) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = ggs_config(N, Pb, C * Pb, Q, C, 0, &cfg, attr);
  if (err != cudaSuccess) return -(int)err;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, ggs_cluster_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is an answer, not a sticky error
    return -(int)err;
  }
  return n;
}
