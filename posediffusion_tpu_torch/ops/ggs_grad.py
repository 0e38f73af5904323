"""Closed-form Sampson loss and gradient of the GGS hot loop, as in
``posediffusion_tpu.ops.ggs_grad``.

The match table is pair-grouped (P = n(n-1)/2 ordered pair slots x Q padded
matches), so every array is (P, Q), (P,) or (N,), and the whole chain (pose
encoding -> quaternion rotation -> OpenCV flip -> relative pose ->
essential -> fundamental -> Sampson -> masked mean) has hand-written
adjoints. ``loss_and_grad_core`` in plain PyTorch is the reference that the
GGS kernels (``ops/ggs_kernel.py``, ``csrc/ggs.cu``) are held against on the
card; the CPU tests hold it against the JAX function and against autograd.
Semantics are those of ``diffusion.ggs.compute_sampson_loss``: tied mean
focal length, zero principal point, per-block update flags, residuals at or
above ``sampson_max`` dropped, mean over the contributing matches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from posediffusion_tpu_torch.geometry.pose_codec import LOG_FL_BIAS, MAX_FL, MIN_FL


class GroupedMatches(NamedTuple):
    """kp1/kp2 (P, Q, 3) homogeneous pixel keypoints; valid (P, Q) float 0/1;
    B1/B2 (P, N) one-hot selectors of each pair's first and second frame."""

    kp1: torch.Tensor
    kp2: torch.Tensor
    valid: torch.Tensor
    B1: torch.Tensor
    B2: torch.Tensor


def pack_matches_grouped(kp1: np.ndarray, kp2: np.ndarray, i12: np.ndarray,
                         n_frames: int, q_pad: Optional[int] = None,
                         device=None) -> GroupedMatches:
    """Group host-side matches by ordered pair (i12[:, 0] < i12[:, 1]) and
    pad each group to Q (a multiple of 128 by default); padded keypoints are
    (0, 0, 1), so no quantity divides 0 by 0."""
    P = n_frames * (n_frames - 1) // 2
    pi1, pi2 = np.triu_indices(n_frames, k=1)  # slot order: (0,1), (0,2), ...
    pair_index = np.zeros((n_frames, n_frames), np.int64)
    pair_index[pi1, pi2] = np.arange(P)

    i12 = np.asarray(i12)
    if len(i12) and not np.all(i12[:, 0] < i12[:, 1]):
        raise ValueError("pack_matches_grouped requires ordered pairs "
                         "(i12[:, 0] < i12[:, 1])")
    slots = pair_index[i12[:, 0], i12[:, 1]] if len(i12) else np.zeros(0, np.int64)
    counts = np.bincount(slots, minlength=P)
    q = int(counts.max()) if len(kp1) else 1
    if q_pad is None:
        q_pad = max(((q + 127) // 128) * 128, 128)
    if q > q_pad:
        raise ValueError(f"q_pad={q_pad} < max matches per pair {q}")

    kp1g = np.zeros((P, q_pad, 3), np.float32)
    kp2g = np.zeros((P, q_pad, 3), np.float32)
    kp1g[..., 2] = 1.0
    kp2g[..., 2] = 1.0
    valid = np.zeros((P, q_pad), np.float32)
    # position of each match inside its pair slot, in input order
    order = np.argsort(slots, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty(len(slots), np.int64)
    pos[order] = np.arange(len(slots)) - starts[slots[order]]
    kp1g[slots, pos, :2] = kp1
    kp2g[slots, pos, :2] = kp2
    valid[slots, pos] = 1.0

    B1 = np.zeros((P, n_frames), np.float32)
    B2 = np.zeros((P, n_frames), np.float32)
    B1[np.arange(P), pi1] = 1.0
    B2[np.arange(P), pi2] = 1.0
    t = lambda a: torch.as_tensor(a, device=device)
    return GroupedMatches(t(kp1g), t(kp2g), t(valid), t(B1), t(B2))


class GGSTables(NamedTuple):
    """A ``GroupedMatches`` as the GGS kernels read it: the five (P, Q)
    planes contiguous, each pair's frames ``pi1``/``pi2`` (P,) int32, and per
    frame n the entries ``2 p + role`` (role 0: first frame of pair p, 1:
    second) in ``fent[fptr[n]:fptr[n + 1]]``, ordered by role then pair, so
    the kernels gather a frame's gradient in a fixed order. B1/B2 stay for
    the plain version."""

    kp1x: torch.Tensor
    kp1y: torch.Tensor
    kp2x: torch.Tensor
    kp2y: torch.Tensor
    valid: torch.Tensor
    B1: torch.Tensor
    B2: torch.Tensor
    pi1: torch.Tensor
    pi2: torch.Tensor
    fptr: torch.Tensor
    fent: torch.Tensor


def ggs_tables(gm: GroupedMatches) -> GGSTables:
    P, N = gm.B1.shape
    pi1 = gm.B1.argmax(1).cpu().numpy()
    pi2 = gm.B2.argmax(1).cpu().numpy()
    frames = np.concatenate([pi1, pi2])
    roles = np.repeat([0, 1], P)
    pairs = np.tile(np.arange(P), 2)
    order = np.lexsort((pairs, roles, frames))
    fptr = np.concatenate([[0], np.cumsum(np.bincount(frames, minlength=N))])
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=gm.valid.device)
    plane = lambda a: a.contiguous()
    return GGSTables(
        kp1x=plane(gm.kp1[..., 0]), kp1y=plane(gm.kp1[..., 1]),
        kp2x=plane(gm.kp2[..., 0]), kp2y=plane(gm.kp2[..., 1]),
        valid=plane(gm.valid), B1=gm.B1, B2=gm.B2, pi1=i32(pi1), pi2=i32(pi2),
        fptr=i32(fptr), fent=i32((2 * pairs + roles)[order]),
    )


def pad_grouped_pairs(gm: GroupedMatches, multiple: int) -> GroupedMatches:
    """Pad the pair axis to a multiple of ``multiple`` with inert rows: frames
    0 and 1 selected (every quantity stays finite), no valid match (no
    contribution to the loss, the count or the gradient)."""
    P, Q = gm.valid.shape
    pad = (-P) % multiple
    if pad == 0:
        return gm
    n_frames = gm.B1.shape[1]
    kw = dict(dtype=torch.float32, device=gm.kp1.device)
    kp_pad = torch.zeros((pad, Q, 3), **kw)
    kp_pad[..., 2] = 1.0
    b1 = torch.zeros((pad, n_frames), **kw)
    b2 = torch.zeros((pad, n_frames), **kw)
    b1[:, 0] = 1.0
    b2[:, min(1, n_frames - 1)] = 1.0
    return GroupedMatches(
        kp1=torch.cat([gm.kp1, kp_pad]), kp2=torch.cat([gm.kp2, kp_pad]),
        valid=torch.cat([gm.valid, torch.zeros((pad, Q), **kw)]),
        B1=torch.cat([gm.B1, b1]), B2=torch.cat([gm.B2, b2]),
    )


def sampson_loss_and_grad(x: torch.Tensor, gm: GroupedMatches,
                          image_hw: Tuple[int, int], update_R: bool,
                          update_T: bool, update_FL: bool, sampson_max: float):
    """(loss, count, dL/dx) of one sequence's (N, 9) encodings, closed form."""
    return loss_and_grad_core(
        x, gm.kp1[..., 0], gm.kp1[..., 1], gm.kp2[..., 0], gm.kp2[..., 1],
        gm.valid, gm.B1, gm.B2, image_hw, update_R, update_T, update_FL,
        sampson_max,
    )


def loss_and_grad_core(
    x: torch.Tensor,  # (N, 9)
    kp1x, kp1y, kp2x, kp2y,  # (P, Q) pixel coordinates (z == 1 implied)
    valid,  # (P, Q) float 0/1
    B1, B2,  # (P, N) one-hot frame selectors
    image_hw: Tuple[int, int],
    update_R: bool,
    update_T: bool,
    update_FL: bool,
    sampson_max: float,
    normalize: bool = True,
):
    """Loss, count and gradient in component-array form.

    ``normalize=False`` returns the loss sum and the gradient of the sum
    (denominator 1, not the count of contributing matches): the backward is
    linear in the upstream adjoint, so per-chunk gradients of a partitioned
    table sum exactly, and the caller divides once by the global count."""
    N = x.shape[0]
    h, w = image_hw

    T, q, lf = x[:, 0:3], x[:, 3:7], x[:, 7:9]

    # ---- focal chain: exp -> clamp -> mean tie -> pixel intrinsics
    e_fl = torch.exp(lf + LOG_FL_BIAS)
    fbar = e_fl.clamp(MIN_FL, MAX_FL).mean(0)
    s_img = min(h, w) / 2.0
    fx, fy = fbar[0] * s_img, fbar[1] * s_img
    cx, cy = w / 2.0, h / 2.0
    a, b = 1.0 / fx, 1.0 / fy
    c, d = -cx / fx, -cy / fy

    # ---- quaternion -> rotation (row-vector convention): R = I + s M
    qw, qx, qy, qz = q.unbind(-1)
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / n2
    Ms = [[-(qy * qy + qz * qz), qx * qy - qz * qw, qx * qz + qy * qw],
          [qx * qy + qz * qw, -(qx * qx + qz * qz), qy * qz - qx * qw],
          [qx * qz - qy * qw, qy * qz + qx * qw, -(qx * qx + qy * qy)]]
    R = [[(1.0 if i == j else 0.0) + s * Ms[i][j] for j in range(3)] for i in range(3)]

    # ---- OpenCV conversion: R_cv[i, j] = flip_i * R[j, i]; t_cv = T * flip
    flip = (-1.0, -1.0, 1.0)
    Rcv = torch.stack([flip[i] * R[j][i] for i in range(3) for j in range(3)], -1)
    tcv = T * torch.tensor(flip, dtype=x.dtype, device=x.device)

    # ---- per-pair frame selection ((P, N) @ (N, k) one-hot products)
    R1, R2, t1, t2 = B1 @ Rcv, B2 @ Rcv, B1 @ tcv, B2 @ tcv
    r1 = [R1[:, k] for k in range(9)]
    r2 = [R2[:, k] for k in range(9)]

    # ---- relative pose, then Et = -G^T t12
    G = [[sum(r2[3 * i + k] * r1[3 * j + k] for k in range(3)) for j in range(3)]
         for i in range(3)]
    t12 = [t2[:, i] - sum(G[i][k] * t1[:, k] for k in range(3)) for i in range(3)]
    Et = [-sum(G[i][k] * t12[i] for i in range(3)) for k in range(3)]

    # ---- essential: E_i = G_i x Et (rows); fundamental F = Kinv^T E Kinv
    E = [[G[i][1] * Et[2] - G[i][2] * Et[1],
          G[i][2] * Et[0] - G[i][0] * Et[2],
          G[i][0] * Et[1] - G[i][1] * Et[0]] for i in range(3)]
    U = [[a * E[0][j] for j in range(3)],
         [b * E[1][j] for j in range(3)],
         [c * E[0][j] + d * E[1][j] + E[2][j] for j in range(3)]]
    Fm = [[a * U[i][0], b * U[i][1], c * U[i][0] + d * U[i][1] + U[i][2]]
          for i in range(3)]
    Fu = [[Fm[j][i] for j in range(3)] for i in range(3)]  # kp1^T Fu kp2 = 0

    # ---- Sampson over (P, Q); homogeneous z == 1 as a constant
    k1 = [kp1x, kp1y, 1.0]
    k2 = [kp2x, kp2y, 1.0]
    Fq = [[Fu[i][j][:, None] for j in range(3)] for i in range(3)]
    left = [sum(k1[i] * Fq[i][j] for i in range(3)) for j in range(3)]
    right = [sum(Fq[i][j] * k2[j] for j in range(3)) for i in range(3)]
    ev = sum(left[j] * k2[j] for j in range(3))
    top = ev * ev
    bot_raw = left[0] ** 2 + left[1] ** 2 + right[0] ** 2 + right[1] ** 2
    bot = bot_raw.clamp_min(1e-12)
    samp = top / bot

    keep = valid * (samp < sampson_max).to(x.dtype)
    count = keep.sum()
    denom = count.clamp_min(1.0) if normalize else torch.ones((), dtype=x.dtype,
                                                               device=x.device)
    loss = (keep * samp).sum() / denom

    # ======================== backward (dL = 1) ========================
    dsamp = keep / denom
    dtop = dsamp / bot
    dbot = torch.where(bot_raw > 1e-12, -dsamp * top / (bot * bot), 0.0)
    dev = 2.0 * ev * dtop
    dleft = [dev * k2[0] + 2.0 * left[0] * dbot,
             dev * k2[1] + 2.0 * left[1] * dbot,
             dev * k2[2]]
    dright = [2.0 * right[0] * dbot, 2.0 * right[1] * dbot, None]

    dFu = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            term = k1[i] * dleft[j]
            if dright[i] is not None:
                term = term + dright[i] * k2[j]
            dFu[i][j] = term.sum(1)  # (P,)
    dFm = [[dFu[j][i] for j in range(3)] for i in range(3)]

    # backward F = U Kinv, then U = Kinv^T E; va..vd collect the intrinsics'
    # per-pair adjoints
    dU = [[None] * 3 for _ in range(3)]
    va = vb = vc = vd = 0.0
    for i in range(3):
        dU[i][0] = a * dFm[i][0] + c * dFm[i][2]
        dU[i][1] = b * dFm[i][1] + d * dFm[i][2]
        dU[i][2] = dFm[i][2]
        va = va + U[i][0] * dFm[i][0]
        vb = vb + U[i][1] * dFm[i][1]
        vc = vc + U[i][0] * dFm[i][2]
        vd = vd + U[i][1] * dFm[i][2]
    dE = [[None] * 3 for _ in range(3)]
    for j in range(3):
        dE[0][j] = a * dU[0][j] + c * dU[2][j]
        dE[1][j] = b * dU[1][j] + d * dU[2][j]
        dE[2][j] = dU[2][j]
        va = va + E[0][j] * dU[0][j]
        vb = vb + E[1][j] * dU[1][j]
        vc = vc + E[0][j] * dU[2][j]
        vd = vd + E[1][j] * dU[2][j]
    da, db, dc, dd = torch.stack([va, vb, vc, vd]).sum(1)

    # backward E_i = G_i x Et
    dG = [[None] * 3 for _ in range(3)]
    dEt = [0.0, 0.0, 0.0]
    for i in range(3):
        g0, g1, g2 = dE[i]
        dG[i][0] = Et[1] * g2 - Et[2] * g1
        dG[i][1] = Et[2] * g0 - Et[0] * g2
        dG[i][2] = Et[0] * g1 - Et[1] * g0
        dEt[0] = dEt[0] + (g1 * G[i][2] - g2 * G[i][1])
        dEt[1] = dEt[1] + (g2 * G[i][0] - g0 * G[i][2])
        dEt[2] = dEt[2] + (g0 * G[i][1] - g1 * G[i][0])
    # backward Et_k = -sum_i G[i][k] t12_i
    dt12 = [0.0, 0.0, 0.0]
    for k in range(3):
        for i in range(3):
            dG[i][k] = dG[i][k] - dEt[k] * t12[i]
            dt12[i] = dt12[i] - G[i][k] * dEt[k]
    # backward t12_i = t2_i - sum_k G[i][k] t1_k
    dt2 = list(dt12)
    dt1 = [0.0, 0.0, 0.0]
    for i in range(3):
        for k in range(3):
            dG[i][k] = dG[i][k] - dt12[i] * t1[:, k]
            dt1[k] = dt1[k] - G[i][k] * dt12[i]
    # backward G[i][j] = sum_k R2[3i+k] R1[3j+k]
    dR1 = [0.0] * 9
    dR2 = [0.0] * 9
    for i in range(3):
        for j in range(3):
            for k in range(3):
                dR2[3 * i + k] = dR2[3 * i + k] + dG[i][j] * r1[3 * j + k]
                dR1[3 * j + k] = dR1[3 * j + k] + dG[i][j] * r2[3 * i + k]

    # scatter to frames: B1^T dR1 + B2^T dR2
    dRcv = B1.t() @ torch.stack(dR1, -1) + B2.t() @ torch.stack(dR2, -1)  # (N, 9)
    dtcv = B1.t() @ torch.stack(dt1, -1) + B2.t() @ torch.stack(dt2, -1)  # (N, 3)

    # backward OpenCV flip: dR[j][i] = flip_i * dRcv[i, j]
    dR = [[flip[i] * dRcv[:, 3 * i + j] for i in range(3)] for j in range(3)]
    zeros = torch.zeros_like(x[:, 0])
    dT = (dtcv * torch.tensor(flip, dtype=x.dtype, device=x.device)
          if update_T else torch.zeros_like(T))

    if update_R:
        ds = sum(dR[i][j] * Ms[i][j] for i in range(3) for j in range(3))
        dM = [[s * dR[i][j] for j in range(3)] for i in range(3)]
        dn2 = ds * (-2.0 / (n2 * n2))
        dqw = 2.0 * qw * dn2
        dqx = 2.0 * qx * dn2
        dqy = 2.0 * qy * dn2
        dqz = 2.0 * qz * dn2
        dqx = dqx + (qy * dM[0][1] + qz * dM[0][2] + qy * dM[1][0]
                     - 2.0 * qx * dM[1][1] - qw * dM[1][2] + qz * dM[2][0]
                     + qw * dM[2][1] - 2.0 * qx * dM[2][2])
        dqy = dqy + (-2.0 * qy * dM[0][0] + qx * dM[0][1] + qw * dM[0][2]
                     + qx * dM[1][0] + qz * dM[1][2] - qw * dM[2][0]
                     + qz * dM[2][1] - 2.0 * qy * dM[2][2])
        dqz = dqz + (-2.0 * qz * dM[0][0] - qw * dM[0][1] + qx * dM[0][2]
                     + qw * dM[1][0] - 2.0 * qz * dM[1][1] + qy * dM[1][2]
                     + qx * dM[2][0] + qy * dM[2][1])
        dqw = dqw + (-qz * dM[0][1] + qy * dM[0][2] + qz * dM[1][0]
                     - qx * dM[1][2] - qy * dM[2][0] + qx * dM[2][1])
        dq = torch.stack([dqw, dqx, dqy, dqz], -1)
    else:
        dq = torch.stack([zeros] * 4, -1)

    if update_FL:
        dfx = -da / (fx * fx) + dc * cx / (fx * fx)
        dfy = -db / (fy * fy) + dd * cy / (fy * fy)
        df = torch.stack([dfx * s_img, dfy * s_img]) / N  # (2,), every frame
        inside = ((e_fl >= MIN_FL) & (e_fl <= MAX_FL)).to(x.dtype)
        dlf = df[None, :] * inside * e_fl
    else:
        dlf = torch.stack([zeros] * 2, -1)

    return loss, count, torch.cat([dT, dq, dlf], -1)
