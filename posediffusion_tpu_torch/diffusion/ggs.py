"""Geometry-guided sampling (GGS), as in ``posediffusion_tpu.diffusion.ggs``.

Five SGD-with-momentum phases on the posterior mean (all parameters for
twice the iterations, focal length only, rotation only, translation only,
all parameters for twice the iterations), each minimising the mean Sampson
distance of the verified matches, with the adaptive clip
``max_norm = alpha * ||x * grad_mask|| / lr`` and a sticky stop once the
contributing matches per frame fall below ``min_matches``.

Two routes, picked by device as in the JAX package (``build_cond_fn``):
* CPU: the flat match layout (``MatchesData``) and ``_ggs_phase``, whose
  gradient comes from ``torch.autograd`` (``.detach()`` where JAX uses
  ``stop_gradient`` on the parameter blocks a phase does not update);
* CUDA: the pair-grouped layout and one kernel launch per phase
  (``geometry_guided_sampling_fused``): the one-block kernel while the
  table has at most ``RESIDENT_MAX_ELEMENTS`` entries, else the chunked
  kernel over a thread-block cluster.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from posediffusion_tpu_torch.geometry.epipolar import hat, sampson_distance
from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera
from posediffusion_tpu_torch.ops.ggs_grad import (
    GroupedMatches,
    ggs_tables,
    pack_matches_grouped,
    pad_grouped_pairs,
)
from posediffusion_tpu_torch.ops.ggs_kernel import default_chunk_pairs
from posediffusion_tpu_torch.ops.kernels import KERNELS, sgd_step

# (update_R, update_T, update_FL) of the five phases, in order
PHASES = ((True, True, True), (False, False, True), (True, False, False),
          (False, True, False), (True, True, True))


@dataclasses.dataclass(frozen=True)
class GGSConfig:
    """GGS hyperparameters (reference: cfgs/default.yaml:6-13)."""

    enable: bool = True
    start_step: int = 10
    learning_rate: float = 1e-2
    iter_num: int = 100
    sampson_max: float = 10.0
    min_matches: int = 10
    alpha: float = 1e-4
    momentum: float = 0.9
    pose_encoding_type: str = "absT_quaR_logFL"


@dataclasses.dataclass(frozen=True)
class MatchesData:
    """Padded flat matches of one sequence: kp1/kp2 (M, 3) homogeneous
    pixels; pair_i1/pair_i2 (P,) frames of the unique ordered pairs present
    (P = n(n-1)/2 slots, unused ones point at (0, 1)); pair_slot (M,) each
    match's pair; valid (M,) bool."""

    kp1: torch.Tensor
    kp2: torch.Tensor
    pair_i1: torch.Tensor
    pair_i2: torch.Tensor
    pair_slot: torch.Tensor
    valid: torch.Tensor


def pack_matches(kp1, kp2, i12, n_frames: int, pad_to: int, device=None) -> MatchesData:
    """Pad host-side matches to ``pad_to`` rows; padded keypoints are
    (0, 0, 1), never all zero (that would make the Sampson denominator 0)."""
    m = len(kp1)
    if m > pad_to:
        raise ValueError(f"pad_to={pad_to} < number of matches {m}")
    kp1h = np.concatenate([kp1, np.ones((m, 1), kp1.dtype)], axis=1)
    kp2h = np.concatenate([kp2, np.ones((m, 1), kp2.dtype)], axis=1)
    i12 = np.asarray(i12, np.int64)
    unique_flat, slot = np.unique(i12[:, 0] * n_frames + i12[:, 1], return_inverse=True)
    n_pairs = n_frames * (n_frames - 1) // 2
    if len(unique_flat) > n_pairs:
        raise ValueError("more unique pairs than n*(n-1)/2: expected a < b")
    pair_i1 = np.zeros(n_pairs, np.int64)
    pair_i2 = np.ones(n_pairs, np.int64)
    pair_i1[: len(unique_flat)] = unique_flat // n_frames
    pair_i2[: len(unique_flat)] = unique_flat % n_frames
    pad = pad_to - m
    kp1h = np.pad(kp1h, ((0, pad), (0, 0)))
    kp2h = np.pad(kp2h, ((0, pad), (0, 0)))
    kp1h[m:, 2] = 1.0
    kp2h[m:, 2] = 1.0
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return MatchesData(
        kp1=t(kp1h, torch.float32), kp2=t(kp2h, torch.float32),
        pair_i1=t(pair_i1, torch.long), pair_i2=t(pair_i2, torch.long),
        pair_slot=t(np.pad(slot.reshape(-1), (0, pad)), torch.long),
        valid=t(np.arange(pad_to) < m, torch.bool),
    )


def _ggs_pair_fundamentals(R, T, fl, image_hw: Tuple[int, int], pair_i1, pair_i2):
    """(P, 3, 3) fundamentals (kp1^T F kp2 = 0) of the pair table. The
    cameras share one calibration (zero principal point, tied focal
    length), so K^-1 is one closed-form 3x3."""
    h, w = image_hw
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=R.dtype, device=R.device)
    R_cv = (R * flip[None, None, :]).transpose(-1, -2)
    t_cv = T * flip[None, :]
    scale = min(h, w) / 2.0
    fx, fy = fl[0, 0] * scale, fl[0, 1] * scale
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K_inv = torch.stack([
        torch.stack([1.0 / fx, zero, -(w / 2.0) / fx]),
        torch.stack([zero, 1.0 / fy, -(h / 2.0) / fy]),
        torch.stack([zero, zero, one]),
    ])
    R1, t1 = R_cv[pair_i1], t_cv[pair_i1]
    R2, t2 = R_cv[pair_i2], t_cv[pair_i2]
    R12 = R2 @ R1.transpose(-1, -2)
    t12 = t2 - (R12 @ t1[..., None])[..., 0]
    E_t = -(R12.transpose(-1, -2) @ t12[..., None])[..., 0]
    F = K_inv.T @ ((R12 @ hat(E_t)) @ K_inv)  # p2^T F p1 = 0
    return F.transpose(-1, -2)


def _tied_cameras(model_mean):
    cam = pose_encoding_to_camera(model_mean)
    fl = cam.focal_length.mean(0, keepdim=True).expand_as(cam.focal_length)
    return cam, fl


def compute_sampson_loss(model_mean, matches: MatchesData, image_hw, update_R: bool,
                         update_T: bool, update_FL: bool, sampson_max: float):
    """(masked mean Sampson distance, number of contributing matches); the
    parameter blocks a phase does not update are detached."""
    cam, fl = _tied_cameras(model_mean)
    R = cam.R if update_R else cam.R.detach()
    T = cam.T if update_T else cam.T.detach()
    fl = fl if update_FL else fl.detach()
    F = _ggs_pair_fundamentals(R, T, fl, image_hw, matches.pair_i1, matches.pair_i2)
    samp = sampson_distance(F[matches.pair_slot], matches.kp1, matches.kp2)
    keep = matches.valid & (samp < sampson_max)
    count = keep.sum()
    loss = torch.where(keep, samp, 0.0).sum() / count.clamp_min(1)
    return loss, count


@torch.no_grad()
def sampson_report(model_mean, matches: MatchesData, image_hw,
                   sampson_max: float = 10.0) -> torch.Tensor:
    """Mean over all valid matches of the Sampson distance clamped at
    ``sampson_max``: the progress statistic the reference prints."""
    cam, fl = _tied_cameras(model_mean)
    F = _ggs_pair_fundamentals(cam.R, cam.T, fl, image_hw, matches.pair_i1,
                               matches.pair_i2)
    samp = sampson_distance(F[matches.pair_slot], matches.kp1, matches.kp2)
    clamped = samp.clamp_max(sampson_max)
    return torch.where(matches.valid, clamped, 0.0).sum() / matches.valid.sum().clamp_min(1)


def _ggs_phase(model_mean, matches: MatchesData, image_hw, cfg: GGSConfig,
               update_R: bool = True, update_T: bool = True,
               update_FL: bool = True) -> torch.Tensor:
    """One SGD (momentum) phase over the (B, N, 9) posterior mean, gradient
    from autograd."""
    iters = cfg.iter_num * (2 if (update_R and update_T and update_FL) else 1)
    x = model_mean.detach().clone()
    buf = torch.zeros_like(x)
    stopped = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(iters):
        with torch.enable_grad():
            xg = x.requires_grad_(True)
            loss, count = compute_sampson_loss(xg, matches, image_hw, update_R,
                                               update_T, update_FL, cfg.sampson_max)
            (g,) = torch.autograd.grad(loss, xg)
        x = x.detach()
        x, buf, stopped = sgd_step(x, buf, stopped, g, count, model_mean.shape[1],
                                   cfg.learning_rate, cfg.momentum, cfg.alpha,
                                   cfg.min_matches)
    return x


def geometry_guided_sampling(model_mean, t, matches: MatchesData, image_hw,
                             cfg: GGSConfig) -> torch.Tensor:
    """The five phases on the flat layout (``t`` is unused; it keeps the
    cond_fn signature)."""
    x = model_mean
    for uR, uT, uF in PHASES:
        x = _ggs_phase(x, matches, image_hw, cfg, update_R=uR, update_T=uT,
                       update_FL=uF)
    return x


# Up to this many table entries (P * Q) the one-block kernel; above it the
# cluster kernel, whose blocks each own a slice of the pairs. Measured by
# chip_smoke.py's route timings on an NVIDIA H100 80GB HBM3 (700 W power
# limit), one 200-iteration phase at 100 matches a pair (128 padded),
# one-block vs cluster: 3 frames (384 entries) 1.006 vs 1.280 ms, 4 (768)
# 1.141 vs 1.370, 5 (1,280) 1.305 vs 1.547, 6 (1,920) 1.686 vs 1.672 (a
# tie, kept on one block: it leaves 14 more SMs free), 8 (3,584) 2.173 vs
# 1.428, 10 (5,760) 2.923 vs 1.452, 20 (24,320) 9.406 vs 1.929 ms.
RESIDENT_MAX_ELEMENTS = 2048  # P * Q


def fused_fits(grouped) -> bool:
    """Whether a GroupedMatches layout runs the one-block kernel."""
    return grouped is not None and grouped.valid.numel() <= RESIDENT_MAX_ELEMENTS


@dataclasses.dataclass(frozen=True)
class GGSPlan:
    """The kernel variant, chunk and tables of one match set, built once."""

    resident: bool
    chunk: int
    tables: object  # ops.ggs_grad.GGSTables


def plan_ggs(grouped: GroupedMatches) -> GGSPlan:
    if fused_fits(grouped):
        return GGSPlan(True, 0, ggs_tables(grouped))
    chunk = default_chunk_pairs(grouped)
    return GGSPlan(False, chunk, ggs_tables(pad_grouped_pairs(grouped, chunk)))


def geometry_guided_sampling_fused(model_mean, t, grouped: GroupedMatches, image_hw,
                                   cfg: GGSConfig, plan: GGSPlan = None,
                                   ops=KERNELS) -> torch.Tensor:
    """The five phases, each ONE kernel launch (``ops/ggs_kernel.py``), on a
    single sequence (B == 1). ``ops=kernels.PLAIN`` runs the same phases in
    plain PyTorch on any device."""
    if model_mean.shape[0] != 1:
        raise ValueError(f"fused GGS conditions one sequence (B == 1), got "
                         f"B={model_mean.shape[0]}: use geometry_guided_sampling")
    plan = plan or plan_ggs(grouped)
    x = model_mean[0].to(torch.float32).contiguous()
    for uR, uT, uF in PHASES:
        kw = dict(iters=cfg.iter_num * (2 if (uR and uT and uF) else 1),
                  lr=cfg.learning_rate, momentum=cfg.momentum, alpha=cfg.alpha,
                  min_matches=float(cfg.min_matches))
        if plan.resident:
            x = ops.ggs_phase(x, plan.tables, image_hw, uR, uT, uF,
                              cfg.sampson_max, **kw)
        else:
            x = ops.ggs_phase_chunked(x, plan.tables, image_hw, uR, uT, uF,
                                      cfg.sampson_max, chunk=plan.chunk, **kw)
    return x[None]


def make_ggs_cond_fn(matches: MatchesData, image_hw, cfg: GGSConfig, grouped=None,
                     ops=KERNELS):
    """cond_fn(mean, t) for the sampler: the kernels when ``grouped`` is given
    and lies on a CUDA device (or ``ops`` on any device), else the flat
    autograd route."""
    if grouped is not None and (grouped.valid.is_cuda or ops is not KERNELS):
        plan = plan_ggs(grouped)
        return lambda mean, t: geometry_guided_sampling_fused(mean, t, grouped,
                                                              image_hw, cfg, plan, ops)
    return lambda mean, t: geometry_guided_sampling(mean, t, matches, image_hw, cfg)


def build_cond_fn(kp1, kp2, i12, n_frames: int, image_hw, cfg: GGSConfig, device):
    """Pack host matches into the one layout the device uses and build the
    cond_fn: grouped + kernels on a card, flat + autograd on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        grouped = pack_matches_grouped(kp1, kp2, i12, n_frames, device=device)
        return make_ggs_cond_fn(None, image_hw, cfg, grouped)
    pad_to = 1 << int(np.ceil(np.log2(max(len(kp1), 1))))
    matches = pack_matches(kp1, kp2, i12, n_frames, pad_to=pad_to, device=device)
    return make_ggs_cond_fn(matches, image_hw, cfg)
