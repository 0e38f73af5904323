"""Pairwise relative-pose errors (Racc/Tacc/AUC, the AUC also in NumPy for
the evaluation) and the absolute rotation error, as
``posediffusion_tpu.geometry.metrics``."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
from posediffusion_tpu_torch.geometry.se3 import se3_inverse, se3_matrix


def batched_all_pairs(B: int, N: int) -> Tuple[np.ndarray, np.ndarray]:
    """All unordered frame pairs within each of B sequences of length N,
    as indices over the flat (B*N,) frame axis."""
    i1, i2 = np.triu_indices(N, k=1)
    offs = np.arange(B)[:, None] * N
    return (i1[None] + offs).reshape(-1), (i2[None] + offs).reshape(-1)


def _acos_linear_extrapolation(x: torch.Tensor, bound: float = 1.0 - 1e-4) -> torch.Tensor:
    """acos clamped to [-bound, bound], extrapolated linearly outside (as
    PyTorch3D's ``so3_relative_angle(eps=1e-4)``)."""
    inside = torch.arccos(x.clamp(-bound, bound))
    slope = -1.0 / math.sqrt(1.0 - bound * bound)
    upper = math.acos(bound) + (x - bound) * slope
    lower = math.acos(-bound) + (x + bound) * slope
    return torch.where(x > bound, upper, torch.where(x < -bound, lower, inside))


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between rotation batches (..., 3, 3), in degrees."""
    R12 = R1 @ R2.transpose(-1, -2)
    cos = (R12.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5
    return _acos_linear_extrapolation(cos) * (180.0 / math.pi)


def translation_angle_deg(t1: torch.Tensor, t2: torch.Tensor, eps: float = 1e-15,
                          default_err: float = 1e6) -> torch.Tensor:
    """Angle between translation directions (..., 3), in degrees; NaN or
    Inf become ``default_err``."""
    t1n = t1 / (t1.norm(dim=-1, keepdim=True) + eps)
    t2n = t2 / (t2.norm(dim=-1, keepdim=True) + eps)
    loss_t = torch.clamp(1.0 - (t1n * t2n).sum(-1) ** 2, min=eps)
    err = torch.arccos(torch.sqrt(1.0 - loss_t))
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, default_err))
    return err * (180.0 / math.pi)


def camera_to_rel_deg(pred: PerspectiveCameras, gt: PerspectiveCameras,
                      batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative rotation and translation errors (degrees) of every frame
    pair within each of ``batch_size`` sequences; cameras are flat."""
    gt_se3 = se3_matrix(gt.R, gt.T)
    pred_se3 = se3_matrix(pred.R, pred.T)
    i1, i2 = batched_all_pairs(batch_size, gt_se3.shape[0] // batch_size)
    i1, i2 = torch.as_tensor(i1, device=gt.R.device), torch.as_tensor(i2, device=gt.R.device)
    rel_gt = se3_inverse(gt_se3[i1]) @ gt_se3[i2]
    rel_pred = se3_inverse(pred_se3[i1]) @ pred_se3[i2]
    r_deg = rotation_angle_deg(rel_gt[:, :3, :3], rel_pred[:, :3, :3])
    t_deg = translation_angle_deg(rel_gt[:, 3, :3], rel_pred[:, 3, :3])
    return r_deg, t_deg


def calculate_auc(r_error: torch.Tensor, t_error: torch.Tensor,
                  max_threshold: int = 30,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """AUC@threshold: the mean of the cumulative histogram of max(r, t)
    errors over integer-degree bins (np.histogram's bins, the last closed),
    with optional per-pair weights (a 0/1 pair-validity mask)."""
    err = torch.maximum(r_error, t_error)
    w = torch.ones_like(err) if weights is None else weights.to(err.dtype)
    bins = torch.arange(max_threshold + 1, dtype=err.dtype, device=err.device)
    in_bin = (err[None] >= bins[:-1, None]) & (err[None] < bins[1:, None])
    hist = (in_bin * w[None]).sum(-1)
    last = (err >= bins[-2]) & (err <= bins[-1])
    hist[-1] = (last * w).sum()
    return torch.cumsum(hist / w.sum().clamp(min=1.0), 0).mean()


def calculate_auc_np(r_error, t_error, max_threshold: int = 30) -> float:
    """AUC@threshold in NumPy, for the evaluation's accumulated errors: the
    mean of the cumulative histogram of max(r, t) over integer-degree bins,
    ``np.histogram``'s last bin closed."""
    max_errors = np.maximum(np.asarray(r_error), np.asarray(t_error))
    histogram, _ = np.histogram(max_errors, bins=np.arange(max_threshold + 1))
    return float(np.mean(np.cumsum(histogram.astype(float) / len(max_errors))))


def compute_are(rotation1: torch.Tensor, rotation2: torch.Tensor) -> torch.Tensor:
    """Per-camera angle of R1^T R2 in degrees, folded at 180."""
    R_rel = rotation1.transpose(-1, -2) @ rotation2
    cos = (R_rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    error = torch.arccos(cos.clamp(-1.0, 1.0)) * (180.0 / math.pi)
    return torch.minimum(error, (180.0 - error).abs())
