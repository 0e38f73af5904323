"""Least-squares intersection of skew lines, as
``posediffusion_tpu.geometry.lines``: the point p minimising the summed
squared distance to lines (p_i, r_i) solves

    sum_i (I - r_i r_i^T) p = sum_i (I - r_i r_i^T) p_i

(reference pose_diffusion/util/normalize_cameras.py:24-41), here through the
pseudo-inverse, which batches and equals the least-squares solution where
the system has full rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from posediffusion_tpu_torch.utils.precision import highp


@highp
def intersect_skew_lines(
    p: torch.Tensor, r: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intersection (..., D) of the lines through points p (..., N, D) along
    r (..., N, D) (normalised here), and the normalised directions; lines
    whose ``mask`` (..., N) is 0 are left out."""
    dim = p.shape[-1]
    if mask is None:
        mask = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    r = r / r.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    eye = torch.eye(dim, dtype=p.dtype, device=p.device)
    proj = (eye - r[..., :, None] * r[..., None, :]) * mask[..., None, None]
    rhs = torch.einsum("...nij,...nj->...i", proj, p)
    lhs = proj.sum(dim=-3)
    return torch.einsum("...ij,...j->...i", torch.linalg.pinv(lhs), rhs), r


def point_line_distance(
    p1: torch.Tensor, r1: torch.Tensor, p2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance from points p2 to the lines (p1, r1), r1 unit, and the
    nearest points of the lines."""
    df = p2 - p1
    proj_vector = df - (df * r1).sum(dim=-1, keepdim=True) * r1
    return proj_vector.norm(dim=-1), p2 - proj_vector
