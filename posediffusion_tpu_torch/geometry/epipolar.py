"""Essential and fundamental matrices and the Sampson epipolar error, as in
``posediffusion_tpu.geometry.epipolar``.

With OpenCV extrinsics (``x_cam = R x_world + t``) the fundamental matrix
between camera 1 and camera 2 satisfies ``p2^T F p1 = 0`` for pixel
homogeneous correspondences p1 <-> p2. Everything is differentiable with
``torch.autograd`` (the flat GGS route takes its gradient from it).
"""

from __future__ import annotations

from typing import Tuple

import torch

from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, cameras_to_opencv


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices of (..., 3) vectors: hat(v) @ w = v x w."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def essential_matrix(R1, t1, R2, t2) -> torch.Tensor:
    """E = R12 hat(-R12^T t12) with R12 = R2 R1^T, t12 = t2 - R12 t1."""
    R12 = R2 @ R1.transpose(-1, -2)
    t12 = t2 - (R12 @ t1[..., None])[..., 0]
    E_t = -(R12.transpose(-1, -2) @ t12[..., None])[..., 0]
    return R12 @ hat(E_t)


def fundamental_matrix(K1, R1, t1, K2, R2, t2) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, E) with F = K2^-T E K1^-1, so that p2^T F p1 = 0."""
    E = essential_matrix(R1, t1, R2, t2)
    F = torch.linalg.inv(K2).transpose(-1, -2) @ (E @ torch.linalg.inv(K1))
    return F, E


def _intrinsics_inverse(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    zero = torch.zeros_like(fx)
    inv_fx, inv_fy = 1.0 / fx, 1.0 / fy
    return torch.stack([
        torch.stack([inv_fx, zero, -cx * inv_fx], dim=-1),
        torch.stack([zero, inv_fy, -cy * inv_fy], dim=-1),
        torch.stack([zero, zero, torch.ones_like(fx)], dim=-1),
    ], dim=-2)


def get_fundamental_matrices(
    cam: PerspectiveCameras,
    height: int,
    width: int,
    index1: torch.Tensor,
    index2: torch.Tensor,
    l2_normalize_F: bool = False,
) -> torch.Tensor:
    """(P, 3, 3) fundamental matrices of the pairs (index1, index2), with
    ``p2^T F p1 = 0`` in pixels of a (height, width) image."""
    R_cv, t_cv, K = cameras_to_opencv(cam, (height, width))
    E = essential_matrix(R_cv[index1], t_cv[index1], R_cv[index2], t_cv[index2])
    K_inv = _intrinsics_inverse(K)
    F = K_inv[index2].transpose(-1, -2) @ (E @ K_inv[index1])
    if l2_normalize_F:
        F = F / torch.linalg.norm(F, dim=(-2, -1), keepdim=True).clamp_min(1e-4)
    return F


def sampson_distance(F: torch.Tensor, kp1_homo: torch.Tensor,
                     kp2_homo: torch.Tensor) -> torch.Tensor:
    """(M,) Sampson distances of (M, 3) homogeneous correspondences under
    per-match F (M, 3, 3) with the convention ``kp1^T F kp2 = 0``:
    (kp1^T F kp2)^2 / ((F^T kp1)_x^2 + (F^T kp1)_y^2 + (F kp2)_x^2 + (F kp2)_y^2).
    The denominator is floored at 1e-12, so a degenerate F = 0 (a padded
    match) gives 0 and not a NaN gradient."""
    left = torch.einsum("mi,mij->mj", kp1_homo, F)  # kp1^T F
    right = torch.einsum("mij,mj->mi", F, kp2_homo)  # F kp2
    top = torch.einsum("mj,mj->m", left, kp2_homo) ** 2
    bottom = left[:, 0] ** 2 + left[:, 1] ** 2 + right[:, 0] ** 2 + right[:, 1] ** 2
    return top / bottom.clamp_min(1e-12)
