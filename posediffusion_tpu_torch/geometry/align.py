"""7-DoF (similarity) camera alignment, as in
``posediffusion_tpu.geometry.align``.

Find y = s * x @ Q + t (row vectors) that carries the source cameras onto the
target cameras: R_i' = Q^T R_i (orthogonal Procrustes over the rotations),
then scale and translation from the camera centres, T_i' = s T_i - t @ R_i'.
"""

from __future__ import annotations

import torch

from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, camera_center


def _procrustes_rotation(A: torch.Tensor) -> torch.Tensor:
    """Proper rotation M maximising trace(M A) (projection onto SO(3))."""
    U, _, Vt = torch.linalg.svd(A)
    det = torch.linalg.det((U @ Vt).T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), det]))
    return (U @ D @ Vt).T


def align_cameras(
    cameras_src: PerspectiveCameras,
    cameras_tgt: PerspectiveCameras,
    estimate_scale: bool = True,
    eps: float = 1e-9,
) -> PerspectiveCameras:
    """The source cameras re-expressed in the target world frame."""
    A = torch.einsum("nij,nkj->ik", cameras_src.R, cameras_tgt.R)
    M = _procrustes_rotation(A)
    R_aligned = torch.einsum("ij,njk->nik", M, cameras_src.R)

    c_src = camera_center(cameras_src) @ M.T
    c_tgt = camera_center(cameras_tgt)
    mu_src = c_src.mean(0)
    mu_tgt = c_tgt.mean(0)
    cs = c_src - mu_src
    ct = c_tgt - mu_tgt
    if estimate_scale:
        s = (cs * ct).sum() / (cs * cs).sum().clamp_min(eps)
    else:
        s = torch.ones((), dtype=cameras_src.R.dtype, device=cameras_src.R.device)
    t = mu_tgt - s * mu_src
    T_aligned = s * cameras_src.T - torch.einsum("j,njk->nk", t, R_aligned)
    return cameras_src.replace(R=R_aligned, T=T_aligned)
