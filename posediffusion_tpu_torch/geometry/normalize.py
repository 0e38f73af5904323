"""Canonical ground-truth cameras, as ``posediffusion_tpu.geometry.normalize``
(reference pose_diffusion/util/normalize_cameras.py:15-148):

1. move the world origin to the least-squares intersection of the optical
   axes;
2. scale the world so the first camera sits at distance 1;
3. optionally re-gauge so camera 0 has extrinsics [I | 0]
   (``first_camera``);
4. optionally rescale the translations (Re10K's ``normalize_T``).

The degenerate branch (the first camera on the intersection, scale 0) is a
select, as the JAX package's ``jnp.where``: no branch depends on the data.
"""

from __future__ import annotations

import torch

from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras, optical_axes
from posediffusion_tpu_torch.geometry.lines import intersect_skew_lines
from posediffusion_tpu_torch.utils.precision import highp


@highp
def compute_optical_axis_intersection(cam: PerspectiveCameras):
    """The intersection of the cameras' optical axes and its distance to
    each camera centre."""
    centers, directions = optical_axes(cam)
    p_intersect, _ = intersect_skew_lines(centers, directions)
    return p_intersect, (p_intersect[None, :] - centers).norm(dim=-1)


@highp
def first_camera_transform(cam: PerspectiveCameras,
                           rotation_only: bool = False) -> PerspectiveCameras:
    """Re-gauge the world so camera 0 has extrinsics [I | 0]: in the
    row-vector convention R_i' = R_0^T R_i and T_i' = T_i - T_0 R_i'."""
    new_R = torch.einsum("ij,njk->nik", cam.R[0].T, cam.R)
    if rotation_only:
        return cam.replace(R=new_R)
    return cam.replace(R=new_R, T=cam.T - torch.einsum("j,njk->nk", cam.T[0], new_R))


def normalize_translation_scale(cam: PerspectiveCameras) -> PerspectiveCameras:
    """Divide every T by clamp(|T[1:]| / sqrt(N - 1) / 2, 0.01, 100)
    (reference normalize_cameras.py:118-128)."""
    t = cam.T[1:]
    scale = t.norm() / torch.sqrt(torch.tensor(float(t.shape[0]), dtype=cam.T.dtype,
                                               device=cam.T.device))
    return cam.replace(T=cam.T / torch.clamp(scale / 2.0, 0.01, 100.0))


@highp
def normalize_cameras(cam: PerspectiveCameras, compute_optical: bool = True,
                      first_camera: bool = True, normalize_T: bool = False
                      ) -> PerspectiveCameras:
    """Canonicalise a camera batch (see the module docstring)."""
    fallback_scale = torch.sqrt(cam.T.norm().clamp_min(1e-12))
    if compute_optical:
        p_intersect, dist = compute_optical_axis_intersection(cam)
        scale = dist[0]
        # origin to the intersection: T_i + p R_i, over the first distance
        new_T = (cam.T + torch.einsum("j,njk->nk", p_intersect, cam.R)) / scale.clamp_min(1e-12)
        cam = cam.replace(T=torch.where(scale == 0, cam.T / fallback_scale, new_T))
    else:
        cam = cam.replace(T=cam.T / fallback_scale)
    if first_camera:
        cam = first_camera_transform(cam)
    if normalize_T:
        cam = normalize_translation_scale(cam)
    return cam
