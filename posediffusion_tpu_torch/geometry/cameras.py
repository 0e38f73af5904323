"""NDC perspective cameras, as in ``posediffusion_tpu.geometry.cameras``.

Extrinsics are row-vector world-to-view (``x_view = x_world @ R + T``);
intrinsics are NDC focal lengths and principal points.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PerspectiveCameras:
    """Batch of N cameras: R (N, 3, 3), T (N, 3), focal_length (N, 2),
    principal_point (N, 2)."""

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor

    @classmethod
    def create(cls, R, T, focal_length=None, principal_point=None, device=None):
        """Build float32 cameras; a (N,) or (N, 1) focal length is broadcast
        to (N, 2), and the principal point defaults to 0."""
        kw = dict(dtype=torch.float32, device=device)
        R = torch.as_tensor(R, **kw)
        n = R.shape[0]
        fl = torch.ones((n, 2), **kw) if focal_length is None else torch.as_tensor(
            focal_length, **kw
        )
        fl = fl.reshape(n, -1).expand(n, 2)
        pp = (torch.zeros((n, 2), **kw) if principal_point is None
              else torch.as_tensor(principal_point, **kw))
        return cls(R=R, T=torch.as_tensor(T, **kw), focal_length=fl.contiguous(),
                   principal_point=pp)

    def replace(self, **changes) -> "PerspectiveCameras":
        return dataclasses.replace(self, **changes)


def camera_center(cam: PerspectiveCameras) -> torch.Tensor:
    """(N, 3) camera centres in world coordinates: C = -T @ R^T."""
    return -torch.einsum("nj,nkj->nk", cam.T, cam.R)


def cameras_to_opencv(
    cam: PerspectiveCameras, image_size_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NDC cameras -> OpenCV (R_cv (N, 3, 3), t_cv (N, 3), pixel K (N, 3, 3)):
    negate the x and y axes, transpose R to the column-vector convention
    (``x_cam = R_cv x_world + t_cv``), and map NDC intrinsics to pixels with
    ``scale = min(h, w) / 2``: f_px = f * scale, c_px = -p * scale + (w/2, h/2)."""
    h, w = image_size_hw
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=cam.R.dtype, device=cam.R.device)
    R_cv = (cam.R * flip[None, None, :]).transpose(-1, -2)
    t_cv = cam.T * flip[None, :]
    scale = min(h, w) / 2.0
    c0 = torch.tensor([w / 2.0, h / 2.0], dtype=cam.R.dtype, device=cam.R.device)
    principal_px = -cam.principal_point * scale + c0
    focal_px = cam.focal_length * scale
    zeros = torch.zeros_like(focal_px[:, 0])
    K = torch.stack([
        torch.stack([focal_px[:, 0], zeros, principal_px[:, 0]], dim=-1),
        torch.stack([zeros, focal_px[:, 1], principal_px[:, 1]], dim=-1),
        torch.stack([zeros, zeros, torch.ones_like(zeros)], dim=-1),
    ], dim=-2)
    return R_cv, t_cv, K
