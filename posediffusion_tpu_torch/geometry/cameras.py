"""NDC perspective cameras, as in ``posediffusion_tpu.geometry.cameras``.

Extrinsics are row-vector world-to-view (``x_view = x_world @ R + T``);
intrinsics are NDC focal lengths and principal points (the shorter image
side spans [-1, 1]; +X left, +Y up), projected as
``x_ndc = fx * x_view / z_view + px``. The intrinsics conversions between
NDC and pixels, for crops and resizes, are those the datasets use
(reference util/camera_transform.py:20-61).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from posediffusion_tpu_torch.geometry.se3 import se3_matrix
from posediffusion_tpu_torch.utils.precision import highp


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


def world_to_view_matrix(cam: PerspectiveCameras) -> torch.Tensor:
    """(N, 4, 4) row-vector SE3 world-to-view matrices."""
    return se3_matrix(cam.R, cam.T)


@highp
def camera_center(cam: PerspectiveCameras) -> torch.Tensor:
    """(N, 3) camera centres in world coordinates: C = -T @ R^T."""
    return -torch.einsum("nj,nkj->nk", cam.T, cam.R)


@highp
def unproject_ndc_points(cam: PerspectiveCameras, xy_depth: torch.Tensor) -> torch.Tensor:
    """Per-camera NDC points (N, 3) = (x_ndc, y_ndc, depth) -> world points:
    x_view = (x_ndc - px) depth / fx, then view -> world."""
    xy = (xy_depth[..., :2] - cam.principal_point) * xy_depth[..., 2:] / cam.focal_length
    view = torch.cat([xy, xy_depth[..., 2:]], dim=-1)
    return torch.einsum("nj,nkj->nk", view - cam.T, cam.R)


def optical_axes(cam: PerspectiveCameras) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-camera (centre, direction) of the optical axis through the
    principal point: the unprojection of (principal point, depth 1) less
    the centre."""
    centers = camera_center(cam)
    pp_depth1 = torch.cat([cam.principal_point, torch.ones_like(cam.principal_point[..., :1])],
                          dim=-1)
    return centers, unproject_ndc_points(cam, pp_depth1) - centers


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


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32)


def _half_and_rescale(image_size_wh):
    half = _f32(image_size_wh) / 2.0
    return half, half.amin(dim=-1, keepdim=half.ndim > 1)


def ndc_to_pixel_intrinsics(focal_length, principal_point, image_size_wh):
    """NDC intrinsics -> pixel (focal, principal point) of a (w, h) image."""
    half, rescale = _half_and_rescale(image_size_wh)
    return _f32(focal_length) * rescale, half - _f32(principal_point) * rescale


def pixel_to_ndc_intrinsics(focal_px, principal_px, image_size_wh):
    """Pixel intrinsics -> NDC (focal length, principal point) of a (w, h)
    image."""
    half, rescale = _half_and_rescale(image_size_wh)
    return _f32(focal_px) / rescale, (half - _f32(principal_px)) / rescale


def adjust_intrinsics_to_bbox_crop(focal_length, principal_point, image_size_wh, bbox_xywh):
    """NDC intrinsics of the full image -> NDC intrinsics of a bbox crop."""
    bbox_xywh = _f32(bbox_xywh)
    focal_px, principal_px = ndc_to_pixel_intrinsics(focal_length, principal_point,
                                                     image_size_wh)
    return pixel_to_ndc_intrinsics(focal_px, principal_px - bbox_xywh[..., :2],
                                   bbox_xywh[..., 2:])


def adjust_intrinsics_to_image_scale(focal_length, principal_point, original_size_wh,
                                     new_size_wh):
    """NDC intrinsics after resizing the image to ``new_size_wh``."""
    original_size_wh, new_size_wh = _f32(original_size_wh), _f32(new_size_wh)
    focal_px, principal_px = ndc_to_pixel_intrinsics(focal_length, principal_point,
                                                     original_size_wh)
    scale = (new_size_wh / original_size_wh).amin(dim=-1, keepdim=new_size_wh.ndim > 1)
    return pixel_to_ndc_intrinsics(focal_px * scale, principal_px * scale, new_size_wh)
