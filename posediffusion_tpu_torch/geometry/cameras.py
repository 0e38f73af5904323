"""NDC perspective cameras, as in ``posediffusion_tpu.geometry.cameras``.

Extrinsics are row-vector world-to-view (``x_view = x_world @ R + T``);
intrinsics are NDC focal lengths and principal points.
"""

from __future__ import annotations

import dataclasses

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
