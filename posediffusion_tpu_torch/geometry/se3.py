"""SE(3) helpers in the row-vector convention, as in
``posediffusion_tpu.geometry.se3``: ``x_view = x_world @ R + T``, so the
4x4 matrix carries T in its last row, [[R, 0], [T, 1]]."""

from __future__ import annotations

import torch


def se3_matrix(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) row-vector SE3 matrices from R (..., 3, 3), T (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], T.shape[:-1])
    R = R.expand(batch + (3, 3))
    T = T.expand(batch + (3,))
    top = torch.cat([R, R.new_zeros(batch + (3, 1))], dim=-1)
    bottom = torch.cat([T[..., None, :], R.new_ones(batch + (1, 1))], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(se3: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse: [[R^T, 0], [-T R^T, 1]]."""
    R_t = se3[..., :3, :3].transpose(-1, -2)
    new_T = -(se3[..., 3:4, :3] @ R_t)
    top = torch.cat([R_t, se3[..., :3, 3:]], dim=-1)
    bottom = torch.cat([new_T, se3[..., 3:4, 3:]], dim=-1)
    return torch.cat([top, bottom], dim=-2)
