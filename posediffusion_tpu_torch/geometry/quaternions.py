"""Quaternion (wxyz) to rotation matrix, as in
``posediffusion_tpu.geometry.quaternions``."""

from __future__ import annotations

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3). The 2 / |q|^2 scale normalises the
    quaternion implicitly, so non-unit inputs still give rotations."""
    w, x, y, z = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    m = torch.stack(
        [
            1.0 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1.0 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1.0 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(quaternions.shape[:-1] + (3, 3))
