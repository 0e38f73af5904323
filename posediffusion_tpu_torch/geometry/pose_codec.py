"""Pose encoding ``absT_quaR_logFL`` -> cameras, as in
``posediffusion_tpu.geometry.pose_codec``: 9 dims per frame are T (3),
quaternion wxyz (4) and log focal length (2), with a log-FL bias of 1.8 and
the focal length clamped to [0.1, 20]."""

from __future__ import annotations

import torch

from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
from posediffusion_tpu_torch.geometry.quaternions import quaternion_to_matrix

POSE_DIM = 9
LOG_FL_BIAS = 1.8
MIN_FL = 0.1
MAX_FL = 20.0


def pose_encoding_to_camera(
    pose_encoding: torch.Tensor,
    pose_encoding_type: str = "absT_quaR_logFL",
    log_focal_length_bias: float = LOG_FL_BIAS,
    min_focal_length: float = MIN_FL,
    max_focal_length: float = MAX_FL,
) -> PerspectiveCameras:
    """Decode (..., 9) encodings into a flat batch of cameras."""
    if pose_encoding_type != "absT_quaR_logFL":
        raise ValueError(f"Unknown pose encoding {pose_encoding_type}")
    enc = pose_encoding.reshape(-1, pose_encoding.shape[-1])
    focal = torch.exp(enc[:, 7:9] + log_focal_length_bias)
    focal = focal.clamp(min_focal_length, max_focal_length)
    return PerspectiveCameras(
        R=quaternion_to_matrix(enc[:, 3:7]),
        T=enc[:, :3],
        focal_length=focal,
        principal_point=torch.zeros_like(focal),
    )
