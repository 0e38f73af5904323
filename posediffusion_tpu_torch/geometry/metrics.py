"""Absolute rotation error, as ``posediffusion_tpu.geometry.metrics.compute_are``."""

from __future__ import annotations

import math

import torch


def compute_are(rotation1: torch.Tensor, rotation2: torch.Tensor) -> torch.Tensor:
    """Per-camera angle of R1^T R2 in degrees, folded at 180."""
    R_rel = rotation1.transpose(-1, -2) @ rotation2
    cos = (R_rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    error = torch.arccos(cos.clamp(-1.0, 1.0)) * (180.0 / math.pi)
    return torch.minimum(error, (180.0 - error).abs())
