"""Pose denoiser, as in ``posediffusion_tpu.models.denoiser``.

Token layout per frame (702 dims; the order is the checkpoint's):

    [pose harmonic (sin 90 | cos 90 | x 9) | time emb 128 | z 384 | pivot 1]

with the pivot one-hot on frame 0, then Linear to d_model 512, an 8-layer
pre-norm encoder (4 heads, FF 1024) and the head 512 -> 128 (LN, ReLU) -> 9.
An optional (B, N) frame mask removes padded frames from the attention keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from posediffusion_tpu_torch.models.layers import (
    MLP,
    PoseEmbedding,
    TimeStepEmbedding,
    TransformerEncoder,
)


def pivot_onehot(z: torch.Tensor) -> torch.Tensor:
    """Append the (B, N, 1) column that is 1 on frame 0 and 0 elsewhere."""
    pivot = torch.zeros(z.shape[:-1] + (1,), dtype=z.dtype, device=z.device)
    pivot[:, 0] = 1.0
    return torch.cat([z, pivot], dim=-1)


class Denoiser(nn.Module):
    def __init__(
        self,
        target_dim: int = 9,
        pivot_cam_onehot: bool = True,
        z_dim: int = 384,
        mlp_hidden_dim: int = 128,
        d_model: int = 512,
        nhead: int = 4,
        num_encoder_layers: int = 8,
        dim_feedforward: int = 1024,
    ):
        super().__init__()
        self.target_dim = target_dim
        self.pivot_cam_onehot = pivot_cam_onehot
        self.time_embed = TimeStepEmbedding()
        self.pose_embed = PoseEmbedding(target_dim=target_dim)
        in_dim = (self.pose_embed.out_dim + self.time_embed.out_dim + z_dim
                  + int(pivot_cam_onehot))
        self._first = nn.Linear(in_dim, d_model)
        self._trunk = TransformerEncoder(
            d_model=d_model, nhead=nhead, num_encoder_layers=num_encoder_layers,
            dim_feedforward=dim_feedforward,
        )
        self._last = MLP(d_model, (mlp_hidden_dim, target_dim))

    def forward(
        self,
        x: torch.Tensor,  # (B, N, target_dim) noisy pose encodings
        t: torch.Tensor,  # (B,) timesteps
        z: torch.Tensor,  # (B, N, z_dim) image features
        mask: Optional[torch.Tensor] = None,  # (B, N) frame validity
    ) -> torch.Tensor:
        B, N, _ = x.shape
        t_emb = self.time_embed(t)[:, None, :].expand(B, N, -1)
        if self.pivot_cam_onehot:
            z = pivot_onehot(z)
        feed = torch.cat([self.pose_embed(x), t_emb, z], dim=-1)
        h = self._trunk(self._first(feed), mask=mask)
        return self._last(h)
