"""Pose denoiser, as in ``posediffusion_tpu.models.denoiser``.

Token layout per frame (702 dims; the order is the checkpoint's):

    [pose harmonic (sin 90 | cos 90 | x 9) | time emb 128 | z 384 | pivot 1]

with the pivot one-hot on frame 0, then Linear to d_model 512, an 8-layer
pre-norm encoder (4 heads, FF 1024) and the head 512 -> 128 (LN, ReLU) -> 9.
An optional (B, N) frame mask removes padded frames from the attention keys.

``denoiser_apply_fused`` is the inference forward of the GGS-conditioned
steps: embeddings, first projection and head in plain PyTorch, the trunk
through ``ops.denoiser_kernel.fused_trunk`` (the kernels on a card).
``denoiser_train_apply`` is the training forward, differentiable, with the
trunk in ``ops.vit_train_kernel.fused_encoder_trunk_train`` (dropout at the
four torch sites, the kernels on a card).
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
    key_bias_from_mask,
)
from posediffusion_tpu_torch.ops.denoiser_kernel import fused_trunk, stack_trunk_params
from posediffusion_tpu_torch.ops.vit_train_kernel import (
    fused_encoder_trunk_train,
    stack_encoder_trunk_params,
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

    def embed(self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Pose, time and image features -> the trunk's (B, N, d_model) input."""
        B, N, _ = x.shape
        t_emb = self.time_embed(t)[:, None, :].expand(B, N, -1)
        if self.pivot_cam_onehot:
            z = pivot_onehot(z)
        return self._first(torch.cat([self.pose_embed(x), t_emb, z], dim=-1))

    def forward(
        self,
        x: torch.Tensor,  # (B, N, target_dim) noisy pose encodings
        t: torch.Tensor,  # (B,) timesteps
        z: torch.Tensor,  # (B, N, z_dim) image features
        mask: Optional[torch.Tensor] = None,  # (B, N) frame validity
    ) -> torch.Tensor:
        return self._last(self._trunk(self.embed(x, t, z), mask=mask))


@torch.no_grad()
def denoiser_apply_fused(
    denoiser: Denoiser,
    x: torch.Tensor,  # (1, N, target_dim)
    t: torch.Tensor,  # (1,) timesteps
    z: torch.Tensor,  # (1, N, z_dim)
    mask: Optional[torch.Tensor] = None,  # (1, N) frame validity
    stacks: Optional[dict] = None,
    weight_dtype: torch.dtype = torch.bfloat16,
    trunk=fused_trunk,
) -> torch.Tensor:
    """``Denoiser.forward`` of one sequence with the trunk in ``fused_trunk``
    (``trunk=fused_trunk_plain``: plain PyTorch on any device). ``stacks``
    (from ``stack_trunk_params``) may be built once per sampling call; else
    they are stacked here in ``weight_dtype``."""
    B, N, _ = x.shape
    if B != 1:
        raise ValueError(f"the fused denoiser expects B == 1, got {B}")
    if stacks is None:
        stacks = stack_trunk_params(denoiser._trunk, weight_dtype)
    h = denoiser.embed(x, t, z)
    bias = key_bias_from_mask(mask, B, N, x.device)[0]
    h = trunk(h[0], bias, stacks, nhead=denoiser._trunk.nhead)
    return denoiser._last(h[None])


def denoiser_train_apply(
    denoiser: Denoiser,
    x: torch.Tensor,  # (B, N, target_dim) noisy pose encodings
    t: torch.Tensor,  # (B,) timesteps
    z: torch.Tensor,  # (B, N, z_dim) image features
    mask: Optional[torch.Tensor] = None,  # (B, N) frame validity
    seed: int = 0,
    dropout: float = 0.0,
    act_bf16: bool = False,
    residual_bf16: bool = False,
) -> torch.Tensor:
    """``Denoiser.forward`` for training, as the JAX package's
    ``denoiser_train_apply``: embeddings, first projection and head in plain
    PyTorch (autograd), the trunk in ``fused_encoder_trunk_train`` with
    dropout ``dropout`` drawn from ``seed``."""
    B, N, _ = x.shape
    h = fused_encoder_trunk_train(
        denoiser.embed(x, t, z), stack_encoder_trunk_params(denoiser._trunk),
        key_bias_from_mask(mask, B, N, x.device), seed=seed,
        nhead=denoiser._trunk.nhead, act_bf16=act_bf16,
        residual_bf16=residual_bf16, dropout=dropout,
    )
    return denoiser._last(h)
