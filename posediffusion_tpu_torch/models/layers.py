"""Building blocks of the denoiser, as in ``posediffusion_tpu.models.layers``.

Parameter names are those of the released checkpoint (the reference builds
its trunk from ``torch.nn.TransformerEncoderLayer``): packed
``self_attn.in_proj_weight``/``in_proj_bias``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``. The forwards are the
eval-mode (dropout-free) math of the pre-norm layer in plain PyTorch; the
sampler's hot path runs the same layers through the kernels instead
(``ops/denoiser_kernel.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from posediffusion_tpu_torch.ops.embeddings import (
    harmonic_embedding,
    sinusoidal_time_embedding,
)
from posediffusion_tpu_torch.ops.kernels import NEG


class TimeStepEmbedding(nn.Module):
    """Sinusoidal(256) -> Linear -> SiLU -> Linear -> 128."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.dim = dim
        self.linear = nn.Sequential(
            nn.Linear(dim, dim // 2), nn.SiLU(), nn.Linear(dim // 2, dim // 2)
        )

    @property
    def out_dim(self) -> int:
        return self.dim // 2

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.linear(sinusoidal_time_embedding(timesteps, self.dim))


class PoseEmbedding(nn.Module):
    """Harmonic embedding of pose encodings; no parameters."""

    def __init__(self, target_dim: int = 9, n_harmonic_functions: int = 10):
        super().__init__()
        self.target_dim = target_dim
        self.n_harmonic_functions = n_harmonic_functions

    @property
    def out_dim(self) -> int:
        return self.target_dim * (2 * self.n_harmonic_functions + 1)

    def forward(self, pose_encoding: torch.Tensor) -> torch.Tensor:
        return harmonic_embedding(pose_encoding, self.n_harmonic_functions)


class MLP(nn.Sequential):
    """(Linear, LayerNorm(eps 1e-5), ReLU) per hidden width, then a Linear:
    the head's keys are ``0``, ``1`` and ``3`` for one hidden layer."""

    def __init__(self, in_dim: int, hidden_channels: Sequence[int]):
        layers = []
        for dim in hidden_channels[:-1]:
            layers += [nn.Linear(in_dim, dim), nn.LayerNorm(dim, eps=1e-5), nn.ReLU()]
            in_dim = dim
        layers.append(nn.Linear(in_dim, hidden_channels[-1]))
        super().__init__(*layers)


def key_bias_from_mask(mask: Optional[torch.Tensor], B: int, N: int,
                       device) -> torch.Tensor:
    """(B, N) additive key bias: 0 for a valid frame, NEG for a masked one."""
    if mask is None:
        return torch.zeros((B, N), dtype=torch.float32, device=device)
    return torch.where(mask.to(torch.bool), 0.0, NEG).to(torch.float32)


class SelfAttention(nn.Module):
    """Packed-QKV multi-head self-attention (torch MultiheadAttention keys)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        Dh = D // self.nhead
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(B, N, 3, self.nhead, Dh).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)) * (1.0 / Dh**0.5) + key_bias[:, None, None, :]
        out = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, N, D)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm encoder layer (norm_first=True, ReLU), eval mode."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.self_attn = SelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), key_bias)
        return x + self.linear2(torch.relu(self.linear1(self.norm2(x))))


class TransformerEncoder(nn.Module):
    """Stack of pre-norm layers with no final norm."""

    def __init__(self, d_model: int = 512, nhead: int = 4,
                 num_encoder_layers: int = 8, dim_feedforward: int = 1024):
        super().__init__()
        self.nhead = nhead
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward)
            for _ in range(num_encoder_layers)
        )

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        key_bias = key_bias_from_mask(mask, x.shape[0], x.shape[1], x.device)
        for layer in self.layers:
            x = layer(x, key_bias)
        return x
