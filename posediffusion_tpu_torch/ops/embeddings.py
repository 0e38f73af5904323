"""Harmonic and sinusoidal-timestep embeddings.

Same layouts as ``posediffusion_tpu.ops.embeddings``: the checkpoint's first
projection consumes these features by position.
"""

from __future__ import annotations

import math

import torch


def harmonic_embedding(x: torch.Tensor, n_harmonic_functions: int = 10) -> torch.Tensor:
    """(..., D) -> (..., D * (2 n + 1)): [sin block | cos block | x], each
    block dim-major and frequency-minor, frequencies 2^0 .. 2^(n-1)
    (PyTorch3D's HarmonicEmbedding with logspace, omega_0 = 1)."""
    freqs = 2.0 ** torch.arange(n_harmonic_functions, dtype=x.dtype, device=x.device)
    embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(embed), torch.cos(embed), x], dim=-1)


def sinusoidal_time_embedding(
    timesteps: torch.Tensor, dim: int = 256, max_period: float = 10000.0
) -> torch.Tensor:
    """(B,) -> (B, dim): cos block then sin block (guided-diffusion layout)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
