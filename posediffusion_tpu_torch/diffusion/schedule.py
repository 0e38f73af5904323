"""DDPM beta schedules and their derived coefficients.

As ``posediffusion_tpu.diffusion.schedule``: buffers are computed in float64
and stored as float32. The default is the reference's ``custom`` schedule,
linspace(1e-4, 0.1, 100).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SCHEDULE_BUFFER_NAMES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "p2_loss_weight",
)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def buffers(self) -> dict:
        return {n: getattr(self, n) for n in SCHEDULE_BUFFER_NAMES}

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(**{n: v.to(device) for n, v in self.buffers().items()})


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    acp = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    acp = acp / acp[0]
    return np.clip(1 - (acp[1:] / acp[:-1]), 0, 0.999)


def custom_beta_schedule(
    timesteps: int, beta_1: float = 1e-4, beta_T: float = 0.1
) -> np.ndarray:
    return np.linspace(beta_1, beta_T, timesteps, dtype=np.float64)


def make_schedule(
    timesteps: int = 100,
    beta_1: float = 1e-4,
    beta_T: float = 0.1,
    beta_schedule: str = "custom",
    p2_loss_weight_gamma: float = 0.0,
    p2_loss_weight_k: float = 1.0,
) -> DiffusionSchedule:
    if beta_schedule == "linear":
        betas = linear_beta_schedule(timesteps)
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(timesteps)
    elif beta_schedule == "custom":
        betas = custom_beta_schedule(timesteps, beta_1, beta_T)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")

    alphas = 1.0 - betas
    acp = np.cumprod(alphas, axis=0)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64).astype(np.float32))

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(np.log(np.clip(post_var, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        p2_loss_weight=f32(
            (p2_loss_weight_k + acp / (1 - acp)) ** -p2_loss_weight_gamma
        ),
    )


def extract(a: torch.Tensor, t: torch.Tensor, broadcast_ndim: int) -> torch.Tensor:
    """a[t] for t (B,), reshaped to (B, 1, ..., 1) with ``broadcast_ndim`` dims."""
    out = a[t]
    return out.reshape(out.shape[0], *([1] * (broadcast_ndim - 1)))
