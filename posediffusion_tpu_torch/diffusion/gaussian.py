"""DDPM reverse process as plain functions, as in
``posediffusion_tpu.diffusion.gaussian``.

``p_sample_loop`` is the plain ancestral sampler over any denoiser
``model_fn(x, t) -> eps``. It is the reference that the fused sampler
(``ops/sampler_kernel.py``) is tested against, and keeps the ``x_init`` /
``from_t`` hooks with which a later conditioned tail continues a chain.
Randomness is injected (``x0``, ``noises``) or drawn from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from posediffusion_tpu_torch.diffusion.schedule import DiffusionSchedule, extract

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def predict_start_from_noise(schedule: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (
        extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def q_posterior(
    schedule: DiffusionSchedule, x_start, x_t, t
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Posterior q(x_{t-1} | x_t, x_0): (mean, variance, clipped log variance)."""
    nd = x_t.ndim
    mean = (
        extract(schedule.posterior_mean_coef1, t, nd) * x_start
        + extract(schedule.posterior_mean_coef2, t, nd) * x_t
    )
    variance = extract(schedule.posterior_variance, t, nd)
    log_variance = extract(schedule.posterior_log_variance_clipped, t, nd)
    return mean, variance, log_variance


def p_sample_loop(
    schedule: DiffusionSchedule,
    model_fn: ModelFn,
    shape: Sequence[int],
    device: torch.device,
    generator: Optional[torch.Generator] = None,
    x0: Optional[torch.Tensor] = None,
    noises: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    from_t: Optional[int] = None,
) -> torch.Tensor:
    """Ancestral sampling over t = T-1 .. 0 (pred_noise objective).

    ``x0`` is the initial draw and ``noises`` (R, *shape) the raw standard
    normals of the R steps in the order they run; either is drawn from
    ``generator`` when absent. The noise is zeroed at t = 0. ``x_init`` /
    ``from_t`` start the chain at timestep ``from_t`` from state ``x_init``
    (the steps [from_t, T) ran elsewhere).
    """
    schedule = schedule.to(device)
    T = schedule.num_timesteps
    if x_init is not None:
        if from_t is None:
            raise ValueError("x_init requires from_t")
        x, T = x_init, min(from_t, T)
    elif x0 is not None:
        x = x0
    else:
        x = torch.randn(tuple(shape), generator=generator, device=device)
    if noises is None:
        noises = torch.randn((T, *shape), generator=generator, device=device)
    if noises.shape[0] != T:
        raise ValueError(f"{noises.shape[0]} noise draws for {T} steps")

    B = shape[0]
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_b = torch.full((B,), t, dtype=torch.long, device=device)
        eps = model_fn(x, t_b)
        x_start = predict_start_from_noise(schedule, x, t_b, eps)
        mean, _, log_var = q_posterior(schedule, x_start, x, t_b)
        noise = noises[i] if t > 0 else torch.zeros_like(x)
        x = mean + torch.exp(0.5 * log_var) * noise
    return x
