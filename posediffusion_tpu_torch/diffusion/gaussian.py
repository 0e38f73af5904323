"""DDPM forward and reverse processes as plain functions, as in
``posediffusion_tpu.diffusion.gaussian``.

``p_losses`` is the training loss: noise x_0 to x_t (``q_sample``), predict
the noise, and return the unreduced L1 error with x_0's prediction.

``p_sample_loop`` is the plain ancestral sampler over any denoiser
``model_fn(x, t) -> eps``. It is the reference that the fused sampler
(``ops/sampler_kernel.py``) is tested against, and runs the GGS-conditioned
tail: ``x_init`` / ``from_t`` continue the fused sampler's chain, and for
t < ``cond_start_step`` the posterior mean passes through ``cond_fn`` and
the step takes no noise. Randomness is injected (``x0``, ``noises``) or
drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from posediffusion_tpu_torch.diffusion.schedule import DiffusionSchedule, extract

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
CondFn = Callable[[torch.Tensor, int], torch.Tensor]


class DiffusionLoss(NamedTuple):
    loss: torch.Tensor  # unreduced, the shape of x
    noise: torch.Tensor
    x_0_pred: torch.Tensor
    x_t: torch.Tensor
    t: torch.Tensor


def q_sample(schedule: DiffusionSchedule, x_start, t, noise):
    """Forward diffusion: x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps."""
    nd = x_start.ndim
    return (
        extract(schedule.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def p_losses(schedule: DiffusionSchedule, model_fn: ModelFn, x_start, t,
             noise) -> DiffusionLoss:
    """The training loss of the pred_noise objective with an L1 loss
    (the reference config's), unreduced."""
    x = q_sample(schedule, x_start, t, noise)
    model_out = model_fn(x, t)
    x_0_pred = predict_start_from_noise(schedule, x, t, model_out)
    return DiffusionLoss(loss=(model_out - noise).abs(), noise=noise,
                         x_0_pred=x_0_pred, x_t=x, t=t)


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


def p_mean_variance(schedule: DiffusionSchedule, model_fn: ModelFn, x, t):
    """One reverse step's posterior (mean, variance, log variance, x_start)
    from the denoiser's noise prediction."""
    x_start = predict_start_from_noise(schedule, x, t, model_fn(x, t))
    mean, variance, log_variance = q_posterior(schedule, x_start, x, t)
    return mean, variance, log_variance, x_start


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
    cond_fn: Optional[CondFn] = None,
    cond_start_step: int = 0,
) -> torch.Tensor:
    """Ancestral sampling over t = T-1 .. 0 (pred_noise objective).

    ``x0`` is the initial draw and ``noises`` (R, *shape) the raw standard
    normals of the R steps in the order they run; either is drawn from
    ``generator`` when absent. The noise is zeroed at t = 0 and in the
    conditioned steps t < ``cond_start_step`` (when ``cond_fn`` is given),
    whose posterior mean is ``cond_fn(mean, t)``. ``x_init`` / ``from_t``
    start the chain at timestep ``from_t`` from state ``x_init`` (the steps
    [from_t, T) ran elsewhere).
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

    n_cond = min(max(cond_start_step, 0), T) if cond_fn is not None else 0
    B = shape[0]
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_b = torch.full((B,), t, dtype=torch.long, device=device)
        mean, _, log_var, _ = p_mean_variance(schedule, model_fn, x, t_b)
        if t < n_cond:
            mean = cond_fn(mean, t)
            noise = torch.zeros_like(x)
        else:
            noise = noises[i] if t > 0 else torch.zeros_like(x)
        x = mean + torch.exp(0.5 * log_var) * noise
    return x
