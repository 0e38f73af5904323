"""DDPM forward and reverse processes as plain functions, as in
``posediffusion_tpu.diffusion.gaussian``.

``p_losses`` is the training loss: noise x_0 to x_t (``q_sample``), predict
the noise (``pred_noise``) or x_0 (``pred_x0``), and return the unreduced
L1 or L2 error with x_0's prediction.

``p_sample_loop`` is the plain ancestral sampler over any denoiser
``model_fn(x, t) -> out``. It is the reference that the fused sampler
(``ops/sampler_kernel.py``) is tested against, and runs the GGS-conditioned
tail: ``x_init`` / ``from_t`` continue the fused sampler's chain, and for
t < ``cond_start_step`` the posterior mean passes through ``cond_fn`` and
the step takes no noise. ``ddim_sample_loop`` is DDIM over S of the T
timesteps. Randomness is injected (``x0``, ``noises``) or drawn from a
``torch.Generator``.
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


OBJECTIVES = ("pred_noise", "pred_x0")
LOSS_TYPES = ("l1", "l2")


def check_objective(objective: str) -> str:
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective}")
    return objective


def check_loss_type(loss_type: str) -> str:
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"invalid loss type {loss_type}")
    return loss_type


def predict_start_from_noise(schedule: DiffusionSchedule, x_t, t, noise):
    nd = x_t.ndim
    return (
        extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * noise
    )


def predict_noise_from_start(schedule: DiffusionSchedule, x_t, t, x0):
    nd = x_t.ndim
    return (
        extract(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0
    ) / extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd)


def p_losses(schedule: DiffusionSchedule, model_fn: ModelFn, x_start, t, noise,
             objective: str = "pred_noise", loss_type: str = "l1") -> DiffusionLoss:
    """The training loss, unreduced: the denoiser's output against the noise
    (``pred_noise``) or x_0 (``pred_x0``), by ``l1`` or ``l2``."""
    check_objective(objective)
    check_loss_type(loss_type)
    x = q_sample(schedule, x_start, t, noise)
    model_out = model_fn(x, t)
    if objective == "pred_noise":
        target = noise
        x_0_pred = predict_start_from_noise(schedule, x, t, model_out)
    else:
        target = x_start
        x_0_pred = model_out
    diff = model_out - target
    loss = diff.abs() if loss_type == "l1" else diff.square()
    return DiffusionLoss(loss=loss, noise=noise, x_0_pred=x_0_pred, x_t=x, t=t)


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


def p_mean_variance(schedule: DiffusionSchedule, model_fn: ModelFn, x, t,
                    objective: str = "pred_noise"):
    """One reverse step's posterior (mean, variance, log variance, x_start)
    from the denoiser's prediction of the noise or of x_0."""
    model_out = model_fn(x, t)
    if check_objective(objective) == "pred_noise":
        x_start = predict_start_from_noise(schedule, x, t, model_out)
    else:
        x_start = model_out
    mean, variance, log_variance = q_posterior(schedule, x_start, x, t)
    return mean, variance, log_variance, x_start


def _draws(shape, steps, device, generator, x0, noises):
    """The initial state and the (steps, *shape) raw normals, injected or
    drawn from ``generator``."""
    if x0 is None:
        x0 = torch.randn(tuple(shape), generator=generator, device=device)
    if noises is None:
        noises = torch.randn((steps, *shape), generator=generator, device=device)
    if noises.shape[0] != steps:
        raise ValueError(f"{noises.shape[0]} noise draws for {steps} steps")
    return x0, noises


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
    objective: str = "pred_noise",
    return_trajectory: bool = False,
):
    """Ancestral sampling over t = T-1 .. 0.

    ``x0`` is the initial draw and ``noises`` (R, *shape) the raw standard
    normals of the R steps in the order they run; either is drawn from
    ``generator`` when absent. The noise is zeroed at t = 0 and in the
    conditioned steps t < ``cond_start_step`` (when ``cond_fn`` is given),
    whose posterior mean is ``cond_fn(mean, t)``. ``x_init`` / ``from_t``
    start the chain at timestep ``from_t`` from state ``x_init`` (the steps
    [from_t, T) ran elsewhere). Returns x, or with ``return_trajectory``
    (x, the (R + 1, *shape) states with the start first).
    """
    check_objective(objective)
    schedule = schedule.to(device)
    T = schedule.num_timesteps
    if x_init is not None:
        if from_t is None:
            raise ValueError("x_init requires from_t")
        T, x0 = min(from_t, T), x_init
    x, noises = _draws(shape, T, device, generator, x0, noises)

    n_cond = min(max(cond_start_step, 0), T) if cond_fn is not None else 0
    B = shape[0]
    traj = [x]
    for i, t in enumerate(range(T - 1, -1, -1)):
        t_b = torch.full((B,), t, dtype=torch.long, device=device)
        mean, _, log_var, _ = p_mean_variance(schedule, model_fn, x, t_b, objective)
        if t < n_cond:
            mean = cond_fn(mean, t)
            noise = torch.zeros_like(x)
        else:
            noise = noises[i] if t > 0 else torch.zeros_like(x)
        x = mean + torch.exp(0.5 * log_var) * noise
        if return_trajectory:
            traj.append(x)
    return (x, torch.stack(traj)) if return_trajectory else x


def ddim_time_pairs(num_timesteps: int, sampling_timesteps: int) -> torch.Tensor:
    """(S, 2) int64 pairs (t, t_next), t descending, t_next = -1 last: the
    int32 truncation of ``jnp.linspace(-1, T - 1, S + 1)`` reversed, as the
    JAX package's ``ddim_sample_loop`` computes it inside a jitted sampler.
    XLA evaluates that linspace in float32 with the division by S made a
    product by r = fl(1 / S) and the stop's product reassociated:
    fl(-(1 - fl(i r)) + fl(i fl((T - 1) r))). The same float32 steps here
    give the same pairs for every S; a float64 or a plain float32
    linspace, or even JAX's un-jitted one, truncates differently at some
    boundaries (a plain float32 one gives 68 for 69 at T = 100, S = 10)."""
    S = int(sampling_timesteps)
    if S < 1:
        raise ValueError(f"sampling_timesteps must be >= 1, got {S}")
    f32 = torch.float32
    r = torch.tensor(1.0, dtype=f32) / torch.tensor(float(S), dtype=f32)
    stop = torch.tensor(float(num_timesteps - 1), dtype=f32)
    i = torch.arange(S, dtype=f32)
    times = torch.cat([-(1 - i * r) + i * (stop * r), stop[None]])
    t_seq = times.to(torch.int32).flip(0).to(torch.long)
    return torch.stack([t_seq[:-1], t_seq[1:]], dim=1)


def ddim_sample_loop(
    schedule: DiffusionSchedule,
    model_fn: ModelFn,
    shape: Sequence[int],
    device: torch.device,
    sampling_timesteps: int,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    x0: Optional[torch.Tensor] = None,
    noises: Optional[torch.Tensor] = None,
    cond_fn: Optional[CondFn] = None,
    cond_start_step: int = 0,
    objective: str = "pred_noise",
) -> torch.Tensor:
    """DDIM (Song et al. 2020) over S = ``sampling_timesteps`` of the T
    timesteps (``ddim_time_pairs``); ``eta`` 0 is deterministic.

    Per step: x_0 and eps from the denoiser's output, then
    sigma = eta sqrt((1 - a') / (1 - a)) sqrt(1 - a / a'),
    mean = sqrt(a') x_0 + sqrt(1 - a' - sigma^2) eps with a = acp[t] and
    a' = acp[t_next] (1 at t_next = -1), x = mean + sigma noise. The noise
    is zero at the last step (t_next < 0) and in the conditioned steps
    t < ``cond_start_step``, whose mean is ``cond_fn(mean, t)``. ``x0`` and
    ``noises`` (S, *shape, in step order) are the draws, else drawn from
    ``generator``.
    """
    check_objective(objective)
    schedule = schedule.to(device)
    pairs = ddim_time_pairs(schedule.num_timesteps, sampling_timesteps).tolist()
    x, noises = _draws(shape, len(pairs), device, generator, x0, noises)
    acp = torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                     schedule.alphas_cumprod.to(torch.float32)])
    B = shape[0]
    for i, (t, t_next) in enumerate(pairs):
        t_b = torch.full((B,), t, dtype=torch.long, device=device)
        model_out = model_fn(x, t_b)
        if objective == "pred_noise":
            eps = model_out
            x_start = predict_start_from_noise(schedule, x, t_b, eps)
        else:
            x_start = model_out
            eps = predict_noise_from_start(schedule, x, t_b, x_start)
        a_t, a_next = acp[t + 1], acp[t_next + 1]
        sigma = (eta * torch.sqrt((1 - a_next) / torch.clamp(1 - a_t, min=1e-12))
                 * torch.sqrt(torch.clamp(1 - a_t / a_next, min=0.0)))
        dir_xt = torch.sqrt(torch.clamp(1 - a_next - sigma**2, min=0.0)) * eps
        mean = torch.sqrt(a_next) * x_start + dir_xt
        conditioned = cond_fn is not None and t < cond_start_step
        if conditioned:
            mean = cond_fn(mean, t)
        noise = noises[i] if t_next >= 0 and not conditioned else torch.zeros_like(x)
        x = mean + sigma * noise
    return x
