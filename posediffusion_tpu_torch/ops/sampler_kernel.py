"""All DDPM reverse steps of the denoiser on the kernels, as
``posediffusion_tpu.ops.sampler_kernel.fused_sample_loop``.

The TPU kernel runs a (steps x layers) sequential grid in one Pallas launch,
step r's head and step r+1's first projection as consecutive grid
iterations. Here a host loop launches ``sampler_prologue`` once (the
harmonic embedding and the 702 -> 512 projection with the first weight
split by input rows: sin(xE) W_sin + cos(xE) W_cos + x W_x + zf + tc), then
for each step ``encoder_layer_math`` for each of the L layers and
``sampler_boundary`` (head MLP and the posterior update in place, then the
next step's prologue, in one launch), ``sampler_epilogue`` at the last step.
That is 1 + 5 L launches per step (41 at L = 8; the LayerNorms ride the
products at up to 32 rows, 1 + 7 L above), one more in all, and nothing
else: the noise, the
per-step scalars (cx, ce), sigma (0 at t = 0), the time-embedding
projection tc, the feature projection zf and the weight stacks are computed
once before the loop, as the JAX wrapper computes them outside its
``pallas_call``.

The kernel's update, x <- cx x - ce out + sigma noise, is linear in x and
the denoiser's output for both objectives: ``pred_noise`` (x_0 = a x - b out,
mean = c1 x_0 + c2 x) takes (cx, ce) = (c1 a + c2, c1 b), ``pred_x0``
(x_0 = out) takes (c2, -c1). The JAX package's TPU kernel bakes in the
first pair whatever the objective (posediffusion_tpu/ops/sampler_kernel.py
:27-31); here the objective picks the pair, so the whole-loop sampler
samples ``pred_x0`` as ``p_sample_loop`` does.

Randomness: ``x0`` (B, N, T) and ``noises`` (R, B, N, T) are raw standard
normals, injected or drawn from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from posediffusion_tpu_torch.diffusion.gaussian import check_objective
from posediffusion_tpu_torch.diffusion.schedule import DiffusionSchedule
from posediffusion_tpu_torch.models.denoiser import pivot_onehot
from posediffusion_tpu_torch.models.layers import key_bias_from_mask
from posediffusion_tpu_torch.ops.denoiser_kernel import (
    encoder_layer_math,
    layer_weights,
    stack_trunk_params,
)
from posediffusion_tpu_torch.ops.kernels import KERNELS, PLAIN


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


@dataclasses.dataclass(frozen=True)
class SamplerInputs:
    """Everything the per-step launches read, computed once per call."""

    shape: Tuple[int, int, int]  # (B, N, T)
    x0: torch.Tensor  # (B*N, T) state before the first step
    prologue: Tuple[torch.Tensor, ...]  # wsin, wcos, wx, zf, tc
    layers: List[tuple]  # per-layer weights, encoder_layer_math order
    key_bias: torch.Tensor  # (B, N)
    nhead: int
    head: Tuple[torch.Tensor, ...]  # w0, b0, gh, bh, w1, b1
    head_eps: float
    coef: torch.Tensor  # (R, 2): cx, ce per step
    noise: torch.Tensor  # (R, B*N, T), sigma-scaled

    @property
    def steps(self) -> int:
        return self.coef.shape[0]


@torch.no_grad()
def prepare_sampler(
    denoiser,
    schedule: DiffusionSchedule,
    z: torch.Tensor,  # (B, N, z_dim) image features
    mask: Optional[torch.Tensor] = None,  # (B, N) frame validity
    n_cond: int = 0,
    weight_dtype: torch.dtype = torch.bfloat16,
    x0: Optional[torch.Tensor] = None,
    noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    objective: str = "pred_noise",
) -> SamplerInputs:
    """Draw (or take) the noise and compute everything the steps
    t = T-1 .. n_cond read: per-step scalars (those of ``objective``), the
    row-split first projection, tc, zf, the head and the trunk weight
    stacks."""
    check_objective(objective)
    B, N, _ = z.shape
    device = z.device
    TD = denoiser.target_dim
    HH = TD * denoiser.pose_embed.n_harmonic_functions
    rows = B * N
    tds = torch.arange(schedule.num_timesteps - 1, n_cond - 1, -1, device=device)
    R = tds.shape[0]
    if x0 is None:
        x0 = torch.randn((B, N, TD), generator=generator, device=device)
    if noises is None:
        noises = torch.randn((R, B, N, TD), generator=generator, device=device)
    if tuple(x0.shape) != (B, N, TD) or tuple(noises.shape) != (R, B, N, TD):
        raise ValueError(f"x0 {tuple(x0.shape)} / noises {tuple(noises.shape)} "
                         f"do not fit {R} steps of ({B}, {N}, {TD})")

    # ---- per-step scalars and sigma-scaled noise
    s = schedule.to(device)
    c1, c2 = s.posterior_mean_coef1[tds], s.posterior_mean_coef2[tds]
    a, b = s.sqrt_recip_alphas_cumprod[tds], s.sqrt_recipm1_alphas_cumprod[tds]
    sigma = torch.exp(0.5 * s.posterior_log_variance_clipped[tds])
    sigma = torch.where(tds > 0, sigma, torch.zeros_like(sigma))
    if objective == "pred_noise":
        coef = torch.stack([c1 * a + c2, c1 * b], dim=-1).contiguous()
    else:
        coef = torch.stack([c2, -c1], dim=-1).contiguous()
    noise = (noises.to(torch.float32) * sigma[:, None, None, None]).reshape(R, rows, TD)

    # ---- first projection split by input rows
    Wf = _f32(denoiser._first.weight.t())  # (in_dim, D)
    off = 2 * HH + TD
    t_dim = denoiser.time_embed.out_dim
    tc = denoiser.time_embed(tds) @ Wf[off:off + t_dim] + _f32(denoiser._first.bias)
    z2 = z.to(torch.float32)
    if denoiser.pivot_cam_onehot:
        z2 = pivot_onehot(z2)
    zf = (z2 @ Wf[off + t_dim:]).reshape(rows, -1)
    prologue = tuple(t.contiguous() for t in (Wf[:HH], Wf[HH:2 * HH], Wf[2 * HH:off], zf, tc))

    lin0, norm, lin1 = denoiser._last[0], denoiser._last[1], denoiser._last[3]
    return SamplerInputs(
        shape=(B, N, TD),
        x0=x0.to(torch.float32).reshape(rows, TD).contiguous(),
        prologue=prologue,
        layers=layer_weights(stack_trunk_params(denoiser._trunk, weight_dtype)),
        key_bias=key_bias_from_mask(mask, B, N, device).contiguous(),
        nhead=denoiser._trunk.nhead,
        head=tuple(_f32(t) for t in (lin0.weight.t(), lin0.bias, norm.weight,
                                     norm.bias, lin1.weight.t(), lin1.bias)),
        head_eps=norm.eps,
        coef=coef,
        noise=noise.contiguous(),
    )


@torch.no_grad()
def run_sampler(inp: SamplerInputs, ops=KERNELS) -> torch.Tensor:
    """The host loop: the prologue of step 0; per step the trunk layers,
    then the boundary into the next step (the epilogue at the last).
    ``ops`` is ``kernels.KERNELS`` or ``kernels.PLAIN``."""
    B, N, TD = inp.shape
    x = inp.x0.clone()
    if inp.steps == 0:
        return x.view(B, N, TD)
    h = ops.sampler_prologue(x, *inp.prologue, 0)
    for r in range(inp.steps):
        for w in inp.layers:
            h = encoder_layer_math(h, *w, nhead=inp.nhead, seq_len=N, eps=1e-5,
                                   act="relu", key_bias=inp.key_bias, ops=ops)
        if r + 1 < inp.steps:
            h = ops.sampler_boundary(h, *inp.head, inp.coef, inp.noise, x, r,
                                     *inp.prologue, inp.head_eps)
        else:
            ops.sampler_epilogue(h, *inp.head, inp.coef, inp.noise, x, r, inp.head_eps)
    return x.view(B, N, TD)


@torch.no_grad()
def fused_sample_loop(
    denoiser,
    schedule: DiffusionSchedule,
    z: torch.Tensor,  # (B, N, z_dim) image features
    mask: Optional[torch.Tensor] = None,  # (B, N) frame validity
    n_cond: int = 0,
    weight_dtype: torch.dtype = torch.bfloat16,
    x0: Optional[torch.Tensor] = None,
    noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    objective: str = "pred_noise",
) -> torch.Tensor:
    """Run reverse steps t = T-1 .. n_cond through the kernel wrappers and
    return the (B, N, T) pose state."""
    return run_sampler(prepare_sampler(denoiser, schedule, z, mask, n_cond, weight_dtype,
                                       x0, noises, generator, objective), KERNELS)


@torch.no_grad()
def fused_sample_loop_plain(
    denoiser, schedule: DiffusionSchedule, z: torch.Tensor,
    mask: Optional[torch.Tensor] = None, n_cond: int = 0,
    weight_dtype: torch.dtype = torch.bfloat16,
    x0: Optional[torch.Tensor] = None, noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None, objective: str = "pred_noise",
) -> torch.Tensor:
    """The same math in plain PyTorch on any device."""
    return run_sampler(prepare_sampler(denoiser, schedule, z, mask, n_cond, weight_dtype,
                                       x0, noises, generator, objective), PLAIN)
