"""Optimizer and LR schedule, as ``posediffusion_tpu.training.optim``.

The reference's AdamW with warmup-cosine restarts (pose_diffusion/train.py
:72-77, util/train_util.py:62-92): per cycle a linear warmup from
``warmup_lr_init`` over ``warmup_ratio`` of the cycle, then a cosine decay to
``eta_min``; cycles restart every ``T_0 * iters_per_epoch`` steps. Gradients
are clipped by their global norm (1.0) before AdamW (betas 0.9/0.999, eps
1e-8, decoupled weight decay 0.01 on every parameter). The update is the
JAX package's optax chain step for step: clip_by_global_norm, scale_by_adam,
add_decayed_weights, scale by -lr(step) with the step counted from 0.
Frozen parameters get no update and no decay.

On a sharded model (``parallel/mesh.shard_model``) each rank updates its
own shards and keeps their moments; the clip's global norm adds the
shards' squares over the "fsdp" group (each "dp" replica holds the same
shards), and ``state_dict`` gathers the moments whole.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from posediffusion_tpu_torch.parallel.mesh import full_like, local, norm_group, shard_of
from posediffusion_tpu_torch.utils.profiling import span


def warmup_cosine_restarts(
    base_lr: float,
    T_0: int,
    iters_per_epoch: int,
    warmup_ratio: float = 0.1,
    warmup_lr_init: float = 1e-7,
    eta_min: float = 0.0,
    T_mult: int = 1,
) -> Callable[[int], float]:
    """The learning rate at a step. ``T_mult`` > 1 makes cycle i last
    T_0 T_mult^i epochs; the cosine keeps the first cycle's period, the
    reference's own quirk (train_util.py:86-91)."""
    cycle_steps = T_0 * iters_per_epoch
    warmup_steps = int(T_0 * warmup_ratio * iters_per_epoch)

    def schedule(step: int) -> float:
        step = float(step)
        if T_mult == 1:
            t_cur = math.fmod(step, cycle_steps)
        else:
            n = math.floor(math.log(step / cycle_steps * (T_mult - 1) + 1) / math.log(T_mult))
            t_cur = step - cycle_steps * (T_mult**n - 1) / (T_mult - 1)
        if t_cur < warmup_steps:
            return warmup_lr_init + (base_lr - warmup_lr_init) * t_cur / max(warmup_steps, 1)
        t_adj = t_cur - warmup_steps
        T_i = max(cycle_steps - warmup_steps, 1)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_adj / T_i)) / 2

    return schedule


class AdamW:
    """Clip by global norm, then AdamW, over the parameters that are not
    frozen; ``step`` counts the updates made."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], clip_grad: float = 1.0,
                 weight_decay: float = 0.01, betas=(0.9, 0.999), eps: float = 1e-8,
                 frozen: Iterable[torch.nn.Parameter] = ()):
        frozen_ids = {id(p) for p in frozen}
        self.params: List[torch.nn.Parameter] = [
            p for p in params if id(p) not in frozen_ids]
        self.schedule = schedule
        self.clip_grad = clip_grad
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.step_count = 0
        self.norm_group = norm_group(self.params)
        self.mu = [torch.zeros_like(local(p)) for p in self.params]
        self.nu = [torch.zeros_like(local(p)) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> Dict[str, float]:
        """One update from the parameters' ``.grad`` (None counts as 0), in
        the span ``pd.optimizer``. Returns the learning rate used and the
        gradients' global norm."""
        with span("optimizer"):
            lr = self.schedule(self.step_count)
            params = [local(p) for p in self.params]
            grads = [torch.zeros_like(lp) if p.grad is None else local(p.grad)
                     for p, lp in zip(self.params, params)]
            sq = sum((g ** 2).sum() for g in grads)
            if self.norm_group is not None:
                dist.all_reduce(sq, group=self.norm_group)
            norm = torch.sqrt(sq)
            if self.clip_grad and self.clip_grad > 0:
                # optax.clip_by_global_norm: g / norm * max_norm above the bound
                clip = norm >= self.clip_grad
                grads = [torch.where(clip, g / norm * self.clip_grad, g) for g in grads]
            t = self.step_count + 1
            c1, c2 = 1 - self.b1**t, 1 - self.b2**t
            for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
                mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
                nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
                update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * p
                p.add_(update, alpha=-lr)
            self.step_count += 1
            return {"lr": lr, "grad_norm": float(norm)}

    def state_dict(self) -> dict:
        """The step and the moments, whole (gathered from the ranks' shards:
        a collective on a sharded model)."""
        return {"step": self.step_count,
                "mu": [full_like(m, p) for m, p in zip(self.mu, self.params)],
                "nu": [full_like(n, p) for n, p in zip(self.nu, self.params)]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state for {len(state['mu'])} parameters, "
                             f"this optimizer has {len(self.mu)}")
        self.step_count = int(state["step"])
        for dst, src, p in zip(self.mu + self.nu, state["mu"] + state["nu"], self.params * 2):
            dst.copy_(shard_of(src.to(dst.device), p))


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4, T_0: int = 50,
                   iters_per_epoch: int = 16384, clip_grad: float = 1.0,
                   weight_decay: float = 0.01, warmup_ratio: float = 0.1,
                   frozen_prefixes: Optional[Iterable[str]] = None):
    """AdamW over ``model``'s parameters with the schedule; parameters whose
    names start with a prefix in ``frozen_prefixes`` are frozen."""
    schedule = warmup_cosine_restarts(lr, T_0, iters_per_epoch, warmup_ratio)
    prefixes = tuple(frozen_prefixes or ())
    frozen = [p for n, p in model.named_parameters() if prefixes and n.startswith(prefixes)]
    return AdamW(model.parameters(), schedule, clip_grad, weight_decay, frozen=frozen), schedule


EXTRACTOR_PREFIX = "image_feature_extractor."
