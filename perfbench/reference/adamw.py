"""AdamW with clipping by the global norm and the warmup-cosine-restart
schedule of PoseDiffusion's training (pose_diffusion/train.py:72-77,
util/train_util.py:62-92), in plain PyTorch."""

from __future__ import annotations

import math
from typing import Dict

import torch


def learning_rate(opt: dict, step: int) -> float:
    """The rate at ``step`` (from 0): per cycle of restart_num x len_train
    steps a linear warmup from warmup_lr_init over warmup_ratio of it, then a
    cosine to 0."""
    cycle = opt["restart_num"] * opt["len_train"]
    warm = int(opt["restart_num"] * opt["warmup_ratio"] * opt["len_train"])
    t = math.fmod(float(step), cycle)
    if t < warm:
        return opt["warmup_lr_init"] + (opt["lr"] - opt["warmup_lr_init"]) * t / max(warm, 1)
    return opt["lr"] * (1 + math.cos(math.pi * (t - warm) / max(cycle - warm, 1))) / 2


class AdamW:
    """Clip all gradients together to ``clip_grad``, then Adam's moments,
    bias correction and decoupled weight decay, on a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        """Update ``params`` in place; returns the clipped gradients."""
        o = self.opt
        b1, b2 = o["betas"]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = torch.where(norm >= o["clip_grad"], o["clip_grad"] / norm, torch.ones_like(norm))
        clipped = {k: g * scale for k, g in grads.items()}
        lr = learning_rate(o, self.count)
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, p in params.items():
            g = clipped[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + o["eps"])
            p.add_(upd + o["weight_decay"] * p, alpha=-lr)
        return clipped
