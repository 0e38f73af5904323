"""The one generator of the benchmark's inputs: it reads a traffic file's
parameters and makes the cell's inputs from ``--seed``, the same inputs for
the same seed, on the device where they live.

Kinds of traffic (the file's ``kind``):

- ``train``: a ring of ``ring`` distinct batches resident on the card, each
  ``sequences`` x ``frames`` images at the configuration's ``image_size``
  (uniform in [0, 1]) with their pose encodings and an all-valid frame
  mask; and per step k the loss's draws (t, noise, dropout seed) for the
  ``batch_repeat``-tiled batch, made on the host as the training loop makes
  them.

Every stream has a seed of its own, hashed from (seed, what, index), so
one batch or one step's draws can be made again alone.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch


def subseed(seed: int, *labels) -> int:
    """A 63-bit seed for the stream ``labels`` of run seed ``seed``."""
    h = hashlib.sha256(repr((int(seed), *labels)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, *labels, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *labels))


def pose_encodings(shape, g: torch.Generator, device) -> torch.Tensor:
    """(..., 9) absT_quaR_logFL encodings: translation N(0, 1), a unit
    quaternion, log focal lengths of U(1, 3)."""
    T = torch.randn((*shape, 3), generator=g, device=device)
    q = torch.randn((*shape, 4), generator=g, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    fl = torch.rand((*shape, 2), generator=g, device=device) * 2.0 + 1.0
    return torch.cat([T, q, torch.log(fl)], dim=-1)


def train_batch(traffic: dict, config: dict, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the ring: images (B, N, 3, H, W), pose_encodings
    (B, N, 9), mask (B, N)."""
    B, N, H = traffic["sequences"], traffic["frames"], config["image_size"]
    g = generator(seed, "batch", index, device=device)
    images = torch.rand((B, N, 3, H, H), generator=g, device=device)
    poses = pose_encodings((B, N), g, device)
    return {"images": images, "pose_encodings": poses,
            "mask": torch.ones((B, N), dtype=torch.bool, device=device)}


def train_batches(traffic: dict, config: dict, seed: int, device, count: int = 0) -> List[dict]:
    """The first ``count`` batches of the ring (all ``ring`` by default)."""
    return [train_batch(traffic, config, seed, i, device) for i in range(count or traffic["ring"])]


def train_draws(traffic: dict, config: dict, seed: int, step: int) -> dict:
    """Step ``step``'s draws on the host: t (B'), noise (B', N, 9) and the
    dropout seed, B' = sequences x batch_repeat."""
    Bp = traffic["sequences"] * max(traffic["batch_repeat"], 1)
    g = generator(seed, "draws", step)
    T = config["diffusion"]["timesteps"]
    return {"t": torch.randint(0, T, (Bp,), generator=g),
            "noise": torch.randn((Bp, traffic["frames"], config["denoiser"]["target_dim"]),
                                 generator=g),
            "drop_seed": int(torch.randint(0, 2**31 - 1, (1,), generator=g))}


def weights(specs, seed: int, std: float, device) -> Dict[str, torch.Tensor]:
    """Float32 parameters for ``specs`` ((name, shape, law) with the law
    "normal", N(0, std), or "one", 1 + N(0, std)) from one draw on the
    device."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device=device),
                       device=device).mul_(std)
    out, off = {}, 0
    for (name, shape, law), n in zip(specs, sizes):
        w = flat[off:off + n].view(shape)
        out[name] = w + 1.0 if law == "one" else w
        off += n
    return out
