"""The dropout masks of the denoiser's four sites, as the configuration's
training draws them: element i of a site's row-major tensor is kept when the
low 23 bits of a counter hash of (seed, layer, site, i) reach
ceil(rate x 2^23), and a kept element is scaled by 1 / (1 - rate). A frozen
copy of the program's plain route (murmur3's 32-bit finaliser), so that the
reference draws the same masks from the same dropout seed."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

SITES = ("attn", "m1", "mff", "m2")  # p, after out_proj, after the FF activation, after linear2
_M32 = 0xFFFFFFFF


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def site_key(seed: int, layer: int, site: str, rate: float) -> Optional[Tuple[int, int, float]]:
    """(hash key, 23-bit threshold, keep scale) of ``site`` in ``layer``;
    None when ``rate`` is 0."""
    if rate <= 0.0:
        return None
    stream = layer * len(SITES) + SITES.index(site) + 1
    key = _fmix32(_fmix32(int(seed) & _M32) ^ ((stream * 0x9E3779B9) & _M32))
    thr = math.ceil(float(np.float32(rate)) * (1 << 23))
    return key, thr, float(np.float32(1.0 / (1.0 - rate)))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32_t(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def mask(seed: int, layer: int, site: str, rate: float, shape, device) -> Optional[torch.Tensor]:
    """The float32 multipliers (0 or 1 / (1 - rate)) of a tensor of
    ``shape`` at ``site`` of ``layer``; None when ``rate`` is 0."""
    k = site_key(seed, layer, site, rate)
    if k is None:
        return None
    key, thr, scale = k
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    bits = _fmix32_t(_fmix32_t(i) ^ key) & 0x7FFFFF
    return torch.where(bits >= thr, torch.tensor(scale, device=device), 0.0).view(shape)
