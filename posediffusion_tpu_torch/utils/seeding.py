"""Seeding of the host-side random streams, as
``posediffusion_tpu.utils.seeding`` (reference util/utils.py:14-17).

The data pipeline draws from numpy and ``random``; the loss's draws come
from an explicit ``torch.Generator``, and torch's global stream is seeded
too for anything that draws without one.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_all_random_engines(seed: int) -> int:
    np.random.seed(seed % (2**32))
    random.seed(seed)
    torch.manual_seed(seed)
    return seed
