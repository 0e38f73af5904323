"""Seeding of the host-side random streams, as
``posediffusion_tpu.utils.seeding`` (reference util/utils.py:14-17).

The data pipeline draws from numpy and ``random``; the loss's draws come
from an explicit ``torch.Generator``, and torch's global stream is seeded
too for anything that draws without one. ``process_unique`` offsets the
seed by the process's rank, where the JAX package adds
``jax.process_index()`` (accelerate's ``device_specific=True``).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from posediffusion_tpu_torch.parallel.distributed import rank_and_world


def seed_all_random_engines(seed: int, process_unique: bool = False) -> int:
    if process_unique:
        seed = seed + rank_and_world()[0]
    np.random.seed(seed % (2**32))
    random.seed(seed)
    torch.manual_seed(seed)
    return seed
