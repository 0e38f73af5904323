"""Float32 means float32 on the card.

PyTorch runs float32 matrix products in full precision by default, but
cuDNN convolutions (the patch embedding) in TF32. The port's plain paths
are held to float32 tolerances, as the JAX package pins its geometry with
``posediffusion_tpu.utils.precision.highp``, so entry points call this once.
``highp`` pins one function's products, whatever the caller set.
"""

from __future__ import annotations

import functools

import torch


def pin_full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def highp(fn):
    """Run ``fn`` with TF32 off (float32 products in full precision), the
    flags restored after: the JAX package's ``highp`` decorator."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        pin_full_float32()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return wrapped
