"""Image preprocessing: ImageNet normalisation and the resizes of the
multi-scale extractor, as in ``posediffusion_tpu.ops.image``.

The resizes are separable products with constant (out, in) weight matrices
built in numpy, which reproduce torch ``F.interpolate`` (bilinear with the
``scale_factor`` coordinate mapping, and bicubic with Keys a = -0.75).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """Normalise (..., 3, H, W) float images in [0, 1] with ImageNet stats."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean.view(3, 1, 1)) / std.view(3, 1, 1)


def _linear_weight_matrix(in_size: int, out_size: int, scale_factor=None):
    """(out, in) matrix of torch bilinear (align_corners=False): half-pixel
    centres, source index clamped at 0, edge clamping. With
    ``scale_factor`` the coordinates map with the given factor, as
    ``F.interpolate(scale_factor=s)`` does, not with out/in."""
    scale = (1.0 / scale_factor) if scale_factor else (in_size / out_size)
    src = np.maximum((np.arange(out_size) + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    W = np.zeros((out_size, in_size), np.float32)
    np.add.at(W, (np.arange(out_size), i0), 1.0 - w1)
    np.add.at(W, (np.arange(out_size), i1), w1)
    return W


def scale_size(side: int, scale_factor: float) -> int:
    """Torch's floor semantics for ``F.interpolate(scale_factor=...)``."""
    return int(side * scale_factor)


def resize_bilinear(
    images: torch.Tensor, size_hw: Tuple[int, int], scale_factor=None
) -> torch.Tensor:
    """Bilinear resize of (..., C, H, W) to (..., C, h, w)."""
    oh, ow = size_hw
    h, w = images.shape[-2:]
    if (oh, ow) == (h, w):
        return images
    kw = dict(dtype=images.dtype, device=images.device)
    Wh = torch.as_tensor(_linear_weight_matrix(h, oh, scale_factor), **kw)
    Ww = torch.as_tensor(_linear_weight_matrix(w, ow, scale_factor), **kw)
    out = torch.einsum("oh,...hw->...ow", Wh, images)
    return torch.einsum("pw,...ow->...op", Ww, out)


def _cubic_weight_matrix(in_size: int, out_size: int, a: float = -0.75):
    """(out, in) matrix of torch bicubic (Keys a, half-pixel centres, edge
    clamping)."""

    def kernel(t):
        t = np.abs(t)
        return np.where(
            t <= 1,
            (a + 2) * t**3 - (a + 3) * t**2 + 1,
            np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
        )

    x = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    x0 = np.floor(x).astype(np.int64)
    W = np.zeros((out_size, in_size), np.float32)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(x0 + tap, 0, in_size - 1)
        np.add.at(W, (np.arange(out_size), idx),
                  kernel(x - (x0 + tap)).astype(np.float32))
    return W


def resize_bicubic_torch(
    x: torch.Tensor, out_hw: Tuple[int, int], a: float = -0.75
) -> torch.Tensor:
    """Bicubic resize of channels-last (..., H, W, C), matching
    ``F.interpolate(mode="bicubic", align_corners=False)``."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    kw = dict(dtype=x.dtype, device=x.device)
    Wh = torch.as_tensor(_cubic_weight_matrix(h, oh, a), **kw)
    Ww = torch.as_tensor(_cubic_weight_matrix(w, ow, a), **kw)
    x = torch.einsum("oh,...hwc->...owc", Wh, x)
    return torch.einsum("pw,...owc->...opc", Ww, x)
