"""SuperPoint keypoint detector and descriptor, as
``posediffusion_tpu.matching.superpoint``.

``SuperPointNet`` is MagicLeap's network with MagicLeap's parameter names
(``conv1a`` ... ``convDb``), so a released ``superpoint_v1.pth`` loads with
``strict=True``. The JAX detector is XLA with no Pallas kernel, so this
module is plain PyTorch and its convolutions go to cuDNN on a card (in full
float32 once ``utils.precision.pin_full_float32`` has run).

Public functions keep the JAX package's layouts: cell logits and
descriptor grids channel-last (B, H/8, W/8, C), keypoints (x, y) pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class SuperPointNet(nn.Module):
    """Grayscale (B, 1, H, W) -> (cell logits (B, H/8, W/8, 65), unit
    descriptor grid (B, H/8, W/8, 256))."""

    def __init__(self):
        super().__init__()
        conv = lambda i, o, k=3: nn.Conv2d(i, o, k, padding=k // 2)
        self.conv1a, self.conv1b = conv(1, 64), conv(64, 64)
        self.conv2a, self.conv2b = conv(64, 64), conv(64, 64)
        self.conv3a, self.conv3b = conv(64, 128), conv(128, 128)
        self.conv4a, self.conv4b = conv(128, 128), conv(128, 128)
        self.convPa, self.convPb = conv(128, 256), conv(256, 65, 1)
        self.convDa, self.convDb = conv(128, 256), conv(256, 256, 1)

    def forward(self, image: torch.Tensor):
        relu = lambda t: F.relu(t, inplace=True)  # inference: halves peak memory
        x = relu(self.conv1b(relu(self.conv1a(image))))
        x = F.max_pool2d(x, 2, 2)
        x = relu(self.conv2b(relu(self.conv2a(x))))
        x = F.max_pool2d(x, 2, 2)
        x = relu(self.conv3b(relu(self.conv3a(x))))
        x = F.max_pool2d(x, 2, 2)
        x = relu(self.conv4b(relu(self.conv4a(x))))
        semi = self.convPb(relu(self.convPa(x))).permute(0, 2, 3, 1)
        desc = self.convDb(relu(self.convDa(x))).permute(0, 2, 3, 1)
        desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-12)
        return semi, desc


def _max_pool(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sliding max with kernel 2r+1, stride 1, "SAME" padding with -inf
    (``reduce_window`` with a -inf init) on (B, H, W)."""
    return F.max_pool2d(x, 2 * radius + 1, stride=1, padding=radius)


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 2) -> torch.Tensor:
    """Iterative non-maximum suppression on (B, H, W) score maps: keep local
    maxima, re-admit maxima of the suppressed remainder."""
    max_mask = scores == _max_pool(scores, radius)
    for _ in range(iterations):
        supp_mask = _max_pool(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, 0.0, scores)
        new_max = supp_scores == _max_pool(supp_scores, radius)
        max_mask = max_mask | (new_max & ~supp_mask)
    return torch.where(max_mask, scores, 0.0)


def _depth_to_space_scores(semi: torch.Tensor) -> torch.Tensor:
    """(B, Hc, Wc, 65) cell logits -> (B, H, W) keypoint probability map."""
    probs = torch.softmax(semi, dim=-1)[..., :-1]  # drop the dustbin
    B, Hc, Wc, _ = probs.shape
    probs = probs.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4)
    return probs.reshape(B, Hc * 8, Wc * 8)


def _sample_descriptors(kpts: torch.Tensor, desc_grid: torch.Tensor, s: int = 8):
    """Bilinear descriptors at (F, K, 2) pixel keypoints from (F, Hc, Wc, C)
    grids (MagicLeap's grid_sample(align_corners=True) on cell centres,
    clipped to the grid), L2-normalised -> (F, K, C)."""
    Fn, Hc, Wc, C = desc_grid.shape
    gx = (kpts[..., 0] - s / 2 + 0.5) * (Wc - 1) / (Wc * s - s / 2 - 0.5)
    gy = (kpts[..., 1] - s / 2 + 0.5) * (Hc - 1) / (Hc * s - s / 2 - 0.5)
    x = gx.clamp(0.0, Wc - 1.0)
    y = gy.clamp(0.0, Hc - 1.0)
    x0 = x.floor().long().clamp(0, Wc - 1)
    y0 = y.floor().long().clamp(0, Hc - 1)
    x1 = (x0 + 1).clamp(0, Wc - 1)
    y1 = (y0 + 1).clamp(0, Hc - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = desc_grid.reshape(Fn, Hc * Wc, C)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * Wc + xx)[..., None].expand(-1, -1, C))

    d = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
         + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)


def top_k_stable(flat: torch.Tensor, k: int):
    """The k largest values of each row and their indices, the lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none, and NMS maxima of random weights do tie)."""
    values, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


@torch.no_grad()
def detect_keypoints_batched(
    net: SuperPointNet,
    images_gray: torch.Tensor,  # (F, 1, H, W) in [0, 1]
    max_keypoints: int = 4096,
    nms_radius: int = 4,
    keypoint_threshold: float = 0.005,
    border: int = 4,
):
    """Detection over F same-size frames in one forward: returns kpts
    (F, K, 2) float32 (x, y) pixels sorted by score, scores (F, K), unit
    descriptors (F, K, 256) and validity (F, K), with K = min(max_keypoints,
    H * W)."""
    semi, desc_grid = net(images_gray)
    scores = simple_nms(_depth_to_space_scores(semi), nms_radius)
    Fn, H, W = scores.shape
    yy = torch.arange(H, device=scores.device)[:, None]
    xx = torch.arange(W, device=scores.device)[None, :]
    in_border = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    scores = torch.where(in_border[None], scores, 0.0)

    top_scores, top_idx = top_k_stable(scores.reshape(Fn, -1), min(max_keypoints, H * W))
    kpts = torch.stack([top_idx % W, top_idx // W], dim=-1).to(torch.float32)
    valid = top_scores > keypoint_threshold
    return kpts, top_scores, _sample_descriptors(kpts, desc_grid), valid
