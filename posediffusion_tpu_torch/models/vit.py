"""DINO ViT-S/16 backbone, as in ``posediffusion_tpu.models.vit``.

Keys are those of the DINO checkpoint (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``). Position embeddings are resampled with
torch's bicubic (Keys a = -0.75) for the smaller scales.

Several scales of one image run as ONE token row: ``pack_scales`` embeds
each scale and concatenates the rows, with a block-diagonal additive bias
(0 within a scale, NEG across) that makes packed attention exactly
per-scale attention. ``forward`` runs the blocks in plain PyTorch; the
inference path runs them through the kernels instead
(``models/feature_extractor.extract_features_fused``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from posediffusion_tpu_torch.ops.image import resize_bicubic_torch, resize_bilinear, scale_size
from posediffusion_tpu_torch.ops.kernels import NEG


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor]):
        B, N, D = x.shape
        Dh = D // self.num_heads
        q, k, v = self.qkv(x).view(B, N, 3, self.num_heads, Dh).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)) * (1.0 / Dh**0.5)
        if attn_bias is not None:
            s = s + attn_bias
        out = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf GELU


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, attn_bias=None):
        x = x + self.attn(self.norm1(x), attn_bias)
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, pos_grid: int = 14):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.pos_grid = pos_grid
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid**2, embed_dim))
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def depth(self) -> int:
        return len(self.blocks)

    def interpolate_pos_encoding(self, h0: int, w0: int) -> torch.Tensor:
        g = self.pos_grid
        if (h0, w0) == (g, g):
            return self.pos_embed
        patch_pos = self.pos_embed[:, 1:].reshape(1, g, g, self.embed_dim)
        patch_pos = resize_bicubic_torch(patch_pos, (h0, w0))
        return torch.cat(
            [self.pos_embed[:, :1], patch_pos.reshape(1, h0 * w0, self.embed_dim)],
            dim=1,
        )

    def embed(self, images_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 3, h, w) -> (B, 1 + h0*w0, D): CLS + patch tokens + positions."""
        if min(images_nchw.shape[-2:]) < self.patch_size:
            raise ValueError(
                f"image {tuple(images_nchw.shape[-2:])} is smaller than one "
                f"{self.patch_size}px patch"
            )
        x = self.patch_embed.proj(images_nchw)
        B, D, h0, w0 = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(B, 1, D), x], dim=1)
        return x + self.interpolate_pos_encoding(h0, w0)

    def pack_scales(self, images_nchw: torch.Tensor, scale_factors: Sequence[float]):
        """Embed every scale and pack the rows: returns (tokens (B, sum_N, D),
        block-diagonal bias (sum_N, sum_N) float32, per-scale CLS offsets)."""
        H, W = images_nchw.shape[-2:]
        toks = []
        for s in scale_factors:
            inp = images_nchw if s == 1 else resize_bilinear(
                images_nchw, (scale_size(H, s), scale_size(W, s)), scale_factor=s
            )
            toks.append(self.embed(inp))
        offsets = np.cumsum([0] + [t.shape[1] for t in toks])
        seg = np.concatenate([np.full(t.shape[1], i) for i, t in enumerate(toks)])
        bias = torch.as_tensor(
            np.where(seg[:, None] == seg[None, :], 0.0, NEG).astype(np.float32),
            device=images_nchw.device,
        )
        return torch.cat(toks, dim=1), bias, offsets

    def forward(self, images_nchw: torch.Tensor, scale_factors=None) -> torch.Tensor:
        """(B, 3, H, W) -> (B, D) CLS feature, or (B, n_scales, D) per-scale
        CLS features when ``scale_factors`` packs several scales."""
        if scale_factors is None:
            x, bias, offsets = self.embed(images_nchw), None, None
        else:
            x, bias, offsets = self.pack_scales(images_nchw, scale_factors)
        for blk in self.blocks:
            x = blk(x, bias)
        if offsets is None:
            return self.norm(x[:, 0])
        return self.norm(torch.stack([x[:, int(o)] for o in offsets[:-1]], dim=1))
