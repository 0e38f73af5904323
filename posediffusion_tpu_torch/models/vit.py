"""DINO ViT-S/16 and ViT-B/16 and DINOv2 ViT-S/14 backbones, as in
``posediffusion_tpu.models.vit``, and DINOv2 ViT-g/14, which the JAX
package does not have.

Keys are those of the DINO checkpoint (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``), plus DINOv2's LayerScale gains
``blocks.N.ls1.gamma`` and ``blocks.N.ls2.gamma`` with ``layer_scale``.
ViT-g/14's feed-forward is DINOv2's SwiGLU (``ffn="swiglu"``,
dinov2/layers/swiglu_ffn.py ``SwiGLUFFNFused``) under its keys
``blocks.N.mlp.w12`` and ``blocks.N.mlp.w3``.
Position embeddings are resampled with torch's bicubic (Keys a = -0.75) for
the smaller scales. For DINOv2 (patch 14, a 37 x 37 grid) this follows the
JAX package, not DINOv2 upstream: no ``interpolate_offset`` and no
antialiasing.

Several scales of one image run as ONE token row: ``pack_scales`` embeds
each scale and concatenates the rows, with a block-diagonal additive bias
(0 within a scale, NEG across) that makes packed attention exactly
per-scale attention. ``forward`` runs the blocks in plain PyTorch; the
inference paths run them through the kernels (``models/feature_extractor``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

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

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                attend: Optional[Callable] = None):
        """``attend`` (e.g. ``kernels.attention``) takes the packed QKV
        (B, N, 3D), the head count and ``attn_bias``; without it the
        attention is plain PyTorch."""
        B, N, D = x.shape
        Dh = D // self.num_heads
        qkv = self.qkv(x)
        if attend is not None:
            return self.proj(attend(qkv.contiguous(), self.num_heads, attn_bias=attn_bias))
        q, k, v = qkv.view(B, N, 3, self.num_heads, Dh).permute(2, 0, 3, 1, 4)
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


def swiglu_hidden(dim: int, mlp_ratio: float = 4.0) -> int:
    """DINOv2's SwiGLU hidden width (``SwiGLUFFNFused``): two thirds of the
    GELU MLP's, rounded up to a multiple of 8 (4,096 at D 1,536; 176 at 64)."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


class SwiGLUFFN(nn.Module):
    """DINOv2's gated feed-forward: ``x12 = w12(x)``, ``x1, x2 =
    x12.chunk(2)``, ``w3(silu(x1) * x2)``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    """DINOv2's per-channel gain of a residual branch (``ls1_gamma`` /
    ``ls2_gamma`` in the JAX package)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: bool = False, ffn: str = "gelu"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if ffn == "swiglu":
            self.mlp = SwiGLUFFN(dim, swiglu_hidden(dim, mlp_ratio))
        elif ffn == "gelu":
            self.mlp = Mlp(dim, int(dim * mlp_ratio))
        else:
            raise ValueError(f"unknown feed-forward {ffn!r} (gelu or swiglu)")
        # the gain after the projection, before the residual
        # (posediffusion_tpu/models/vit.py:78-90)
        self.ls1 = LayerScale(dim) if layer_scale else nn.Identity()
        self.ls2 = LayerScale(dim) if layer_scale else nn.Identity()

    def forward(self, x, attn_bias=None, attend=None):
        x = x + self.ls1(self.attn(self.norm1(x), attn_bias, attend))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0, pos_grid: int = 14,
                 layer_scale: bool = False, ffn: str = "gelu"):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.pos_grid = pos_grid
        self.layer_scale = layer_scale
        self.ffn = ffn
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid**2, embed_dim))
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, layer_scale, ffn) for _ in range(depth)
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


def vit_base(patch_size: int = 16) -> VisionTransformer:
    """DINO ViT-B (``dino_vitb16``): D 768, 12 heads, FF 3,072."""
    return VisionTransformer(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12)


def vit_small_dinov2() -> VisionTransformer:
    """DINOv2 ViT-S/14 (``dinov2_vits14``): patch 14, LayerScale, a 37 x 37
    position grid (518px), so pos_embed is (1, 1,370, 384)."""
    return VisionTransformer(patch_size=14, embed_dim=384, depth=12, num_heads=6,
                             pos_grid=37, layer_scale=True)


def vit_giant2_dinov2() -> VisionTransformer:
    """DINOv2 ViT-g/14 (``dinov2_vitg14``, DINOv2's ``vit_giant2`` with
    ``ffn_layer="swiglufused"``): D 1,536, 40 blocks, 24 heads of 64, patch
    14, grid 37, LayerScale, SwiGLU hidden 4,096; 1.136B parameters."""
    return VisionTransformer(patch_size=14, embed_dim=1536, depth=40, num_heads=24,
                             pos_grid=37, layer_scale=True, ffn="swiglu")
