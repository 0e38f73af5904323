"""Multi-scale image feature extractor, as in
``posediffusion_tpu.models.feature_extractor``: ImageNet-normalise, run the
ViT at scales 1, 1/2 and 1/3 packed into one token row (197 + 50 + 17 = 264
tokens at 224px), and average the per-scale CLS features.

``extract_features_fused`` is the inference path: the patch embedding,
position interpolation, packing, CLS LayerNorm and average are plain
PyTorch, and the 12-block trunk is ``ops.vit_kernel.fused_vit_trunk``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from posediffusion_tpu_torch.models.vit import VisionTransformer
from posediffusion_tpu_torch.ops.image import imagenet_normalize
from posediffusion_tpu_torch.ops.vit_kernel import fused_vit_trunk, stack_vit_params


class MultiScaleImageFeatureExtractor(nn.Module):
    """The DINO ViT backbone (``dino_vits16``; the ResNet and DINOv2
    backbones of the JAX package are not ported)."""

    def __init__(self, scale_factors: Sequence[float] = (1.0, 1.0 / 2, 1.0 / 3),
                 patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        self._net = VisionTransformer(
            patch_size=patch_size, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads,
        )

    @property
    def output_dim(self) -> int:
        return self._net.embed_dim

    def forward(self, images_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> (B, D), all in plain PyTorch."""
        feats = self._net(imagenet_normalize(images_nchw), self.scale_factors)
        return feats.mean(dim=1)


def _embed_pack_scales(vit: VisionTransformer, images_nchw: torch.Tensor,
                       scale_factors: Sequence[float]):
    """Normalise, resize, patch-embed and pack: (tokens, bias, offsets)."""
    return vit.pack_scales(imagenet_normalize(images_nchw), scale_factors)


def _multiscale_cls_head(vit: VisionTransformer, x: torch.Tensor, offsets):
    """Final LayerNorm on each scale's CLS token, then their average."""
    feats = [vit.norm(x[:, int(o)]) for o in offsets[:-1]]
    return sum(feats) / len(feats)


@torch.no_grad()
def extract_features_fused(
    vit: VisionTransformer,
    images_nchw: torch.Tensor,  # (B, 3, H, W) in [0, 1]
    scale_factors: Sequence[float] = (1.0, 1.0 / 2, 1.0 / 3),
    act_bf16: bool = False,
    weight_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, 3, H, W) -> (B, D) with the trunk in the kernels."""
    x, bias, offsets = _embed_pack_scales(vit, images_nchw, scale_factors)
    x = fused_vit_trunk(
        x, stack_vit_params(vit, weight_dtype), nhead=vit.num_heads,
        act_bf16=act_bf16, attn_bias=bias,
    )
    return _multiscale_cls_head(vit, x, offsets)
