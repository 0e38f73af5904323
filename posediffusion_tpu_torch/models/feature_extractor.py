"""Multi-scale image feature extractor, as in
``posediffusion_tpu.models.feature_extractor``: ImageNet-normalise, run the
ViT at scales 1, 1/2 and 1/3 packed into one token row (197 + 50 + 17 = 264
tokens at 224px with patch 16; 257 + 65 + 26 = 348 with DINOv2's patch 14),
and average the per-scale CLS features; or run a ResNet on each scale's
bilinear resize and average its pooled features.

Backbones (``modelname``, the reference's contract): ``dino_vits16``,
``dino_vitb16``, ``dinov2_vits14`` (LayerScale, patch 14, position grid
37), ``dinov2_vitg14`` (the same with DINOv2's SwiGLU feed-forward;
float32 only), ``resnet50`` and ``resnet101`` (2,048-wide features,
``models/resnet``).
``extract_features_resnet`` is the ResNets' route for serving and training
alike, as in the JAX package, where the Flax module serves and trains them:
the normalisation, the resizes and the network in plain PyTorch (cuDNN on a
card), differentiable, at float32 or at the Flax bf16 convolutions' sites.

``extract_features_fused`` is the DINO inference path: the patch embedding,
position interpolation, packing, CLS LayerNorm and average are plain
PyTorch, and the 12-block trunk is ``ops.vit_kernel.fused_vit_trunk``.
``extract_features_blocks`` is the DINOv2 inference path (and DINO's at
``compute_dtype=bfloat16``), which in the JAX package takes the Flax
blocks, not the fused trunk
(``posediffusion_tpu/models/pose_diffusion.py:409-414``): the module's
blocks with their attention in ``kernels.attention`` (TPU kernel 5's
counterpart) and the LayerNorms, products and gains in plain PyTorch, as
XLA computes them there. With ``bf16`` (DINO only) the blocks follow the
Flax blocks' ``dtype=bfloat16`` rounding sites as XLA evaluates them
(``posediffusion_tpu/models/vit.py``): the residual stream, each Dense's
operands, product and result, the attention's q, k, v, p and output (the
TPU kernel's bf16 sites: ``round_in``), the GELU; LayerNorms and the CLS
head stay float32. DINOv2's float32 LayerScale gains promote each branch's
output, and from the first residual sum on the whole stream, to float32,
as the Flax module's promotions do (``posediffusion_tpu/models/vit.py
:70-90``).
``extract_features_train`` is the flow for training, differentiable, with
the trunk (LayerScale and the SwiGLU gate included) in
``ops.vit_train_kernel.fused_vit_trunk_train``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from posediffusion_tpu_torch.models.resnet import ResNet, resnet_layers
from posediffusion_tpu_torch.models.vit import LayerScale, VisionTransformer
from posediffusion_tpu_torch.ops.image import imagenet_normalize, resize_bilinear, scale_size
from posediffusion_tpu_torch.ops.kernels import attention, round_bf16
from posediffusion_tpu_torch.ops.vit_kernel import fused_vit_trunk, stack_vit_params
from posediffusion_tpu_torch.ops.vit_train_kernel import (
    fused_vit_trunk_train,
    stack_vit_params_train,
)


class MultiScaleImageFeatureExtractor(nn.Module):
    """The backbone that ``modelname`` names: DINO (``dino_vits16``,
    ``dino_vitb16``: ``patch_size``), DINOv2 (``dinov2_vits14``: patch 14,
    grid 37, LayerScale; ``dinov2_vitg14`` also the SwiGLU feed-forward, as
    DINOv2's hubconf builds ``vit_giant2``) or a ResNet (``resnet50``,
    ``resnet101``; the ViT arguments unused), as
    ``posediffusion_tpu/models/feature_extractor.py :44-63``."""

    def __init__(self, scale_factors: Sequence[float] = (1.0, 1.0 / 2, 1.0 / 3),
                 modelname: str = "dino_vits16", patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6):
        super().__init__()
        self.scale_factors = tuple(scale_factors)
        if "resnet" in modelname:
            self._net = ResNet(resnet_layers(modelname))
            return
        dinov2 = "dinov2" in modelname
        self._net = VisionTransformer(
            patch_size=14 if dinov2 else patch_size, embed_dim=embed_dim, depth=depth,
            num_heads=num_heads, pos_grid=37 if dinov2 else 14, layer_scale=dinov2,
            ffn="swiglu" if modelname == "dinov2_vitg14" else "gelu",
        )

    @property
    def output_dim(self) -> int:
        return self._net.output_dim if isinstance(self._net, ResNet) else self._net.embed_dim

    def forward(self, images_nchw: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> (B, D), all in plain PyTorch."""
        if isinstance(self._net, ResNet):
            return extract_features_resnet(self._net, images_nchw, self.scale_factors)
        feats = self._net(imagenet_normalize(images_nchw), self.scale_factors)
        return feats.mean(dim=1)


def extract_features_resnet(
    net: ResNet,
    images_nchw: torch.Tensor,  # (B, 3, H, W) in [0, 1]
    scale_factors: Sequence[float] = (1.0, 1.0 / 2, 1.0 / 3),
    bf16: bool = False,
) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 2,048): the network on each scale's bilinear
    resize (torch's floor sizes and ``scale_factor`` coordinates), the
    pooled features averaged over the scales
    (``posediffusion_tpu/models/feature_extractor.py:67-80``)."""
    img = imagenet_normalize(images_nchw)
    h, w = img.shape[-2:]
    total = None
    for s in scale_factors:
        inp = img if s == 1 else resize_bilinear(
            img, (scale_size(h, s), scale_size(w, s)), scale_factor=s)
        feat = net(inp, bf16)
        total = feat if total is None else total + feat
    return total / len(scale_factors)


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
    """(B, 3, H, W) -> (B, D) with the trunk in the kernels (DINO only: the
    JAX package's fused trunk has no LayerScale)."""
    if vit.layer_scale:
        raise ValueError("the fused inference trunk has no LayerScale: "
                         "DINOv2 takes extract_features_blocks")
    x, bias, offsets = _embed_pack_scales(vit, images_nchw, scale_factors)
    x = fused_vit_trunk(
        x, stack_vit_params(vit, weight_dtype), nhead=vit.num_heads,
        act_bf16=act_bf16, attn_bias=bias,
    )
    return _multiscale_cls_head(vit, x, offsets)


def _dense_bf16(x: torch.Tensor, lin: nn.Linear, round_out: bool = True) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=bfloat16)``: input, kernel and bias cast to
    bf16, the product and the biased result bf16 values. ``round_out``
    False leaves the biased sum unrounded: where a float32 gain multiplies
    it, XLA fuses the sum into the product with the gain and drops its
    bf16 rounding."""
    y = round_bf16(round_bf16(x) @ round_bf16(lin.weight).t()) + round_bf16(lin.bias)
    return round_bf16(y) if round_out else y


def _gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=False)`` on bf16, 0.5 x erfc(-x sqrt(1/2)),
    as XLA computes it: the constant and erfc's result bf16 values, the
    product inside erfc's argument not rounded, the result bf16."""
    t = -x * round_bf16(torch.tensor(0.5**0.5))
    return round_bf16(0.5 * x * round_bf16(torch.special.erfc(t)))


def _block_bf16(blk, x: torch.Tensor, xu: torch.Tensor, bias):
    """One Flax ``ViTBlock(dtype=bfloat16)``, as XLA evaluates it: (x, xu)
    -> (x', xu'). Without LayerScale the residual stream x carries each sum
    rounded to bf16; the LayerNorm after a sum reads it before that
    rounding (xu: XLA keeps the add fused into the LayerNorm in float32).
    With LayerScale each branch ends in its Dense's unrounded sum times the
    float32 gain, and the sums are float32 (x' = xu'): only the first
    block's input is bf16 (the trunk's cast)."""
    a = blk.attn
    qkv = _dense_bf16(blk.norm1(xu), a.qkv)
    o = round_bf16(attention(qkv.contiguous(), a.num_heads, attn_bias=bias, round_in=True))
    if isinstance(blk.ls1, LayerScale):
        x1 = x + _dense_bf16(o, a.proj, round_out=False) * blk.ls1.gamma
        h = _dense_bf16(_gelu_bf16(_dense_bf16(blk.norm2(x1), blk.mlp.fc1)), blk.mlp.fc2,
                        round_out=False)
        out = x1 + h * blk.ls2.gamma
        return out, out
    x1u = x + _dense_bf16(o, a.proj)
    x1 = round_bf16(x1u)
    h = _dense_bf16(_gelu_bf16(_dense_bf16(blk.norm2(x1u), blk.mlp.fc1)), blk.mlp.fc2)
    return round_bf16(x1 + h), x1 + h


@torch.no_grad()
def extract_features_blocks(
    vit: VisionTransformer,
    images_nchw: torch.Tensor,  # (B, 3, H, W) in [0, 1]
    scale_factors: Sequence[float] = (1.0, 1.0 / 2, 1.0 / 3),
    bf16: bool = False,
) -> torch.Tensor:
    """(B, 3, H, W) -> (B, D) through the module's blocks with the attention
    in ``kernels.attention``: float32 (the DINOv2 inference path), or with
    ``bf16`` the Flax bf16 blocks' rounding sites (the route of DINO and
    DINOv2 at ``compute_dtype=bfloat16``; the SwiGLU ViT-g/14 is float32
    only)."""
    if bf16 and vit.ffn != "gelu":
        raise NotImplementedError(f"bf16 serving has no {vit.ffn} feed-forward: "
                                  "dinov2_vitg14 serves at float32")
    x, bias, offsets = _embed_pack_scales(vit, images_nchw, scale_factors)
    if bf16:
        x = xu = round_bf16(x)
        for blk in vit.blocks:
            x, xu = _block_bf16(blk, x, xu, bias)
    else:
        for blk in vit.blocks:
            x = blk(x, bias, attention)
    return _multiscale_cls_head(vit, x, offsets)


def extract_features_train(
    vit: VisionTransformer,
    images_nchw: torch.Tensor,  # (B, 3, H, W) in [0, 1]
    scale_factors: Sequence[float] = (1.0, 1.0 / 2, 1.0 / 3),
    act_bf16: bool = False,
    residual_bf16: bool = False,
) -> torch.Tensor:
    """(B, 3, H, W) -> (B, D), differentiable: patch embedding, positions,
    packing and the CLS head in plain PyTorch (autograd), the trunk in
    ``fused_vit_trunk_train`` with float32 weight stacks (and LayerScale
    gains when the blocks have them; the SwiGLU blocks' gated
    feed-forward)."""
    x, bias, offsets = _embed_pack_scales(vit, images_nchw, scale_factors)
    x = fused_vit_trunk_train(
        x, stack_vit_params_train(vit), bias, nhead=vit.num_heads,
        act_bf16=act_bf16, residual_bf16=residual_bf16,
        layer_scale=vit.layer_scale, act=vit.ffn,
    )
    return _multiscale_cls_head(vit, x, offsets)
