"""Bottleneck ResNet backbones (ResNet-50, ResNet-101), as
``posediffusion_tpu.models.resnet``, in plain ``nn.Module``s on NCHW.

The module tree carries torchvision's names (``conv1``, ``bn1``,
``layer{s}.{b}.conv{1,2,3}`` / ``bn{1,2,3}`` / ``downsample.{0,1}``), the
keys ``posediffusion_tpu.models.resnet.convert_resnet`` reads, so a
torchvision state dict loads with a strict ``load_state_dict``; the
``num_batches_tracked`` counters it carries are accepted and dropped. The
output is the globally average-pooled (B, 2,048) feature: torchvision's
``fc`` is not part of the backbone.

BatchNorm is the JAX package's ``BatchNormInference``: always
``(x - mean) / sqrt(var + eps) * weight + bias`` with eps 1e-5, never batch
statistics. As there, where ``mean`` and ``var`` are trainable parameters
(Flax ``params``), ``running_mean`` and ``running_var`` are
``nn.Parameter``s: the optimizer updates them as it updates every other
weight, unless the extractor is frozen.

``bf16`` follows Flax ``nn.Conv(dtype=bfloat16)`` as XLA evaluates it: each
convolution reads its input and kernel rounded to bf16. Its result would be
a bf16 value, but the float32 BatchNorm parameters promote it to float32 at
once, and XLA keeps the product's float32 value there (it drops the
convert pair under its excess-precision rule; the compiled program holds a
float32 convolution of rounded operands). So the BatchNorms, ReLUs,
residual sums, the stem's max-pool and the average pool are float32, and
so is every convolution's result. In the backward each convolution's
cotangent is rounded to bf16 before its two products, whose results stay
float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from posediffusion_tpu_torch.ops.kernels import round_bf16

EXPANSION = 4


class BatchNormInference(nn.Module):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` over the channels
    of an NCHW tensor, with the statistics as trainable parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        view = lambda p: p.view(1, -1, 1, 1)  # noqa: E731
        x = x.to(torch.float32)
        return ((x - view(self.running_mean)) / torch.sqrt(view(self.running_var) + self.eps)
                * view(self.weight) + view(self.bias))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # torchvision's counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class _Bf16Conv(torch.autograd.Function):
    """A convolution of bf16-rounded operands with a float32 result, and its
    backward as XLA evaluates the Flax bf16 convolution's: both products
    read the cotangent rounded to bf16 (and the rounded input or kernel),
    and their results, the input's and the kernel's gradients, stay float32
    (the same excess-precision rule as the forward result's)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xr, wr = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding)
        return F.conv2d(xr, wr, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        stride, padding = ctx.conf
        gr = round_bf16(g)
        dx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, stride, padding)
        dw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, stride, padding)
        return dx, dw, None, None


def conv(x: torch.Tensor, layer: nn.Conv2d, bf16: bool) -> torch.Tensor:
    """``layer`` on ``x``; with ``bf16`` on the input and kernel rounded to
    bf16, the result float32 (``_Bf16Conv``)."""
    if not bf16:
        return layer(x)
    return _Bf16Conv.apply(x, layer.weight, layer.stride, layer.padding)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1, 3x3 (the stride), 1x1 x 4 channels, each with its BatchNorm,
    plus the shortcut (a strided 1x1 conv and BatchNorm when ``downsample``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNormInference(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNormInference(planes)
        self.conv3 = _conv(planes, planes * EXPANSION, 1)
        self.bn3 = BatchNormInference(planes * EXPANSION)
        self.downsample = nn.Sequential(
            _conv(inplanes, planes * EXPANSION, 1, stride),
            BatchNormInference(planes * EXPANSION)) if downsample else None

    def forward(self, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(conv(x, self.conv1, bf16)))
        out = F.relu(self.bn2(conv(out, self.conv2, bf16)))
        out = self.bn3(conv(out, self.conv3, bf16))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv(x, self.downsample[0], bf16))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet; ``layers=(3, 4, 6, 3)`` is ResNet-50. (B, 3, H, W)
    normalised images -> (B, 2,048) pooled features."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNormInference(64)
        inplanes, planes = 64, 64
        for stage, blocks in enumerate(self.layers):
            seq = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                seq.append(Bottleneck(inplanes, planes, stride, downsample=(b == 0)))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
            planes *= 2
        self.output_dim = inplanes

    def forward(self, images_nchw: torch.Tensor, bf16: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(conv(images_nchw, self.conv1, bf16)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # the -inf pad of the JAX module
        for stage in range(len(self.layers)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, bf16)
        return x.mean(dim=(2, 3))


def resnet50() -> ResNet:
    return ResNet((3, 4, 6, 3))


def resnet101() -> ResNet:
    return ResNet((3, 4, 23, 3))


def resnet_layers(modelname: str) -> Tuple[int, ...]:
    """The stage depths ``modelname`` names, as the JAX extractor picks them
    (``posediffusion_tpu/models/feature_extractor.py:46``)."""
    return (3, 4, 23, 3) if "101" in modelname else (3, 4, 6, 3)
