"""The 12-block DINO ViT trunk on the kernels, as
``posediffusion_tpu.ops.vit_kernel.fused_vit_trunk``.

The TPU kernel runs all blocks in one Pallas launch with the activations in
VMEM. Here each block is ``encoder_layer_math`` (seven launches) with
LayerNorm eps 1e-6, exact-erf GELU and the (N, N) additive bias that keeps
the packed scales apart. Weights are bf16 by default; ``act_bf16`` rounds
the matrix-product and attention operands to bf16 at the TPU kernel's cast
sites, with float32 accumulation, softmax and residual stream.
"""

from __future__ import annotations

from typing import Optional

import torch

from posediffusion_tpu_torch.ops.denoiser_kernel import (
    _stack,
    encoder_layer_math,
    layer_weights,
)
from posediffusion_tpu_torch.ops.kernels import KERNELS, PLAIN

VIT_KEYS = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj",
            "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")


@torch.no_grad()
def stack_vit_params(vit, weight_dtype=torch.bfloat16) -> dict:
    """``VisionTransformer`` blocks -> per-array stacks with a leading layer
    axis: (in, out) matrices in ``weight_dtype``, float32 vectors."""
    blocks = vit.blocks
    mats = {
        "wqkv": [b.attn.qkv.weight.t() for b in blocks],
        "wproj": [b.attn.proj.weight.t() for b in blocks],
        "wfc1": [b.mlp.fc1.weight.t() for b in blocks],
        "wfc2": [b.mlp.fc2.weight.t() for b in blocks],
    }
    vecs = {
        "g1": [b.norm1.weight for b in blocks], "b1": [b.norm1.bias for b in blocks],
        "bqkv": [b.attn.qkv.bias for b in blocks],
        "bproj": [b.attn.proj.bias for b in blocks],
        "g2": [b.norm2.weight for b in blocks], "b2": [b.norm2.bias for b in blocks],
        "bfc1": [b.mlp.fc1.bias for b in blocks],
        "bfc2": [b.mlp.fc2.bias for b in blocks],
    }
    out = {k: _stack(v, weight_dtype) for k, v in mats.items()}
    out.update({k: _stack(v, torch.float32) for k, v in vecs.items()})
    return out


def _vit_trunk(ops, x, stacks, nhead, act_bf16, attn_bias):
    B, N, D = x.shape
    h = x.reshape(B * N, D).to(torch.float32).contiguous()
    if attn_bias is not None:
        attn_bias = attn_bias.to(torch.float32).contiguous()
    for w in layer_weights(stacks, VIT_KEYS):
        h = encoder_layer_math(
            h, *w, nhead=nhead, seq_len=N, eps=1e-6, act="gelu",
            act_bf16=act_bf16, attn_bias=attn_bias, ops=ops,
        )
    return h.view(B, N, D)


@torch.no_grad()
def fused_vit_trunk(
    x: torch.Tensor,  # (B, N, D) tokens
    stacks: dict,
    nhead: int = 6,
    act_bf16: bool = False,
    attn_bias: Optional[torch.Tensor] = None,  # (N, N) additive, pre-softmax
) -> torch.Tensor:
    """All trunk blocks through the kernel wrappers -> (B, N, D) float32."""
    return _vit_trunk(KERNELS, x, stacks, nhead, act_bf16, attn_bias)


@torch.no_grad()
def fused_vit_trunk_plain(
    x: torch.Tensor, stacks: dict, nhead: int = 6, act_bf16: bool = False,
    attn_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The same math in plain PyTorch on any device."""
    return _vit_trunk(PLAIN, x, stacks, nhead, act_bf16, attn_bias)
