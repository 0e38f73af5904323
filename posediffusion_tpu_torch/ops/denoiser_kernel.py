"""One pre-norm transformer layer built from the kernels, shared by both
trunks, as ``posediffusion_tpu.ops.denoiser_kernel.encoder_layer_math``, and
``fused_trunk``, one eval pass of the denoiser trunk on it, as
``posediffusion_tpu.ops.denoiser_kernel.fused_trunk``.

The layer is seven launches: LayerNorm, QKV product, attention, output
product + residual, LayerNorm, first FF product + activation, second FF
product + residual. At most ``kernels.LINEAR_ROWS_MAX`` rows (the
denoiser's 20 frames) it is five: both LayerNorms fold into the product
they feed (``linear(ln=...)``, the few-rows route), since the layer is
pre-norm. The denoiser runs it with eps 1e-5, ReLU, a (B, N) key bias and
float32 activations; the ViT with eps 1e-6, exact-erf GELU, the (N, N)
scale-packing bias and, by default, bf16-rounded activations.

The TPU's ``fused_trunk`` runs all layers in one Pallas launch with the
activations in VMEM; here each layer is the same five launches, so the
trunk of the GGS-conditioned steps (one pass per step) reuses the kernels of
the fused sampler. ``fused_trunk.launches`` counts the passes on the card.
"""

from __future__ import annotations

import torch

from posediffusion_tpu_torch.ops.kernels import (
    KERNELS,
    LINEAR_ROWS_LN_MAX_K,
    LINEAR_ROWS_MAX,
    PLAIN,
)

# order of a layer's weights in encoder_layer_math's signature
TRUNK_KEYS = ("g1", "b1", "wqkv", "bqkv", "wout", "bout",
              "g2", "b2", "wl1", "bl1", "wl2", "bl2")


def encoder_layer_math(
    x, g1, b1, wqkv, bqkv, wout, bout, g2, b2, wl1, bl1, wl2, bl2,
    *, nhead: int, seq_len: int, eps: float = 1e-5, act: str = "relu",
    act_bf16: bool = False, attn_bias=None, key_bias=None, ops=KERNELS,
):
    """One layer on the (B * seq_len, D) float32 residual stream.

    ``ops`` is ``kernels.KERNELS`` (the wrappers: kernels on the card, plain
    versions on the CPU) or ``kernels.PLAIN`` (plain versions anywhere)."""
    rows = x.shape[0]
    B = rows // seq_len
    fold = rows <= LINEAR_ROWS_MAX and x.shape[1] <= LINEAR_ROWS_LN_MAX_K

    def normed_linear(x, g, b, w, bias, **kw):
        if fold:  # layernorm(round_out) then linear(round_a): the same sites
            return ops.linear(x, w, bias, round_a=act_bf16, ln=(g, b, eps), **kw)
        return ops.linear(ops.layernorm(x, g, b, eps, act_bf16), w, bias,
                          round_a=act_bf16, **kw)

    qkv = normed_linear(x, g1, b1, wqkv, bqkv)
    a = ops.attention(qkv.view(B, seq_len, -1), nhead, attn_bias=attn_bias,
                      key_bias=key_bias, round_in=act_bf16)
    x = ops.linear(a.reshape(rows, -1), wout, bout, residual=x, round_a=act_bf16)
    h = normed_linear(x, g2, b2, wl1, bl1, act=act)
    return ops.linear(h, wl2, bl2, residual=x, round_a=act_bf16)


def _stack(tensors, dtype):
    return torch.stack([t.detach() for t in tensors]).to(dtype).contiguous()


@torch.no_grad()
def stack_trunk_params(trunk, weight_dtype=torch.bfloat16) -> dict:
    """Denoiser ``TransformerEncoder`` -> per-array stacks with a leading
    layer axis. Matrices are (in, out) in ``weight_dtype`` (the sampler reads
    every trunk weight once per step, so bf16 halves its traffic); LayerNorm
    vectors and biases stay float32."""
    L = trunk.layers
    mats = {
        "wqkv": [l.self_attn.in_proj_weight.t() for l in L],
        "wout": [l.self_attn.out_proj.weight.t() for l in L],
        "wl1": [l.linear1.weight.t() for l in L],
        "wl2": [l.linear2.weight.t() for l in L],
    }
    vecs = {
        "g1": [l.norm1.weight for l in L], "b1": [l.norm1.bias for l in L],
        "bqkv": [l.self_attn.in_proj_bias for l in L],
        "bout": [l.self_attn.out_proj.bias for l in L],
        "g2": [l.norm2.weight for l in L], "b2": [l.norm2.bias for l in L],
        "bl1": [l.linear1.bias for l in L], "bl2": [l.linear2.bias for l in L],
    }
    out = {k: _stack(v, weight_dtype) for k, v in mats.items()}
    out.update({k: _stack(v, torch.float32) for k, v in vecs.items()})
    return out


def layer_weights(stacks: dict, keys=TRUNK_KEYS) -> list:
    """Per-layer tuples of views, in encoder_layer_math's argument order."""
    return [tuple(stacks[k][l] for k in keys)
            for l in range(stacks[keys[0]].shape[0])]


def _trunk(ops, x, mask_bias, stacks, nhead):
    h = x.to(torch.float32).contiguous()
    key_bias = mask_bias.to(torch.float32).reshape(1, -1).contiguous()
    for w in layer_weights(stacks):
        h = encoder_layer_math(h, *w, nhead=nhead, seq_len=h.shape[0], eps=1e-5,
                               act="relu", key_bias=key_bias, ops=ops)
    return h


@torch.no_grad()
def fused_trunk(x: torch.Tensor, mask_bias: torch.Tensor, stacks: dict,
                nhead: int = 4) -> torch.Tensor:
    """All layers of the denoiser trunk on one sequence through the kernel
    wrappers: x (N, d_model) tokens, mask_bias (N,) additive key bias (0 or
    NEG), ``stacks`` from ``stack_trunk_params`` -> (N, d_model) float32."""
    if x.is_cuda:
        fused_trunk.launches += 1
    return _trunk(KERNELS, x, mask_bias, stacks, nhead)


fused_trunk.launches = 0


@torch.no_grad()
def fused_trunk_plain(x: torch.Tensor, mask_bias: torch.Tensor, stacks: dict,
                      nhead: int = 4) -> torch.Tensor:
    """The same math in plain PyTorch on any device."""
    return _trunk(PLAIN, x, mask_bias, stacks, nhead)
