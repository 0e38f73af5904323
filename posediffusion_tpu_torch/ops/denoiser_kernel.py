"""One pre-norm transformer layer built from the kernels, shared by both
trunks, as ``posediffusion_tpu.ops.denoiser_kernel.encoder_layer_math``.

The layer is seven launches: LayerNorm, QKV product, attention, output
product + residual, LayerNorm, first FF product + activation, second FF
product + residual. The denoiser runs it with eps 1e-5, ReLU, a (B, N) key
bias and float32 activations; the ViT with eps 1e-6, exact-erf GELU, the
(N, N) scale-packing bias and, by default, bf16-rounded activations.
"""

from __future__ import annotations

import torch

from posediffusion_tpu_torch.ops.kernels import KERNELS

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
    h = ops.layernorm(x, g1, b1, eps, act_bf16)
    qkv = ops.linear(h, wqkv, bqkv, round_a=act_bf16)
    a = ops.attention(qkv.view(B, seq_len, -1), nhead, attn_bias=attn_bias,
                      key_bias=key_bias, round_in=act_bf16)
    x = ops.linear(a.reshape(rows, -1), wout, bout, residual=x, round_a=act_bf16)
    h = ops.layernorm(x, g2, b2, eps, act_bf16)
    h = ops.linear(h, wl1, bl1, act=act, round_a=act_bf16)
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
