"""The SuperGlue matcher over a chunk of pairs, as
``posediffusion_tpu.ops.superglue_kernel.fused_match_pairs``.

The TPU kernel runs all 18 GNN layers, the final projection, Sinkhorn and
match extraction in one Pallas launch with the (C, 2, K, D) tokens in VMEM.
Here the tokens stay in device memory and each step is a hand-written
kernel (``ops/kernels.py``):

* per layer, on the (2C * K, D) stream of both sets of every pair:
  ``linear`` for the packed q | k | v product, ``attention`` with a (2C, K)
  key bias (4 heads of 64; a cross layer swaps the k | v half, and the key
  bias, between the two sets of each pair), ``linear`` for the merge, for
  ``[x | message] @ w1`` with ReLU and for ``@ w2`` plus the residual;
* ``linear`` for the final projection, then ``superglue_coupling``,
  ``superglue_sinkhorn`` and ``superglue_matches`` (``csrc/superglue.cu``).

Hopper has no VMEM budget, so this one route serves every K (the JAX
package switches to ``match_pairs_batched_xla`` above K ~ 2048). Routing
is by the tensors' device: on CUDA tensors every step launches its kernel;
on CPU tensors every step is its plain version, which makes
``fused_match_pairs`` on the CPU the counterpart of
``matching.superglue.match_pairs_batched_xla``. ``fused_match_pairs_plain``
runs the plain versions on any device.
"""

from __future__ import annotations

import torch

from posediffusion_tpu_torch.matching.superglue import SuperGlue
from posediffusion_tpu_torch.ops.kernels import KERNELS, PLAIN, SG_NEG

STACK_KEYS = ("wqkv", "bqkv", "wm", "bm", "w1", "b1", "w2", "b2")


def head_perm(d_model: int = 256, num_heads: int = 4) -> torch.Tensor:
    """Channel permutation from MagicLeap's interleaved heads (head h owns
    channels {d * H + h}) to contiguous heads ({h * Dh + d}): contiguous
    channel c takes interleaved channel perm[c]."""
    dh = d_model // num_heads
    c = torch.arange(d_model)
    return (c % dh) * num_heads + (c // dh)


def _dense(conv) -> tuple:
    """A kernel-1 Conv1d as a (in, out) matrix and its bias, float32."""
    return conv.weight[:, :, 0].t().float(), conv.bias.float()


@torch.no_grad()
def stack_superglue_params(model: SuperGlue) -> dict:
    """SuperGlue -> per-layer stacks with a leading layer axis, float32,
    (in, out) matrices. The head permutation is folded into the q, k, v
    output channels and the merge input channels, so the attention kernel
    splits heads contiguously; each message-MLP BatchNorm (inference) is
    folded into its conv: x (W g) + (b - mean) g + bias, g = scale /
    sqrt(var + 1e-5)."""
    perm = head_perm(model.d_model, model.num_heads).to(model.bin_score.device)
    stacks = {k: [] for k in STACK_KEYS}
    for layer in model.gnn.layers:
        attn, mlp = layer.attn, layer.mlp
        ws, bs = zip(*(_dense(p) for p in attn.proj))
        stacks["wqkv"].append(torch.cat([w[:, perm] for w in ws], 1))
        stacks["bqkv"].append(torch.cat([b[perm] for b in bs]))
        wm, bm = _dense(attn.merge)
        stacks["wm"].append(wm[perm, :])
        stacks["bm"].append(bm)
        w1, b1 = _dense(mlp[0])
        bn = mlp[1]
        g = bn.weight.float() / torch.sqrt(bn.running_var.float() + 1e-5)
        stacks["w1"].append(w1 * g)
        stacks["b1"].append((b1 - bn.running_mean.float()) * g + bn.bias.float())
        w2, b2 = _dense(mlp[3])
        stacks["w2"].append(w2)
        stacks["b2"].append(b2)
    out = {k: torch.stack(v).contiguous() for k, v in stacks.items()}
    wf, bf = _dense(model.final_proj)
    out["wf"], out["bf"] = wf.contiguous(), bf.contiguous()
    out["bin"] = model.bin_score.detach().float().reshape(1).clone()
    return out


def gnn_projections(ops, x, mask0, mask1, stacks, nhead: int = 4):
    """The 18 GNN layers and the final projection through ``ops``
    (``kernels.KERNELS`` or ``kernels.PLAIN``): x (C, 2, K, D) -> m
    (C, 2, K, D)."""
    C, two, K, D = x.shape
    if two != 2:
        raise ValueError(f"x must be (C, 2, K, D), got {tuple(x.shape)}")
    masks = torch.stack([mask0, mask1], 1).to(torch.bool)           # (C, 2, K)
    bias_self = torch.where(masks, 0.0, SG_NEG).reshape(2 * C, K).contiguous()
    bias_cross = bias_self.view(C, 2, K).flip(1).reshape(2 * C, K).contiguous()
    h = x.to(torch.float32).reshape(2 * C * K, D).contiguous()      # row (c, s, k)
    for layer in range(stacks["wqkv"].shape[0]):
        wqkv, bqkv, wm, bm, w1, b1, w2, b2 = (stacks[k][layer] for k in STACK_KEYS)
        cross = layer % 2 == 1  # self layers are even, as in MagicLeap's order
        qkv = ops.linear(h, wqkv, bqkv).view(C, 2, K, 3 * D)
        if cross:  # keys and values from the other set of the pair
            qkv = torch.cat([qkv[..., :D], qkv[..., D:].flip(1)], -1)
        msg = ops.attention(qkv.reshape(2 * C, K, 3 * D).contiguous(), nhead,
                            key_bias=bias_cross if cross else bias_self)
        msg = ops.linear(msg.reshape(2 * C * K, D), wm, bm)
        hmid = ops.linear(torch.cat([h, msg], 1), w1, b1, act="relu")
        h = ops.linear(hmid, w2, b2, residual=h)
    return ops.linear(h, stacks["wf"], stacks["bf"]).view(C, 2, K, D)


def _match_pairs(ops, x, mask0, mask1, stacks, nhead, sinkhorn_iters, match_threshold):
    m = gnn_projections(ops, x, mask0, mask1, stacks, nhead)
    mf0 = mask0.to(torch.float32).contiguous()
    mf1 = mask1.to(torch.float32).contiguous()
    cpl, log_mu, log_nu, norm = ops.superglue_coupling(m, mf0, mf1, stacks["bin"])
    Z = ops.superglue_sinkhorn(cpl, log_mu, log_nu, norm, sinkhorn_iters)
    return ops.superglue_matches(Z, mf0, mf1, match_threshold)


@torch.no_grad()
def fused_match_pairs(x: torch.Tensor, mask0: torch.Tensor, mask1: torch.Tensor,
                      stacks: dict, nhead: int = 4, sinkhorn_iters: int = 50,
                      match_threshold: float = 0.2):
    """Match C keypoint-set pairs: x (C, 2, K, D) keypoint-encoded tokens
    (``matching.superglue.encode_keypoints``), mask0 / mask1 (C, K) validity
    of set 0 / set 1, ``stacks`` from ``stack_superglue_params``. Returns
    (matches0 (C, K) int32 into set 1 or -1, mscores0 (C, K) float32).
    On CUDA tensors every step is a kernel launch."""
    return _match_pairs(KERNELS, x, mask0, mask1, stacks, nhead, sinkhorn_iters,
                        match_threshold)


@torch.no_grad()
def fused_match_pairs_plain(x: torch.Tensor, mask0: torch.Tensor, mask1: torch.Tensor,
                            stacks: dict, nhead: int = 4, sinkhorn_iters: int = 50,
                            match_threshold: float = 0.2):
    """The same math in plain PyTorch on any device."""
    return _match_pairs(PLAIN, x, mask0, mask1, stacks, nhead, sinkhorn_iters,
                        match_threshold)
