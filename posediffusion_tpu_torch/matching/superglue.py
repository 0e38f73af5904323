"""SuperGlue attentional matcher, as ``posediffusion_tpu.matching.superglue``.

``SuperGlue`` is MagicLeap's network with MagicLeap's parameter names
(``kenc.encoder.{0,1,3,4,6,7,9,10,12}``, ``gnn.layers.{i}.attn.proj.{0,1,2}``,
``.attn.merge``, ``.mlp.{0,1,3}``, ``final_proj``, ``bin_score``), so a
released ``superglue_outdoor.pth`` loads with ``strict=True``:

* keypoint encoder MLP([3, 32, 64, 128, 256, 256]) over (x, y, score),
  added to the descriptors;
* 18 alternating self/cross attention layers (4 heads, width 256), message
  MLP([512, 512, 256]) with a residual;
* final projection, scaled dot scores, log-domain Sinkhorn with a learned
  dustbin score, mutual-nearest matches above a threshold.

MagicLeap's heads are channel-interleaved: the (B, C, N) projection is
viewed as (B, Dh, H, N), so head h owns channels {d * H + h}. ``match_pair``
computes exactly that layout from the state dict, and is the plain per-pair
route. The batched route (``ops/superglue_kernel.py``) folds the permutation
to contiguous heads, and the inference BatchNorms, into stacked weights.
BatchNorms run in inference mode on the running statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from posediffusion_tpu_torch.ops.kernels import NEG as ATTN_NEG  # a masked key
from posediffusion_tpu_torch.ops.kernels import SG_NEG as NEG  # a masked coupling cell

KENC_CHANNELS = (3, 32, 64, 128, 256, 256)


def _mlp(channels) -> nn.Sequential:
    """MagicLeap ``MLP``: Conv1d, BatchNorm1d, ReLU between layers, none
    after the last conv."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], 1))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class KeypointEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _mlp(KENC_CHANNELS)


class MultiHeadedAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int):
        super().__init__()
        self.num_heads = num_heads
        self.merge = nn.Conv1d(d_model, d_model, 1)
        self.proj = nn.ModuleList([nn.Conv1d(d_model, d_model, 1) for _ in range(3)])


class AttentionalPropagation(nn.Module):
    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadedAttention(num_heads, d_model)
        self.mlp = _mlp([2 * d_model, 2 * d_model, d_model])


class AttentionalGNN(nn.Module):
    def __init__(self, d_model: int, num_layers: int, num_heads: int):
        super().__init__()
        self.layers = nn.ModuleList([AttentionalPropagation(d_model, num_heads)
                                     for _ in range(num_layers)])


class SuperGlue(nn.Module):
    """Parameters only; the math is in the functions below."""

    def __init__(self, d_model: int = 256, num_heads: int = 4, gnn_layers: int = 9):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.kenc = KeypointEncoder()
        self.gnn = AttentionalGNN(d_model, 2 * gnn_layers, num_heads)
        self.final_proj = nn.Conv1d(d_model, d_model, 1)
        self.bin_score = nn.Parameter(torch.tensor(1.0))


# ----------------------------------------------------------- channel-last math
def conv1x1(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A kernel-1 Conv1d on channel-last (..., N, C_in) tokens."""
    return x @ conv.weight[:, :, 0].t() + conv.bias


def batchnorm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Inference BatchNorm on channel-last tokens (eps 1e-5)."""
    return (x - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5) * bn.weight + bn.bias


def run_mlp(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    for layer in seq:
        if isinstance(layer, nn.Conv1d):
            x = conv1x1(x, layer)
        elif isinstance(layer, nn.BatchNorm1d):
            x = batchnorm(x, layer)
        else:
            x = torch.relu(x)
    return x


def normalize_keypoints(kpts: torch.Tensor, hw) -> torch.Tensor:
    """MagicLeap keypoint normalisation: centre at the image midpoint, divide
    by 0.7 x the longer side. ``hw`` is an (h, w) tuple or a (..., 2) tensor
    of per-frame sizes broadcast against (..., K, 2) keypoints."""
    if isinstance(hw, tuple):
        h, w = hw
        center = torch.tensor([w / 2.0, h / 2.0], dtype=kpts.dtype, device=kpts.device)
        return (kpts - center) / (0.7 * max(w, h))
    hw = torch.as_tensor(hw, dtype=torch.float32, device=kpts.device)
    center = hw.flip(-1) / 2.0                            # (..., 2) = (cx, cy)
    denom = 0.7 * hw.amax(dim=-1, keepdim=True)           # (..., 1)
    return (kpts - center[..., None, :]) / denom[..., None, :]


@torch.no_grad()
def encode_keypoints(model: SuperGlue, desc, kpts, scores, image_hw) -> torch.Tensor:
    """Keypoint-encoder initialisation x = desc + kenc(pos, score) of every
    frame: desc (F, K, 256), kpts (F, K, 2), scores (F, K), image_hw (F, 2)
    -> (F, K, 256) tokens for the batched matcher."""
    n = normalize_keypoints(kpts, image_hw)
    return desc + run_mlp(model.kenc.encoder, torch.cat([n, scores[..., None]], -1))


def _attention(q, k, v, key_mask, num_heads: int):
    """MagicLeap attention on channel-last (B, N, C) q, k, v with its
    interleaved heads (channel d * H + h belongs to head h), keys masked by a
    (B, N) bool."""
    B, Nq, C = q.shape
    Dh = C // num_heads
    heads = lambda t: t.reshape(B, t.shape[1], Dh, num_heads).permute(0, 3, 1, 2)
    qh, kh, vh = heads(q), heads(k), heads(v)                 # (B, H, N, Dh)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / Dh**0.5)
    if key_mask is not None:
        s = s + torch.where(key_mask, 0.0, ATTN_NEG)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = p @ vh                                              # (B, H, Nq, Dh)
    return out.permute(0, 2, 3, 1).reshape(B, Nq, C)


def _propagate(layer: AttentionalPropagation, x, source, source_mask, num_heads):
    attn = layer.attn
    q, k, v = (conv1x1(t, p) for t, p in zip((x, source, source), attn.proj))
    message = conv1x1(_attention(q, k, v, source_mask, num_heads), attn.merge)
    return run_mlp(layer.mlp, torch.cat([x, message], dim=-1))


def log_sinkhorn(scores, bin_score, mask0, mask1, iterations: int):
    """Log-domain Sinkhorn over the (K0+1) x (K1+1) augmented score matrix:
    padded rows and columns are masked to NEG against real entries, the
    marginals count only valid keypoints. Returns the log assignment Z."""
    b, m, n = scores.shape
    valid0 = mask0.to(scores.dtype)
    valid1 = mask1.to(scores.dtype)
    pair_mask = valid0[:, :, None] * valid1[:, None, :]
    scores = torch.where(pair_mask > 0, scores, NEG)
    bin_score = torch.as_tensor(bin_score, dtype=scores.dtype, device=scores.device)
    couplings = torch.cat([
        torch.cat([scores, bin_score.expand(b, m, 1)], -1),
        torch.cat([bin_score.expand(b, 1, n), bin_score.expand(b, 1, 1)], -1),
    ], 1)

    ms = valid0.sum(1)
    ns = valid1.sum(1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], NEG),
                        (torch.log(ns) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], NEG),
                        (torch.log(ms) + norm)[:, None]], 1)
    ones = torch.ones((b, 1), dtype=torch.bool, device=scores.device)
    cell = torch.cat([mask0, ones], 1)[:, :, None] & torch.cat([mask1, ones], 1)[:, None, :]
    couplings = torch.where(cell, couplings, NEG)

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iterations):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[:, None, None]


@torch.no_grad()
def match_pair(
    model: SuperGlue,
    desc0, desc1, kpts0, kpts1, scores0, scores1, mask0, mask1,
    image_hw: Tuple[int, int],
    sinkhorn_iterations: int = 50,
    match_threshold: float = 0.2,
    image_hw1: Optional[Tuple[int, int]] = None,
):
    """Match two padded keypoint sets given as (1, K, ...) tensors, masks
    (1, K) bool. Returns (matches0 (K0,) int32 index into set 1 or -1,
    mscores0 (K0,)). ``image_hw`` normalises set 0's keypoints; pass
    ``image_hw1`` when the frames differ in size."""
    image_hw1 = image_hw1 or image_hw
    H = model.num_heads
    kenc = model.kenc.encoder
    x0 = desc0 + run_mlp(kenc, torch.cat([normalize_keypoints(kpts0, image_hw),
                                          scores0[..., None]], -1))
    x1 = desc1 + run_mlp(kenc, torch.cat([normalize_keypoints(kpts1, image_hw1),
                                          scores1[..., None]], -1))
    for i, layer in enumerate(model.gnn.layers):
        if i % 2 == 0:  # self attention
            x0 = x0 + _propagate(layer, x0, x0, mask0, H)
            x1 = x1 + _propagate(layer, x1, x1, mask1, H)
        else:  # cross attention
            x0, x1 = (x0 + _propagate(layer, x0, x1, mask1, H),
                      x1 + _propagate(layer, x1, x0, mask0, H))
    m0 = conv1x1(x0, model.final_proj)
    m1 = conv1x1(x1, model.final_proj)
    scores = (m0 @ m1.transpose(1, 2)) / model.d_model**0.5
    Z = log_sinkhorn(scores, model.bin_score, mask0, mask1, sinkhorn_iterations)[:, :-1, :-1]

    max0, idx0 = Z.amax(dim=2), Z.argmax(dim=2)  # argmax: the first maximum
    idx1 = Z.argmax(dim=1)
    mutual = torch.gather(idx1, 1, idx0) == torch.arange(Z.shape[1], device=Z.device)[None]
    mscores = torch.exp(max0)
    ok = mutual & (mscores > match_threshold) & mask0 & torch.gather(mask1, 1, idx0)
    matches0 = torch.where(ok, idx0, -1).to(torch.int32)
    return matches0[0], torch.where(ok, mscores, 0.0)[0]
