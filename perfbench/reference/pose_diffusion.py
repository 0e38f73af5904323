"""Plain PyTorch PoseDiffusion for training: the multi-scale ViT extractor
(DINO ViT-S/16 or DINOv2 ViT-S/14), the pose denoiser and the DDPM loss,
written from the model's description with nothing of the program.

Parameters are a dict of float32 tensors under the released checkpoint's
keys (``param_specs``). Every product is a plain ``torch`` call; the caller
decides TF32 (``reference.train`` switches it off).

The model (PoseDiffusion, Wang et al. 2023; the repo's ``cfgs/``):
- images normalised with ImageNet's statistics, then at each scale factor
  (1, 1/2, 1/3) bilinearly resized (torch's ``scale_factor`` sizes and
  coordinates), patch-embedded, given a CLS token and the position grid
  (bicubic-resized where the grid differs), and run through the pre-norm
  blocks (LayerNorm eps 1e-6, exact GELU; DINOv2 scales each branch by its
  LayerScale gain); the final LayerNorm of each scale's CLS token, averaged
  over the scales. Each scale is its own sequence. Departure from DINO and
  DINOv2 upstream, as the repo's model: the positions are resized to the
  grid's size (no +0.1 offset, no antialiasing).
- the denoiser's token per frame: [harmonic embedding of the pose (10
  frequencies 2^0..2^9: sin | cos | x) | time embedding (sinusoidal 256,
  cos | sin, then Linear, SiLU, Linear) | image feature | 1 on frame 0],
  a Linear to d_model, the pre-norm encoder (LayerNorm eps 1e-5, ReLU,
  dropout on the attention probabilities, after the output projection,
  after the activation and after the second product), and the head
  (Linear, LayerNorm, ReLU, Linear).
- the loss: x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) noise on the
  ``batch_repeat``-tiled batch, the L1 error of the predicted noise, masked
  by the frame mask and divided by (valid frames x 9).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import dropout

VIT = "image_feature_extractor._net."
DEN = "diffuser.model."
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Params = Dict[str, torch.Tensor]


def _linear_specs(prefix: str, n_in: int, n_out: int):
    return [(prefix + "weight", (n_out, n_in), "normal"), (prefix + "bias", (n_out,), "normal")]


def _norm_specs(prefix: str, dim: int):
    return [(prefix + "weight", (dim,), "one"), (prefix + "bias", (dim,), "normal")]


def param_specs(config: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every parameter; the law is "normal" (the
    weight maker's N(0, std)) or "one" (1 + that: LayerNorm weights and
    LayerScale gains)."""
    ex, dn = config["extractor"], config["denoiser"]
    D, p, g = ex["embed_dim"], ex["patch_size"], ex["pos_grid"]
    Fv = int(D * ex["mlp_ratio"])
    specs = [(VIT + "cls_token", (1, 1, D), "normal"),
             (VIT + "pos_embed", (1, 1 + g * g, D), "normal"),
             (VIT + "patch_embed.proj.weight", (D, 3, p, p), "normal"),
             (VIT + "patch_embed.proj.bias", (D,), "normal")]
    for i in range(ex["depth"]):
        b = f"{VIT}blocks.{i}."
        specs += _norm_specs(b + "norm1.", D)
        specs += _linear_specs(b + "attn.qkv.", D, 3 * D)
        specs += _linear_specs(b + "attn.proj.", D, D)
        specs += _norm_specs(b + "norm2.", D)
        specs += _linear_specs(b + "mlp.fc1.", D, Fv)
        specs += _linear_specs(b + "mlp.fc2.", Fv, D)
        if ex["layer_scale"]:
            specs += [(b + "ls1.gamma", (D,), "one"), (b + "ls2.gamma", (D,), "one")]
    specs += _norm_specs(VIT + "norm.", D)

    D2, F2, H2, td = dn["d_model"], dn["dim_feedforward"], dn["mlp_hidden_dim"], dn["time_dim"]
    in_dim = (dn["target_dim"] * (2 * dn["n_harmonic_functions"] + 1) + td // 2 + D
              + int(dn["pivot_cam_onehot"]))
    specs += _linear_specs(DEN + "time_embed.linear.0.", td, td // 2)
    specs += _linear_specs(DEN + "time_embed.linear.2.", td // 2, td // 2)
    specs += _linear_specs(DEN + "_first.", in_dim, D2)
    for i in range(dn["num_encoder_layers"]):
        b = f"{DEN}_trunk.layers.{i}."
        specs += [(b + "self_attn.in_proj_weight", (3 * D2, D2), "normal"),
                  (b + "self_attn.in_proj_bias", (3 * D2,), "normal")]
        specs += _linear_specs(b + "self_attn.out_proj.", D2, D2)
        specs += _linear_specs(b + "linear1.", D2, F2)
        specs += _linear_specs(b + "linear2.", F2, D2)
        specs += _norm_specs(b + "norm1.", D2)
        specs += _norm_specs(b + "norm2.", D2)
    specs += _linear_specs(DEN + "_last.0.", D2, H2)
    specs += _norm_specs(DEN + "_last.1.", H2)
    specs += _linear_specs(DEN + "_last.3.", H2, dn["target_dim"])
    return specs


# ------------------------------------------------------------------ extractor
def _attend(q, k, v, key_mask: Optional[torch.Tensor] = None,
            drop: Optional[torch.Tensor] = None):
    """Softmax attention of (B, H, N, Dh) heads; ``key_mask`` (B, N) bool
    of valid keys; ``drop`` the probabilities' dropout multipliers."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if drop is not None:
        p = p * drop
    return p @ v


def _heads(qkv: torch.Tensor, nhead: int):
    B, N, D3 = qkv.shape
    return qkv.view(B, N, 3, nhead, D3 // 3 // nhead).permute(2, 0, 3, 1, 4)


def _vit_block(P: Params, i: int, x: torch.Tensor, ex: dict) -> torch.Tensor:
    b = f"{VIT}blocks.{i}."
    B, N, D = x.shape
    eps = ex["ln_eps"]
    h = F.layer_norm(x, (D,), P[b + "norm1.weight"], P[b + "norm1.bias"], eps)
    q, k, v = _heads(F.linear(h, P[b + "attn.qkv.weight"], P[b + "attn.qkv.bias"]), ex["num_heads"])
    a = _attend(q, k, v).transpose(1, 2).reshape(B, N, D)
    a = F.linear(a, P[b + "attn.proj.weight"], P[b + "attn.proj.bias"])
    if ex["layer_scale"]:
        a = a * P[b + "ls1.gamma"]
    x = x + a
    h = F.layer_norm(x, (D,), P[b + "norm2.weight"], P[b + "norm2.bias"], eps)
    h = F.linear(F.gelu(F.linear(h, P[b + "mlp.fc1.weight"], P[b + "mlp.fc1.bias"])),
                 P[b + "mlp.fc2.weight"], P[b + "mlp.fc2.bias"])
    if ex["layer_scale"]:
        h = h * P[b + "ls2.gamma"]
    return x + h


def _positions(P: Params, ex: dict, h0: int, w0: int) -> torch.Tensor:
    pos, g = P[VIT + "pos_embed"], ex["pos_grid"]
    if (h0, w0) == (g, g):
        return pos
    grid = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(h0, w0), mode="bicubic", align_corners=False)
    return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)


def vit_features(P: Params, images: torch.Tensor, config: dict) -> torch.Tensor:
    """(b, 3, H, W) images in [0, 1] -> (b, D) features."""
    ex = config["extractor"]
    mean = torch.tensor(IMAGENET_MEAN, device=images.device).view(3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=images.device).view(3, 1, 1)
    x = (images - mean) / std
    D = ex["embed_dim"]
    feats = []
    for s in ex["scale_factors"]:
        img = x if s == 1 else F.interpolate(x, scale_factor=s, mode="bilinear",
                                             align_corners=False)
        t = F.conv2d(img, P[VIT + "patch_embed.proj.weight"], P[VIT + "patch_embed.proj.bias"],
                     stride=ex["patch_size"])
        b, _, h0, w0 = t.shape
        t = torch.cat([P[VIT + "cls_token"].expand(b, 1, D), t.flatten(2).transpose(1, 2)], dim=1)
        t = t + _positions(P, ex, h0, w0)
        for i in range(ex["depth"]):
            t = _vit_block(P, i, t, ex)
        feats.append(F.layer_norm(t[:, 0], (D,), P[VIT + "norm.weight"], P[VIT + "norm.bias"],
                                  ex["ln_eps"]))
    return sum(feats) / len(feats)


# ------------------------------------------------------------------- denoiser
def _harmonic(x: torch.Tensor, n: int) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(n, dtype=x.dtype, device=x.device)
    e = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(e), torch.cos(e), x], dim=-1)


def _time_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                          device=t.device) / half)
    a = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def denoiser(P: Params, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor,
             mask: torch.Tensor, drop_seed: int, rate: float, config: dict) -> torch.Tensor:
    """(B, N, 9) noisy poses at timesteps t (B,), features z (B, N, D) and
    the (B, N) frame mask -> the predicted noise, with dropout ``rate``
    drawn from ``drop_seed``."""
    dn = config["denoiser"]
    B, N, _ = x.shape
    D2, H = dn["d_model"], dn["nhead"]
    M = B * N
    te = _time_features(t, dn["time_dim"])
    te = F.linear(F.silu(F.linear(te, P[DEN + "time_embed.linear.0.weight"],
                                  P[DEN + "time_embed.linear.0.bias"])),
                  P[DEN + "time_embed.linear.2.weight"], P[DEN + "time_embed.linear.2.bias"])
    parts = [_harmonic(x, dn["n_harmonic_functions"]), te[:, None, :].expand(B, N, -1), z]
    if dn["pivot_cam_onehot"]:
        pivot = torch.zeros((B, N, 1), device=x.device)
        pivot[:, 0] = 1.0
        parts.append(pivot)
    h = F.linear(torch.cat(parts, dim=-1), P[DEN + "_first.weight"], P[DEN + "_first.bias"])
    valid = mask.to(torch.bool)
    eps = dn["ln_eps"]
    for i in range(dn["num_encoder_layers"]):
        b = f"{DEN}_trunk.layers.{i}."

        def drop(site, shape):
            return dropout.mask(drop_seed, i, site, rate, shape, x.device)

        a = F.layer_norm(h, (D2,), P[b + "norm1.weight"], P[b + "norm1.bias"], eps)
        q, k, v = _heads(F.linear(a, P[b + "self_attn.in_proj_weight"],
                                  P[b + "self_attn.in_proj_bias"]), H)
        o = _attend(q, k, v, valid, drop("attn", (B, H, N, N))).transpose(1, 2).reshape(M, D2)
        o = F.linear(o, P[b + "self_attn.out_proj.weight"], P[b + "self_attn.out_proj.bias"])
        m1 = drop("m1", (M, D2))
        h = h + (o if m1 is None else o * m1).view(B, N, D2)
        a = F.layer_norm(h, (D2,), P[b + "norm2.weight"], P[b + "norm2.bias"], eps).reshape(M, D2)
        f = torch.relu(F.linear(a, P[b + "linear1.weight"], P[b + "linear1.bias"]))
        mff = drop("mff", (M, dn["dim_feedforward"]))
        f = F.linear(f if mff is None else f * mff, P[b + "linear2.weight"], P[b + "linear2.bias"])
        m2 = drop("m2", (M, D2))
        h = h + (f if m2 is None else f * m2).view(B, N, D2)
    h = F.linear(h, P[DEN + "_last.0.weight"], P[DEN + "_last.0.bias"])
    h = torch.relu(F.layer_norm(h, (dn["mlp_hidden_dim"],), P[DEN + "_last.1.weight"],
                                P[DEN + "_last.1.bias"], eps))
    return F.linear(h, P[DEN + "_last.3.weight"], P[DEN + "_last.3.bias"])


# ----------------------------------------------------------------------- loss
def schedule(config: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sqrt(acp), sqrt(1 - acp)) of the custom schedule, linspace(beta_1,
    beta_T, T), worked out in float64 and stored as float32."""
    d = config["diffusion"]
    if d["beta_schedule"] != "custom":
        raise ValueError(f"the reference knows the custom schedule only, not {d['beta_schedule']}")
    acp = np.cumprod(1.0 - np.linspace(d["beta_1"], d["beta_T"], d["timesteps"], dtype=np.float64))
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    return f32(np.sqrt(acp)), f32(np.sqrt(1.0 - acp))


def diffusion_loss(P: Params, z: torch.Tensor, poses: torch.Tensor, mask: torch.Tensor,
                   draws: dict, batch_repeat: int, config: dict) -> torch.Tensor:
    """The normalised L1 loss of the predicted noise over the tiled batch:
    z (B, N, D) features, poses (B, N, 9), mask (B, N); ``draws`` t (B'),
    noise (B', N, 9), drop_seed, B' = B x batch_repeat (row r B + b is
    sequence b)."""
    d = config["diffusion"]
    if d["objective"] != "pred_noise" or d["loss_type"] != "l1":
        raise ValueError("the reference knows the pred_noise objective with the l1 loss")
    R = max(batch_repeat, 1)
    x0, zr, mr = poses.repeat(R, 1, 1), z.repeat(R, 1, 1), mask.repeat(R, 1)
    t = draws["t"].to(z.device)
    noise = draws["noise"].to(z.device)
    a, s = schedule(config, z.device)
    xt = a[t].view(-1, 1, 1) * x0 + s[t].view(-1, 1, 1) * noise
    out = denoiser(P, xt, t, zr, mr, draws["drop_seed"], config["denoiser"]["dropout"], config)
    err = (out - noise).abs() * mr[..., None].to(out.dtype)
    return err.sum() / (mr.to(torch.float32).sum().clamp(min=1.0) * poses.shape[-1])
