"""Plain PyTorch PoseDiffusion on DINOv2 ViT-g/14 for training: the
multi-scale extractor with DINOv2's SwiGLU feed-forward, the pose denoiser
and the DDPM loss (the last two, the positions and the AdamW taken from
``reference.pose_diffusion``, ``reference.adamw`` and ``reference.train`` by
import), written from the model's description with nothing of the program.

The backbone (facebookresearch/dinov2 ``vit_giant2`` with
``ffn_layer="swiglufused"``, as hubconf's ``dinov2_vitg14`` builds it):
D 1,536, 40 pre-norm blocks of 24 heads (LayerNorm eps 1e-6), LayerScale
on both branches, patch 14 and a 37 x 37 position grid; the feed-forward is
``dinov2/layers/swiglu_ffn.py`` ``SwiGLUFFN``'s math: ``x12 = w12(x)``,
``x1, x2 = x12.chunk(2)``, ``w3(silu(x1) * x2)``, with the hidden width
``SwiGLUFFNFused`` gives, (int(4 D x 2 / 3) + 7) // 8 x 8 = 4,096.
Parameters are a dict of float32 tensors under the released checkpoint's
keys (``param_specs``: ``blocks.N.mlp.w12`` and ``blocks.N.mlp.w3``).

Departures from DINOv2 upstream, as ``pd-dinov2-vits14``'s reference and
the repo's model: the positions are resized to the grid's size with
torch's bicubic and no +0.1 ``interpolate_offset`` and no antialiasing;
there is no ``mask_token`` (training never masks a patch here).

Every product is a plain ``torch`` call; ``reference_steps`` runs them with
TF32 off (``use_tf32`` on is the calibration's control).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import pose_diffusion as pd
from perfbench.reference.adamw import AdamW
from perfbench.reference.train import _half, tf32

VIT = pd.VIT
Params = Dict[str, torch.Tensor]

# Images a chunk of the extractor's backward: the autograd state of 40
# blocks is about 2.9 GB an image at 348 tokens (the SwiGLU's x12, silu and
# product, the attention's scores and probabilities of 24 heads), so 8
# images take about 23 GB beside the reference's 18.5 GB of weights,
# gradients and AdamW moments on one 80 GB card.
CHUNK_IMAGES = 8


def swiglu_hidden(ex: dict) -> int:
    """The configuration's ``ffn_hidden``, which has to be DINOv2's rule."""
    rule = (int(int(ex["embed_dim"] * ex["mlp_ratio"]) * 2 / 3) + 7) // 8 * 8
    if ex["ffn_hidden"] != rule:
        raise ValueError(f"ffn_hidden {ex['ffn_hidden']} is not DINOv2's {rule}")
    return rule


def param_specs(config: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every parameter: ``reference.pose_diffusion``'s
    with each block's ``mlp.fc1`` / ``mlp.fc2`` in the place of the SwiGLU's
    ``mlp.w12`` (2H, D) / ``mlp.w3`` (D, H)."""
    ex = config["extractor"]
    D, H = ex["embed_dim"], swiglu_hidden(ex)
    swap = {"mlp.fc1.weight": ("mlp.w12.weight", (2 * H, D)),
            "mlp.fc1.bias": ("mlp.w12.bias", (2 * H,)),
            "mlp.fc2.weight": ("mlp.w3.weight", (D, H)),
            "mlp.fc2.bias": ("mlp.w3.bias", (D,))}
    out = []
    for name, shape, law in pd.param_specs(config):
        prefix, _, leaf = name.rpartition(".mlp.")
        if leaf and prefix.startswith(VIT + "blocks."):
            new, shape = swap["mlp." + leaf]
            name = f"{prefix}.{new}"
        out.append((name, shape, law))
    return out


def _block(P: Params, i: int, x: torch.Tensor, ex: dict) -> torch.Tensor:
    b = f"{VIT}blocks.{i}."
    B, N, D = x.shape
    eps = ex["ln_eps"]
    h = F.layer_norm(x, (D,), P[b + "norm1.weight"], P[b + "norm1.bias"], eps)
    q, k, v = pd._heads(F.linear(h, P[b + "attn.qkv.weight"], P[b + "attn.qkv.bias"]),
                        ex["num_heads"])
    a = pd._attend(q, k, v).transpose(1, 2).reshape(B, N, D)
    x = x + F.linear(a, P[b + "attn.proj.weight"], P[b + "attn.proj.bias"]) * P[b + "ls1.gamma"]
    h = F.layer_norm(x, (D,), P[b + "norm2.weight"], P[b + "norm2.bias"], eps)
    x1, x2 = F.linear(h, P[b + "mlp.w12.weight"], P[b + "mlp.w12.bias"]).chunk(2, dim=-1)
    h = F.linear(F.silu(x1) * x2, P[b + "mlp.w3.weight"], P[b + "mlp.w3.bias"])
    return x + h * P[b + "ls2.gamma"]


def vit_features(P: Params, images: torch.Tensor, config: dict) -> torch.Tensor:
    """(b, 3, H, W) images in [0, 1] -> (b, D) features: each scale its own
    sequence, as ``reference.pose_diffusion.vit_features``."""
    ex = config["extractor"]
    mean = torch.tensor(pd.IMAGENET_MEAN, device=images.device).view(3, 1, 1)
    std = torch.tensor(pd.IMAGENET_STD, device=images.device).view(3, 1, 1)
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
        t = t + pd._positions(P, ex, h0, w0)
        for i in range(ex["depth"]):
            t = _block(P, i, t, ex)
        feats.append(F.layer_norm(t[:, 0], (D,), P[VIT + "norm.weight"], P[VIT + "norm.bias"],
                                  ex["ln_eps"]))
    return sum(feats) / len(feats)


def loss_and_grads(P: Params, batch: dict, draws: dict, batch_repeat: int, config: dict,
                   chunk: int = CHUNK_IMAGES):
    """(loss, {name: gradient}) of one step's batch, as
    ``reference.train.loss_and_grads``: the features of all images without
    gradients, the loss with them as a leaf, then each chunk of ``chunk``
    images again with gradients, its features' cotangent fed back."""
    images = batch["images"]
    B, N = images.shape[:2]
    flat = images.reshape(B * N, *images.shape[2:])
    for p in P.values():
        p.grad = None
    with torch.no_grad():
        z = torch.cat([vit_features(P, flat[i:i + chunk], config)
                       for i in range(0, B * N, chunk)])
    z = z.view(B, N, -1).requires_grad_(True)
    loss = pd.diffusion_loss(P, z, batch["pose_encodings"], batch["mask"], draws,
                             batch_repeat, config)
    loss.backward()
    dz = z.grad.reshape(B * N, -1)
    for i in range(0, B * N, chunk):
        zc = vit_features(P, flat[i:i + chunk], config)
        zc.backward(dz[i:i + chunk])
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in P.items()}
    return float(loss.detach()), grads


def reference_steps(config: dict, traffic: dict, weights: Params, batches: List[dict],
                    draws: List[dict], use_tf32: bool = False,
                    fault: Optional[str] = None) -> dict:
    """``reference.train.reference_steps`` on this model: len(batches) steps
    from ``weights`` (left untouched) -> the losses, the first step's clipped
    gradient norm of each leaf, and each leaf's norm of change after the
    last step; ``fault`` "half_batch" plants that fault."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = AdamW(P, config["optimizer"])
    losses, first = [], None
    with tf32(use_tf32):
        for batch, d in zip(batches, draws):
            if fault == "half_batch":
                batch, d = _half(batch, d, traffic["batch_repeat"])
            loss, grads = loss_and_grads(P, batch, d, traffic["batch_repeat"], config)
            losses.append(loss)
            with torch.no_grad():
                clipped = opt.step(P, grads)
            if first is None:
                first = {k: float(g.norm()) for k, g in clipped.items()}
            del grads, clipped
    change = {k: float((P[k].detach() - weights[k]).norm()) for k in P}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
