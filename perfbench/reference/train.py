"""The reference's train steps: the loss, its gradients by autograd, and
AdamW, on the same weights, batches and draws as the program's first steps.

The extractor runs in chunks of images so that the full batch fits beside
nothing else on one card: the features of all images first without
gradients, then the denoiser's loss with the features as a leaf, then each
chunk again with gradients, its features' cotangent fed back. The sum is
the gradient of the whole batch's loss.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from perfbench.reference import pose_diffusion as pd
from perfbench.reference.adamw import AdamW

CHUNK_IMAGES = 64


@contextlib.contextmanager
def tf32(enabled: bool):
    """Products and convolutions in TF32 (``enabled``) or in full float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _half(batch: dict, draws: dict, batch_repeat: int) -> tuple:
    """The first half of the sequences and their rows of the draws (the
    fault "half of the batch left out, the mean taken over the rest")."""
    B = batch["images"].shape[0]
    h = B // 2
    R = max(batch_repeat, 1)
    rows = lambda x: x.view(R, B, *x.shape[1:])[:, :h].reshape(R * h, *x.shape[1:])  # noqa: E731
    return ({k: v[:h] for k, v in batch.items()},
            {"t": rows(draws["t"]), "noise": rows(draws["noise"]), "drop_seed": draws["drop_seed"]})


def loss_and_grads(P: Dict[str, torch.Tensor], batch: dict, draws: dict,
                   batch_repeat: int, config: dict):
    """(loss, {name: gradient}) of one step's batch."""
    images = batch["images"]
    B, N = images.shape[:2]
    flat = images.reshape(B * N, *images.shape[2:])
    for p in P.values():
        p.grad = None
    with torch.no_grad():
        z = torch.cat([pd.vit_features(P, flat[i:i + CHUNK_IMAGES], config)
                       for i in range(0, B * N, CHUNK_IMAGES)])
    z = z.view(B, N, -1).requires_grad_(True)
    loss = pd.diffusion_loss(P, z, batch["pose_encodings"], batch["mask"], draws,
                             batch_repeat, config)
    loss.backward()
    dz = z.grad.reshape(B * N, -1)
    for i in range(0, B * N, CHUNK_IMAGES):
        zc = pd.vit_features(P, flat[i:i + CHUNK_IMAGES], config)
        zc.backward(dz[i:i + CHUNK_IMAGES])
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in P.items()}
    return float(loss.detach()), grads


def reference_steps(config: dict, traffic: dict, weights: Dict[str, torch.Tensor],
                    batches: List[dict], draws: List[dict], use_tf32: bool = False,
                    fault: Optional[str] = None) -> dict:
    """Run len(batches) steps from ``weights`` (left untouched). Returns the
    losses, the first step's clipped gradient norm of each leaf, and each
    leaf's norm of change after the last step. ``fault`` "half_batch" plants
    that fault in the reference (a reading of it)."""
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
