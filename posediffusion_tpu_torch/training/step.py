"""The train and eval steps, as ``posediffusion_tpu.training.step`` (on one
card; data parallelism is not ported yet).

The train step (reference pose_diffusion/train.py:151-253): the diffusion
loss normalised over the valid frames of the ``batch_repeat``-tiled batch,
its gradients, clipping and the AdamW update, then the pose metrics of the
x_0 predictions of the first repeat. The eval step samples cameras and
scores them (train.py:216-222).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from posediffusion_tpu_torch.geometry.metrics import (
    batched_all_pairs,
    calculate_auc,
    camera_to_rel_deg,
)
from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera
from posediffusion_tpu_torch.training.optim import AdamW


def pose_metrics(pred_encodings: torch.Tensor, gt_encodings: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Racc/Tacc @5/15/30 and AUC@30 of (B, N, 9) encodings; with a (B, N)
    frame mask only pairs of two valid frames count (util/metric.py:14-48)."""
    B, N = pred_encodings.shape[:2]
    r_deg, t_deg = camera_to_rel_deg(pose_encoding_to_camera(pred_encodings),
                                     pose_encoding_to_camera(gt_encodings), B)
    w = None
    if mask is not None:
        i1, i2 = batched_all_pairs(B, N)
        flat = mask.reshape(-1).to(torch.float32)
        w = flat[torch.as_tensor(i1, device=flat.device)] * flat[torch.as_tensor(i2, device=flat.device)]
        denom = w.sum().clamp(min=1.0)

        def mean(x):
            return (x * w).sum() / denom
    else:
        mean = torch.mean
    out = {}
    for th in (5, 15, 30):
        out[f"Racc_{th}"] = mean((r_deg < th).to(torch.float32))
        out[f"Tacc_{th}"] = mean((t_deg < th).to(torch.float32))
    out["Auc_30"] = calculate_auc(r_deg, t_deg, max_threshold=30, weights=w)
    return out


def normalized_loss(loss: torch.Tensor, n_coords: int, batch_repeat: int,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The unreduced loss -> its mean over the valid frames' coordinates
    (posediffusion_tpu/training/step.py:95-108)."""
    if mask is None:
        return loss.mean()
    rep = mask.repeat(batch_repeat, 1) if batch_repeat > 0 else mask
    return loss.sum() / (rep.to(torch.float32).sum().clamp(min=1.0) * n_coords)


def train_step(model, optimizer: AdamW, batch: Dict[str, torch.Tensor],
               batch_repeat: int = 0, generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None,
               compute_metrics: bool = True) -> Dict[str, float]:
    """One step on ``batch`` ({"images", "pose_encodings", optional "mask"}):
    loss, backward, clip and update. ``draws`` (t, noise, drop_seed) are
    the loss's random draws; else they come from ``generator``."""
    gt = batch["pose_encodings"]
    mask = batch.get("mask")
    optimizer.zero_grad()
    out = model.loss(batch["images"], gt, batch_repeat=batch_repeat, mask=mask,
                     train=True, generator=generator, **(draws or {}))
    loss = normalized_loss(out.loss, gt.shape[-1], batch_repeat, mask)
    loss.backward()
    info = optimizer.step()
    metrics = {"loss": float(loss.detach()), "lr": info["lr"], "grad_norm": info["grad_norm"]}
    if compute_metrics:
        with torch.no_grad():
            pm = pose_metrics(out.x_0_pred[: gt.shape[0]].detach(), gt, mask)
        metrics.update({k: float(v) for k, v in pm.items()})
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None):
    """Sample cameras for ``batch`` and score them: (encodings, metrics)."""
    mask = batch.get("mask")
    enc = model.sample(batch["images"], generator=generator, mask=mask)
    return enc, {k: float(v) for k, v in pose_metrics(enc, batch["pose_encodings"], mask).items()}
