"""The train and eval steps, as ``posediffusion_tpu.training.step``.

The train step (reference pose_diffusion/train.py:151-253): the diffusion
loss normalised over the valid frames of the ``batch_repeat``-tiled batch,
its gradients, clipping and the AdamW update, then the pose metrics of the
x_0 predictions of the first repeat. The eval step samples cameras and
scores them (train.py:216-222).

Data parallelism (``distributed``, one process a card) follows
``make_sharded_train_step`` (``posediffusion_tpu/training/step.py
:127-210``): each rank's loss is its own sum over the denominator summed
over the ranks (the valid frames x 9, or the element count), its gradients
are summed over the ranks (not averaged), and every rank runs the same
AdamW update on the same gradients, the whole batch's gradient, as that
step's own reference test computes it (the JAX step itself applies world
size x it: a ``psum`` in its loss transposes to a second sum). Each rank
brings its own batch and draws; the metrics are the rank's own.

A sharded model (``parallel/mesh.shard_model``, FSDP) takes the same
denominators, and FSDP2 reduce-scatters its gradients as their mean over
the world: the step scales the loss by the world size before the
backward, so the shards hold the whole batch's gradient, as under data
parallelism and as the JAX package's GSPMD step (``make_train_step`` on
FSDP-placed parameters) computes it. It never calls ``all_reduce_grads``.
The eval step samples on the gathered model (``parallel/mesh.gathered``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from posediffusion_tpu_torch.geometry.metrics import (
    batched_all_pairs,
    calculate_auc,
    camera_to_rel_deg,
)
from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera
from posediffusion_tpu_torch.parallel.distributed import all_reduce_grads, all_reduce_sum
from posediffusion_tpu_torch.parallel.mesh import gathered, is_sharded
from posediffusion_tpu_torch.training.optim import AdamW
from posediffusion_tpu_torch.utils.profiling import span


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
                    mask: Optional[torch.Tensor], distributed: bool = False) -> torch.Tensor:
    """The unreduced loss -> its mean over the valid frames' coordinates
    (posediffusion_tpu/training/step.py:95-108); ``distributed``: this
    rank's sum over the denominator of all ranks (:176-189)."""
    if mask is None:
        if not distributed:
            return loss.mean()
        return loss.sum() / all_reduce_sum(torch.tensor(float(loss.numel()), device=loss.device))
    rep = mask.repeat(batch_repeat, 1) if batch_repeat > 0 else mask
    den = rep.to(torch.float32).sum()
    if distributed:
        den = all_reduce_sum(den)
    return loss.sum() / (den.clamp(min=1.0) * n_coords)


def train_step(model, optimizer: AdamW, batch: Dict[str, torch.Tensor],
               batch_repeat: int = 0, generator: Optional[torch.Generator] = None,
               draws: Optional[dict] = None, compute_metrics: bool = True,
               distributed: bool = False) -> Dict[str, float]:
    """One step on ``batch`` ({"images", "pose_encodings", optional "mask"}):
    loss, backward, clip and update. ``draws`` (t, noise, drop_seed) are
    the loss's random draws; else they come from ``generator``.
    ``distributed``: this rank's part of a data-parallel step (the loss
    reported is the whole step's); a sharded model's step is always one.
    Spans (``utils/profiling.span``): ``pd.train_step`` around the call,
    ``pd.loss``, ``pd.backward`` and ``pd.metrics`` inside it (AdamW opens
    ``pd.optimizer``)."""
    with span("train_step"):
        sharded = is_sharded(model)
        distributed = distributed or sharded
        gt = batch["pose_encodings"]
        mask = batch.get("mask")
        optimizer.zero_grad()
        with span("loss"):
            out = model.loss(batch["images"], gt, batch_repeat=batch_repeat, mask=mask,
                             train=True, generator=generator, **(draws or {}))
            loss = normalized_loss(out.loss, gt.shape[-1], batch_repeat, mask, distributed)
        with span("backward"):
            if sharded:
                (loss * dist.get_world_size()).backward()  # FSDP2 divides by the world
            else:
                loss.backward()
                if distributed:
                    all_reduce_grads(optimizer.params)
        if distributed:
            loss = all_reduce_sum(loss.detach().clone())
        info = optimizer.step()
        metrics = {"loss": float(loss.detach()), "lr": info["lr"],
                   "grad_norm": info["grad_norm"]}
        if compute_metrics:
            with span("metrics"), torch.no_grad():
                pm = pose_metrics(out.x_0_pred[: gt.shape[0]].detach(), gt, mask)
                metrics.update({k: float(v) for k, v in pm.items()})
        return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None):
    """Sample cameras for ``batch`` and score them: (encodings, metrics)."""
    mask = batch.get("mask")
    with gathered(model):
        enc = model.sample(batch["images"], generator=generator, mask=mask)
    return enc, {k: float(v) for k, v in pose_metrics(enc, batch["pose_encodings"], mask).items()}
