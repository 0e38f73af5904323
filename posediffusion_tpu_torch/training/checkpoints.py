"""Full train-state checkpoints with ``torch.save``, as
``posediffusion_tpu.training.checkpoints``: the model, the optimizer's
moments and step, the schedule's settings, the step and (optionally) a
generator state, under ``<dir>/ckpt_<step>.pt``, keeping the newest few. A
reference ``.pth`` loads into the model strictly
(``load_reference_checkpoint``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from posediffusion_tpu_torch.utils.convert import load_reference_state_dict


def save(ckpt_dir: str, model: torch.nn.Module, optimizer, step: int,
         keep: int = 3, extra: Optional[dict] = None) -> str:
    """Write the full state at ``step`` and prune all but the ``keep``
    newest checkpoints. The write is atomic (a temporary file, renamed)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step:06d}.pt")
    state = {"step": int(step), "model": model.state_dict(),
             "optimizer": optimizer.state_dict(), **(extra or {})}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("ckpt_") and n.endswith(".pt"))
    for n in names[:-keep]:
        os.remove(os.path.join(ckpt_dir, n))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("ckpt_") and n.endswith(".pt"))
    return os.path.join(ckpt_dir, names[-1]) if names else None


def restore(path: str, model: torch.nn.Module, optimizer=None) -> dict:
    """Load a ``save``d state into ``model`` (strictly) and ``optimizer``;
    returns the whole dict (its ``step`` and any extras)."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return state


def load_reference_checkpoint(path: str, model: torch.nn.Module) -> None:
    """A released reference ``.pth`` into ``model``, strictly."""
    model.load_state_dict(load_reference_state_dict(path), strict=True)
