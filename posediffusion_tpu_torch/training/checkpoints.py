"""Full train-state checkpoints with ``torch.save``, as
``posediffusion_tpu.training.checkpoints``: the model, the optimizer's
moments and step, the schedule's settings, the step and (optionally) a
generator state, under ``<dir>/ckpt_<step>.pt``, keeping the newest few. A
reference ``.pth`` loads into the model strictly
(``load_reference_checkpoint``).

A sharded model (``parallel/mesh.shard_model``) saves and loads whole
tensors: ``save`` gathers the parameters and the optimizer's moments on
every rank (call it on every rank) and writes them from one; ``restore``
and ``load_reference_checkpoint`` give each rank its shards. The file is
the same as one process writes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from posediffusion_tpu_torch.parallel.mesh import full_state_dict, load_full_state_dict
from posediffusion_tpu_torch.utils.convert import load_reference_state_dict


def save(ckpt_dir: str, model: torch.nn.Module, optimizer, step: int,
         keep: int = 3, extra: Optional[dict] = None, write: bool = True) -> str:
    """Write the full state at ``step`` and prune all but the ``keep``
    newest checkpoints. The write is atomic (a temporary file, renamed).
    ``write`` False gathers the state (a sharded model's collectives) and
    writes nothing: the other ranks of a sharded run."""
    path = os.path.join(ckpt_dir, f"ckpt_{step:06d}.pt")
    state = {"step": int(step), "model": full_state_dict(model, cpu=True),
             "optimizer": optimizer.state_dict(), **(extra or {})}
    if not write:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
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
    load_full_state_dict(model, state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return state


def load_reference_checkpoint(path: str, model: torch.nn.Module) -> None:
    """A released reference ``.pth`` into ``model``, strictly."""
    load_full_state_dict(model, load_reference_state_dict(path))
