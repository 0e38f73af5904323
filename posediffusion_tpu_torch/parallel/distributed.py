"""Process-group set-up and the collectives of the data-parallel train step,
the counterpart of ``posediffusion_tpu.parallel`` for one process a card.

The JAX package runs data parallelism as one SPMD program over a mesh
(``train.dp``; ``training/step.make_sharded_train_step``: per-shard loss
and gradients, ``psum`` over the "dp" axis). Here each rank is a process
(torchrun, or any launcher that sets its variables), and the train step
all-reduces what the ``psum`` sums: the loss's denominator and the
gradients (``training/step.train_step(distributed=True)``). NCCL carries
the collectives between cards, gloo on the CPU. The mesh's other axis,
FSDP (``train.fsdp``), shards the parameters: ``parallel/mesh``.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(device_type: str = "cuda") -> bool:
    """Initialise the default process group from torchrun's variables
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL for ``device_type`` "cuda", gloo for "cpu".
    Returns False without them (one process, no group), True when the group
    is up (also when it already was)."""
    if not all(v in os.environ for v in ENV):
        return False
    if dist.is_initialized():
        return True
    dist.init_process_group(
        backend="nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return True


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This process's card on its host (torchrun's ``LOCAL_RANK``; 0)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (in place, and returned)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the ranks (``psum`` of the
    gradients, not their mean), in one collective on the flattened
    gradients; a parameter without a gradient counts as zeros."""
    params = list(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(g)
        off += n
