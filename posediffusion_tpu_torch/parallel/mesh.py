"""Parameter sharding (FSDP) over a ("dp", "fsdp") mesh of processes, the
counterpart of ``posediffusion_tpu.parallel.mesh``.

The JAX package places each parameter by ``fsdp_param_spec`` on a
``(n / fsdp, fsdp)`` mesh and lets GSPMD gather it. Here the mesh is a
``DeviceMesh`` of ranks (one process a card) and the model is one FSDP2
unit (``torch.distributed.fsdp.fully_shard``) whose shard dims follow the
same rule. With ``dp`` > 1 the 2-D mesh gives HSDP: each parameter is
sharded over "fsdp" and replicated over "dp".

The unit is the root model, not its blocks: the train trunks read every
block's weights from their parent's code (``stack_vit_params_train``, the
denoiser's ``stack_encoder_trunk_params``), never through a block's own
``forward``, so a block's FSDP hooks would never fire. ``shard_model``
registers ``loss`` as a forward method of the root, so the whole model is
gathered for the loss and its gradients reduce-scattered after the
backward; ``gathered`` unshards it around any other use (the eval's
``sample``).

FSDP2 averages the reduced gradients over the world; the train step scales
its loss by the world size before the backward, so the reduced gradient is
the whole batch's (``training/step.train_step``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional, Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor

MESH_DIMS = ("dp", "fsdp")

# parameters laid out as in the JAX package (every other parameter of two
# or more dims is a Linear weight (out, in), a Dense kernel (in, out)
# transposed, or an OIHW convolution, an HWIO kernel reversed)
SAME_LAYOUT = ("cls_token", "pos_embed")


def make_mesh(world: int, fsdp: int = 1, device_type: str = "cuda"):
    """The ``(world / fsdp, fsdp)`` mesh of the default group's ranks, its
    dims named ("dp", "fsdp") (``posediffusion_tpu/parallel/mesh.py:21``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if fsdp < 1 or world % fsdp:
        raise ValueError(f"world size {world} is not a multiple of fsdp={fsdp}")
    return init_device_mesh(device_type, (world // fsdp, fsdp), mesh_dim_names=MESH_DIMS)


def fsdp_param_spec(shape: Sequence[int], fsdp: int, transposed: bool = True) -> Optional[int]:
    """The dim of a port parameter of ``shape`` that the JAX rule shards
    over ``fsdp`` ranks, or None where it replicates
    (``posediffusion_tpu/parallel/mesh.py:45``).

    The JAX rule, on the JAX layout: a parameter of two or more dims is
    sharded along its last axis if that axis is a multiple of ``fsdp`` and
    at least 2 ``fsdp`` long, else along its second-last axis on the same
    terms, else replicated; so is any parameter below two dims.

    The port's layout (``transposed``): a Flax Dense kernel (in, out) is an
    ``nn.Linear`` weight (out, in) and a Flax HWIO convolution kernel an
    OIHW weight, so the JAX last and second-last axes are the port's dims 0
    and 1. A parameter named in ``SAME_LAYOUT`` (``transposed`` False) has
    the JAX shape, and its last two dims are the JAX ones."""
    n = len(shape)
    if fsdp <= 1 or n < 2:
        return None
    for d in ((0, 1) if transposed else (n - 1, n - 2)):
        if shape[d] % fsdp == 0 and shape[d] >= 2 * fsdp:
            return d
    return None


def model_param_specs(model: nn.Module, fsdp: int) -> Dict[str, Optional[int]]:
    """``fsdp_param_spec`` of every parameter of ``model``, by name."""
    return {name: fsdp_param_spec(tuple(p.shape), fsdp,
                                  name.rsplit(".", 1)[-1] not in SAME_LAYOUT)
            for name, p in model.named_parameters()}


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s parameters over ``mesh`` (``make_mesh``) in place,
    as one FSDP2 unit, each along the dim ``fsdp_param_spec`` names.

    Where the JAX rule replicates a parameter (below two dims, or no dim a
    multiple of fsdp and 2 fsdp long), FSDP2 has no replicated placement:
    it shards dim 0, padding the last shards (uneven, some empty). Each
    rank then holds a slice of it, not the whole. The values and the
    step's result are the same; only the memory each rank holds differs.

    ``loss`` becomes a forward method of the unit: each call gathers the
    parameters, and the backward reduce-scatters their gradients."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    specs = model_param_specs(model, mesh["fsdp"].size())
    by_id = {id(p): specs[name] for name, p in model.named_parameters()}

    def placement(p):
        d = by_id[id(p)]
        return None if d is None else Shard(d)

    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    register_fsdp_forward_method(model, "loss")
    return model


def is_sharded(model: nn.Module) -> bool:
    """True for a model that ``shard_model`` sharded."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Inside, a sharded model's parameters are whole (unsharded); an
    unsharded model is left as it is. Nested uses gather once, at the
    outermost (every rank enters the outermost alike: it is a collective)."""
    depth = getattr(model, "_gathered_depth", 0)
    if not is_sharded(model):
        yield model
        return
    if depth == 0:
        model.unshard()
    model._gathered_depth = depth + 1
    try:
        yield model
    finally:
        model._gathered_depth = depth
        if depth == 0:
            model.reshard()


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``t`` (without the padding), or ``t`` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t``, gathered from the ranks that hold its shards (a
    collective: every rank calls it), or ``t`` itself."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def full_like(part: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``part`` is this rank's shard, sharded as
    the parameter ``like`` (a collective when ``like`` is a DTensor); else
    a copy of ``part``."""
    if not isinstance(like, DTensor):
        return part.clone()
    return DTensor.from_local(part, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride()).full_tensor()


def shard_of(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of ``whole`` that this rank holds of a parameter laid out as
    ``like`` (a DTensor: torch.chunk along each sharded dim, as FSDP2 and
    DTensor split; an empty slice past the last chunk), or ``whole``."""
    if not isinstance(like, DTensor):
        return whole
    out = whole
    mesh = like.device_mesh
    for mesh_dim, pl in enumerate(like.placements):
        if pl.is_shard():
            n, c = mesh.size(mesh_dim), mesh.get_local_rank(mesh_dim)
            chunks = torch.chunk(out, n, dim=pl.dim)
            out = chunks[c] if c < len(chunks) else out.narrow(pl.dim, 0, 0)
    return out


def norm_group(params: Iterable[torch.Tensor]):
    """The process group over which the parameters' shards add up to the
    whole: the "fsdp" dim of their mesh (each "dp" replica holds the same
    shards), or None for parameters that are not sharded."""
    for p in params:
        if isinstance(p, DTensor):
            return p.device_mesh.get_group(MESH_DIMS[1])
    return None


def full_state_dict(model: nn.Module, cpu: bool = False) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded entry gathered whole (a
    collective on a sharded model), on the CPU with ``cpu``."""
    out = {}
    for k, v in model.state_dict().items():
        v = full(v).detach()
        out[k] = v.cpu() if cpu else v
    return out


@torch.no_grad()
def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a whole (unsharded) state dict into ``model`` strictly: a
    sharded model takes each rank's part of every entry."""
    if not is_sharded(model):
        model.load_state_dict(state, strict=True)
        return
    own = model.state_dict()
    if set(own) != set(state):
        missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
        raise RuntimeError(f"state dict mismatch: missing {missing[:5]}, unexpected {extra[:5]}")
    for k, v in own.items():
        local(v).copy_(shard_of(state[k].to(local(v).device), v))
