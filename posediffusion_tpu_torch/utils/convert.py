"""Weights between the JAX package, the port and the released checkpoint.

``state_dict_from_jax`` is the inverse of
``posediffusion_tpu.utils.convert.convert_pose_diffusion_checkpoint``: it
maps the JAX params pytree (leaves as numpy arrays) onto the reference
checkpoint's keys. Dense kernels (in, out) are transposed to torch Linear
weights (out, in); the patch-embed Conv kernel goes from HWIO to OIHW;
LayerNorm scale/bias become weight/bias.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from posediffusion_tpu.utils.manifest import OPTIONAL_CONSTANT_KEYS

VIT_PREFIX = "image_feature_extractor._net."
DENOISER_PREFIX = "diffuser.model."


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _dense(p, prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])
    return out


def _norm(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def vit_state_dict_from_jax(net, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``VisionTransformer`` params -> DINO ViT keys."""
    sd = {
        f"{prefix}cls_token": _t(net["cls_token"]),
        f"{prefix}pos_embed": _t(net["pos_embed"]),
        f"{prefix}patch_embed.proj.weight": _t(
            np.asarray(net["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
        ),
        f"{prefix}patch_embed.proj.bias": _t(net["patch_embed"]["bias"]),
    }
    sd.update(_norm(net["norm"], f"{prefix}norm"))
    i = 0
    while f"blocks_{i}" in net:
        bp, b = net[f"blocks_{i}"], f"{prefix}blocks.{i}"
        sd.update(_norm(bp["norm1"], f"{b}.norm1"))
        sd.update(_dense(bp["attn"]["qkv"], f"{b}.attn.qkv"))
        sd.update(_dense(bp["attn"]["proj"], f"{b}.attn.proj"))
        sd.update(_norm(bp["norm2"], f"{b}.norm2"))
        sd.update(_dense(bp["mlp"]["fc1"], f"{b}.mlp.fc1"))
        sd.update(_dense(bp["mlp"]["fc2"], f"{b}.mlp.fc2"))
        i += 1
    return sd


def denoiser_state_dict_from_jax(p, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flax ``Denoiser`` params -> reference denoiser keys."""
    sd = {}
    sd.update(_dense(p["time_embed"]["linear_0"], f"{prefix}time_embed.linear.0"))
    sd.update(_dense(p["time_embed"]["linear_2"], f"{prefix}time_embed.linear.2"))
    sd.update(_dense(p["first"], f"{prefix}_first"))
    i = 0
    while f"layers_{i}" in p["trunk"]:
        lp, l = p["trunk"][f"layers_{i}"], f"{prefix}_trunk.layers.{i}"
        inp = lp["self_attn"]["in_proj"]
        sd[f"{l}.self_attn.in_proj_weight"] = _t(np.asarray(inp["kernel"]).T)
        sd[f"{l}.self_attn.in_proj_bias"] = _t(inp["bias"])
        sd.update(_dense(lp["self_attn"]["out_proj"], f"{l}.self_attn.out_proj"))
        sd.update(_dense(lp["linear1"], f"{l}.linear1"))
        sd.update(_dense(lp["linear2"], f"{l}.linear2"))
        sd.update(_norm(lp["norm1"], f"{l}.norm1"))
        sd.update(_norm(lp["norm2"], f"{l}.norm2"))
        i += 1
    last = p["last"]
    sd.update(_dense(last["dense_0"], f"{prefix}_last.0"))
    sd.update(_norm(last["norm_0"], f"{prefix}_last.1"))
    sd.update(_dense(last["dense_1"], f"{prefix}_last.3"))
    return sd


def state_dict_from_jax(params_np, schedule=None) -> Dict[str, torch.Tensor]:
    """Full JAX model params ``{"extractor": {"params": {"net": ...}},
    "denoiser": {"params": ...}}`` -> the reference checkpoint's keys.

    The schedule buffers (``diffuser.<name>``) are not JAX parameters; pass
    the port's ``DiffusionSchedule`` to include them, as a strict load of
    the whole model needs."""
    sd = vit_state_dict_from_jax(params_np["extractor"]["params"]["net"], VIT_PREFIX)
    sd.update(denoiser_state_dict_from_jax(params_np["denoiser"]["params"],
                                           DENOISER_PREFIX))
    if schedule is not None:
        sd.update({f"diffuser.{n}": v.clone() for n, v in schedule.buffers().items()})
    return sd


SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
                    "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


def superpoint_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """Flax ``SuperPointNet`` params (``{"params": ...}``, as
    ``posediffusion_tpu.matching.convert_superpoint`` gives them) -> the
    MagicLeap ``superpoint_v1.pth`` keys. Conv kernels go from HWIO to OIHW."""
    p = params["params"]
    sd = {}
    for name in SUPERPOINT_CONVS:
        sd[f"{name}.weight"] = _t(np.asarray(p[name]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    return sd


def _conv1d(p, prefix: str, out_index=None, in_index=None) -> Dict[str, torch.Tensor]:
    """A Dense (in, out) kernel -> a kernel-1 Conv1d (out, in, 1), with the
    output and input channels optionally re-indexed."""
    w = np.asarray(p["kernel"]).T
    b = np.asarray(p["bias"])
    if out_index is not None:
        w, b = w[out_index], b[out_index]
    if in_index is not None:
        w = w[:, in_index]
    return {f"{prefix}.weight": _t(w[:, :, None]), f"{prefix}.bias": _t(b)}


def _batchnorm(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["bn_scale"]), f"{prefix}.bias": _t(p["bn_bias"]),
            f"{prefix}.running_mean": _t(p["bn_mean"]),
            f"{prefix}.running_var": _t(p["bn_var"])}


def _point_mlp(p, prefix: str, conv_indices) -> Dict[str, torch.Tensor]:
    """Flax ``PointMLP`` -> MagicLeap ``MLP`` keys (Conv1d at each index, its
    BatchNorm at the next, none after the last)."""
    sd = {}
    for li, idx in enumerate(conv_indices):
        lp = p[f"layers_{li}"]
        if li == len(conv_indices) - 1:
            sd.update(_conv1d(lp, f"{prefix}.{idx}"))
        else:
            sd.update(_conv1d(lp["conv"], f"{prefix}.{idx}"))
            sd.update(_batchnorm(lp, f"{prefix}.{idx + 1}"))
    return sd


def superglue_state_dict_from_jax(params, d_model: int = 256,
                                  num_heads: int = 4) -> Dict[str, torch.Tensor]:
    """Converted SuperGlue params (``{"net": {"params": ...}, "bin_score"}``,
    as ``posediffusion_tpu.matching.convert_superglue`` gives them) -> the
    MagicLeap ``superglue_*.pth`` keys. The JAX params hold the q/k/v output
    channels and the merge input channels permuted to contiguous heads
    (``convert._head_perm``); this undoes that permutation."""
    from posediffusion_tpu_torch.ops.superglue_kernel import head_perm

    inv = np.argsort(head_perm(d_model, num_heads).numpy())
    net = params["net"]["params"]
    sd = _point_mlp(net["kenc"], "kenc.encoder", (0, 3, 6, 9, 12))
    i = 0
    while f"gnn_{i}" in net:
        attn, l = net[f"gnn_{i}"]["attn"], f"gnn.layers.{i}"
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            sd.update(_conv1d(attn[name], f"{l}.attn.proj.{j}", out_index=inv))
        sd.update(_conv1d(attn["merge"], f"{l}.attn.merge", in_index=inv))
        sd.update(_point_mlp(net[f"gnn_{i}"]["mlp"], f"{l}.mlp", (0, 3)))
        i += 1
    sd.update(_conv1d(net["final_proj"], "final_proj"))
    sd["bin_score"] = torch.tensor(float(np.asarray(params["bin_score"])), dtype=torch.float32)
    return sd


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A released ``.pth`` as a state dict for a strict ``load_state_dict``:
    a ``state_dict`` wrapper and ``module.`` prefixes are removed, and so
    are the recomputed constants that only some checkpoints carry."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    out = {}
    for k, v in state.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k not in OPTIONAL_CONSTANT_KEYS:
            out[k] = v
    return out
