"""Expected state-dict manifest of the reference's released checkpoints.

The reference loads its released weights with strict ``load_state_dict``
(reference: pose_diffusion/demo.py:56-57), so the checkpoint keys are exactly
the model's state-dict keys.  This module enumerates those keys + shapes from
the reference module definitions:

* extractor: DINO ViT-S/16 (or, with ``backbone``, a torchvision ResNet-50
  or ResNet-101, ``resnet_manifest``) under ``image_feature_extractor._net.``
  (image_feature_extractor.py:42; torch.hub DINO layout — cls_token,
  pos_embed, patch_embed.proj, blocks.N.{norm1, attn.qkv, attn.proj, norm2,
  mlp.fc1, mlp.fc2}, norm).  The ImageNet mean/std buffers are registered
  with persistent=False (image_feature_extractor.py:47-48) and therefore do
  NOT appear.
* denoiser under ``diffuser.model.`` (pose_diffusion_model.py:61 wires the
  denoiser in as diffuser.model): time_embed.linear.{0,2}
  (embedding.py:20, dim 256 -> 128 -> 128), _first Linear(702, 512)
  (denoiser.py:39-42), _trunk = torch.nn.TransformerEncoder(8 layers,
  d_model 512, nhead 4, FF 1024) (denoiser.py:79-98), _last = MLP
  Linear(512,128) / LayerNorm(128) / ReLU / Linear(128,9)
  (denoiser.py:51,101-163 — indices 0, 1, 3).
* diffusion schedule buffers under ``diffuser.`` — 13 float32 (100,)
  registered buffers (gaussian_diffuser.py:156-187), recomputed here rather
  than loaded, but present in the checkpoint.

Both released variants (Co3D @224px, Re10K @336px — reference README.md:30)
share this manifest: DINO interpolates pos_embed at forward time, so the
stored parameter stays at the 224px grid (1, 197, 384).

``tests/test_utils.py`` asserts the converter consumes exactly this manifest
(nothing silently dropped) and that the converted pytree matches the Flax
model's init tree leaf-for-leaf.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Keys that may legitimately go unconsumed by the converter: recomputed
# constants (non-persistent in some pytorch3d versions, so they may or may
# not appear in a given checkpoint).
OPTIONAL_CONSTANT_KEYS = (
    "diffuser.model.pose_embed._emb_pose._frequencies",
    "diffuser.model.pose_embed._emb_pose._zero_half_pi",
)

SCHEDULE_BUFFER_NAMES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "p2_loss_weight",
)


def _linear(out_dim: int, in_dim: int, prefix: str) -> Dict[str, Tuple[int, ...]]:
    return {f"{prefix}.weight": (out_dim, in_dim), f"{prefix}.bias": (out_dim,)}


def _norm(dim: int, prefix: str) -> Dict[str, Tuple[int, ...]]:
    return {f"{prefix}.weight": (dim,), f"{prefix}.bias": (dim,)}


def vit_manifest(
    prefix: str = "image_feature_extractor._net.",
    embed_dim: int = 384,
    depth: int = 12,
    patch: int = 16,
    pos_tokens: int = 197,
) -> Dict[str, Tuple[int, ...]]:
    p = prefix
    m: Dict[str, Tuple[int, ...]] = {
        f"{p}cls_token": (1, 1, embed_dim),
        f"{p}pos_embed": (1, pos_tokens, embed_dim),
        f"{p}patch_embed.proj.weight": (embed_dim, 3, patch, patch),
        f"{p}patch_embed.proj.bias": (embed_dim,),
    }
    for i in range(depth):
        b = f"{p}blocks.{i}"
        m.update(_norm(embed_dim, f"{b}.norm1"))
        m.update(_linear(3 * embed_dim, embed_dim, f"{b}.attn.qkv"))
        m.update(_linear(embed_dim, embed_dim, f"{b}.attn.proj"))
        m.update(_norm(embed_dim, f"{b}.norm2"))
        m.update(_linear(4 * embed_dim, embed_dim, f"{b}.mlp.fc1"))
        m.update(_linear(embed_dim, 4 * embed_dim, f"{b}.mlp.fc2"))
    m.update(_norm(embed_dim, f"{p}norm"))
    return m


def _bn(dim: int, prefix: str) -> Dict[str, Tuple[int, ...]]:
    return {f"{prefix}.{n}": (dim,) for n in ("weight", "bias", "running_mean", "running_var")}


RESNET_LAYERS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def resnet_manifest(
    prefix: str = "image_feature_extractor._net.",
    layers: Tuple[int, ...] = RESNET_LAYERS["resnet50"],
) -> Dict[str, Tuple[int, ...]]:
    """torchvision's Bottleneck ResNet keys without ``fc`` (the reference
    replaces it with Identity) and without the BatchNorms'
    ``num_batches_tracked`` counters (a load accepts and drops them)."""
    p = prefix
    m: Dict[str, Tuple[int, ...]] = {f"{p}conv1.weight": (64, 3, 7, 7)}
    m.update(_bn(64, f"{p}bn1"))
    inplanes, planes = 64, 64
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            k = f"{p}layer{stage + 1}.{b}"
            m[f"{k}.conv1.weight"] = (planes, inplanes, 1, 1)
            m.update(_bn(planes, f"{k}.bn1"))
            m[f"{k}.conv2.weight"] = (planes, planes, 3, 3)
            m.update(_bn(planes, f"{k}.bn2"))
            m[f"{k}.conv3.weight"] = (4 * planes, planes, 1, 1)
            m.update(_bn(4 * planes, f"{k}.bn3"))
            if b == 0:
                m[f"{k}.downsample.0.weight"] = (4 * planes, inplanes, 1, 1)
                m.update(_bn(4 * planes, f"{k}.downsample.1"))
            inplanes = 4 * planes
        planes *= 2
    return m


def denoiser_manifest(
    prefix: str = "diffuser.model.",
    d_model: int = 512,
    nhead: int = 4,
    num_layers: int = 8,
    dim_feedforward: int = 1024,
    time_dim: int = 256,
    input_dim: int = 702,  # pose harmonic 189 + time 128 + z 384 + pivot 1
    mlp_hidden: int = 128,
    target_dim: int = 9,
) -> Dict[str, Tuple[int, ...]]:
    del nhead  # heads don't change parameter shapes
    p = prefix
    m: Dict[str, Tuple[int, ...]] = {}
    m.update(_linear(time_dim // 2, time_dim, f"{p}time_embed.linear.0"))
    m.update(_linear(time_dim // 2, time_dim // 2, f"{p}time_embed.linear.2"))
    m.update(_linear(d_model, input_dim, f"{p}_first"))
    for i in range(num_layers):
        l = f"{p}_trunk.layers.{i}"
        m[f"{l}.self_attn.in_proj_weight"] = (3 * d_model, d_model)
        m[f"{l}.self_attn.in_proj_bias"] = (3 * d_model,)
        m.update(_linear(d_model, d_model, f"{l}.self_attn.out_proj"))
        m.update(_linear(dim_feedforward, d_model, f"{l}.linear1"))
        m.update(_linear(d_model, dim_feedforward, f"{l}.linear2"))
        m.update(_norm(d_model, f"{l}.norm1"))
        m.update(_norm(d_model, f"{l}.norm2"))
    m.update(_linear(mlp_hidden, d_model, f"{p}_last.0"))
    m.update(_norm(mlp_hidden, f"{p}_last.1"))
    m.update(_linear(target_dim, mlp_hidden, f"{p}_last.3"))
    return m


def schedule_manifest(timesteps: int = 100) -> Dict[str, Tuple[int, ...]]:
    return {f"diffuser.{n}": (timesteps,) for n in SCHEDULE_BUFFER_NAMES}


def reference_checkpoint_manifest(variant: str = "co3d",
                                  backbone: str = "dino_vits16") -> Dict[str, Tuple[int, ...]]:
    """Complete {key: shape} manifest of a released reference checkpoint.

    variant: "co3d" (224px) or "re10k" (336px) — identical manifests, both
    accepted so call sites document which checkpoint they mean.
    backbone: "dino_vits16" (the released checkpoints' extractor), or
    "resnet50" / "resnet101" (the reference's ``modelname`` option): a
    ResNet's keys, and the denoiser's first projection reading its 2,048-wide
    features (input 189 + 128 + 2,048 + 1 = 2,366).
    """
    if variant not in ("co3d", "re10k"):
        raise ValueError(f"unknown variant {variant!r}")
    m: Dict[str, Tuple[int, ...]] = {}
    if backbone == "dino_vits16":
        m.update(vit_manifest())
        m.update(denoiser_manifest())
    elif backbone in RESNET_LAYERS:
        m.update(resnet_manifest(layers=RESNET_LAYERS[backbone]))
        m.update(denoiser_manifest(input_dim=189 + 128 + 2048 + 1))
    else:
        raise ValueError(f"unknown backbone {backbone!r}")
    m.update(schedule_manifest())
    return m
