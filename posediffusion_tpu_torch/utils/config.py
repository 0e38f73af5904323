"""YAML configs with dotted overrides, and the mapping of the reference's
config trees onto the port's ``PoseDiffusionConfig`` and ``GGSConfig``.

The loader keeps the JAX package's UX (``posediffusion_tpu.utils.config``;
the port has its own copy and imports nothing of that package):

    python demo_torch.py image_folder=samples/apple GGS.enable=False seed=3

Configs are nested dicts exposed as attribute-accessible ``Config`` nodes;
unknown keys may be injected by an override.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import yaml

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "cfgs")


class Config(dict):
    """Nested dict with attribute access; missing keys raise AttributeError."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = _wrap(v)

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = _wrap(value)

    def to_dict(self) -> Dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _wrap(v):
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config({k: _wrap(x) for k, x in v.items()})
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _parse_value(s: str):
    """An override's right-hand side with YAML scalar semantics."""
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def load_config(name_or_path: str, overrides: Optional[List[str]] = None) -> Config:
    """cfgs/<name>.yaml (or an explicit path) with ``key.sub=value`` overrides."""
    path = name_or_path
    if not os.path.isfile(path):
        path = os.path.join(CFG_DIR, f"{name_or_path}.yaml")
    with open(path) as f:
        cfg = _wrap(yaml.safe_load(f) or {})
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not key=value")
        key, value = ov.split("=", 1)
        cfg.set_path(key.strip(), _parse_value(value))
    return cfg


def cli_config(default_name: str, argv: Optional[List[str]] = None) -> Config:
    """An entry point's config: the first argument may name a config, the
    rest are dotted overrides."""
    args = list(sys.argv[1:] if argv is None else argv)
    name = default_name
    if args and "=" not in args[0]:
        name = args.pop(0)
    return load_config(name, args)


def model_config_from_cfg(model_cfg: Config):
    """Map cfgs/default.yaml's MODEL tree (and the extensions the JAX
    package reads: extractor ``depth``, ``scale_factors``, ``freeze`` and
    ``compute_dtype``, transformer ``dropout`` and ``compute_dtype``,
    diffuser ``timesteps``, ``objective`` and ``loss_type``) onto the port's
    config. An unknown objective or loss type raises the JAX package's
    ``ValueError``."""
    from posediffusion_tpu_torch.diffusion.gaussian import check_loss_type, check_objective
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionConfig

    tr = model_cfg.get_path("DENOISER.TRANSFORMER", Config())
    diff = model_cfg.get("DIFFUSER", Config())
    extractor = model_cfg.get("IMAGE_FEATURE_EXTRACTOR", Config())
    modelname = extractor.get("modelname", "dino_vits16")
    # the backbone's width, depth and heads (posediffusion_tpu/utils/config.py
    # :131-132; ViT-g/14's from DINOv2's vit_giant2)
    z_dim, depth, heads = {"dino_vitb16": (768, 12, 12),
                           "dinov2_vitg14": (1536, 40, 24)}.get(modelname, (384, 12, 6))
    config = PoseDiffusionConfig(
        pose_encoding_type=model_cfg.get("pose_encoding_type", "absT_quaR_logFL"),
        modelname=modelname,
        z_dim=z_dim,
        vit_heads=heads,
        freeze_extractor=bool(extractor.get("freeze", False)),
        vit_depth=int(extractor.get("depth", depth)),
        scale_factors=tuple(extractor.get("scale_factors", (1.0, 1.0 / 2, 1.0 / 3))),
        compute_dtype=str(extractor.get("compute_dtype", "float32")),
        d_model=int(tr.get("d_model", 512)),
        nhead=int(tr.get("nhead", 4)),
        num_encoder_layers=int(tr.get("num_encoder_layers", 8)),
        dim_feedforward=int(tr.get("dim_feedforward", 1024)),
        dropout=float(tr.get("dropout", 0.1)),
        denoiser_dtype=str(tr.get("compute_dtype", "float32")),
        timesteps=int(diff.get("timesteps", 100)),
        beta_1=float(diff.get("beta_1", 1e-4)),
        beta_T=float(diff.get("beta_T", 0.1)),
        beta_schedule=diff.get("beta_schedule", "custom"),
        objective=check_objective(str(diff.get("objective", "pred_noise"))),
        loss_type=check_loss_type(str(diff.get("loss_type", "l1"))),
    )
    return config


def build_ggs_config(ggs_cfg: Config):
    """cfgs/default.yaml's GGS tree -> ``GGSConfig`` (the reference's keys
    and defaults, as ``posediffusion_tpu.utils.config.build_ggs_config``)."""
    from posediffusion_tpu_torch.diffusion.ggs import GGSConfig

    return GGSConfig(
        enable=bool(ggs_cfg.get("enable", True)),
        start_step=int(ggs_cfg.get("start_step", 10)),
        learning_rate=float(ggs_cfg.get("learning_rate", 0.01)),
        iter_num=int(ggs_cfg.get("iter_num", 100)),
        sampson_max=float(ggs_cfg.get("sampson_max", 10)),
        min_matches=int(ggs_cfg.get("min_matches", 10)),
        alpha=float(ggs_cfg.get("alpha", 0.0001)),
        pose_encoding_type=str(ggs_cfg.get("pose_encoding_type", "absT_quaR_logFL")),
    )


def device_from_cfg(cfg: Config) -> str:
    """The ``device`` override of an entry point: the card unless the caller
    asks for ``device=cpu``. There is no silent fallback: without a card the
    default raises when the first tensor moves."""
    return str(cfg.get("device", "cuda"))
