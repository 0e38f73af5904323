"""The reference's MODEL config tree -> ``PoseDiffusionConfig``, and its GGS
tree -> ``GGSConfig``.

The YAML loader and the dotted-override CLI are reused from
``posediffusion_tpu.utils.config`` (they import no JAX); only the mapping
onto the port's config lives here.
"""

from __future__ import annotations

from posediffusion_tpu.utils.config import Config
from posediffusion_tpu_torch.diffusion.ggs import GGSConfig
from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionConfig


def model_config_from_cfg(model_cfg: Config) -> PoseDiffusionConfig:
    """Map cfgs/default.yaml's MODEL tree (and the extensions the JAX
    package reads: extractor ``depth`` and ``scale_factors``, diffuser
    ``timesteps``) onto the port's config."""
    tr = model_cfg.get_path("DENOISER.TRANSFORMER", Config())
    diff = model_cfg.get("DIFFUSER", Config())
    extractor = model_cfg.get("IMAGE_FEATURE_EXTRACTOR", Config())
    config = PoseDiffusionConfig(
        pose_encoding_type=model_cfg.get("pose_encoding_type", "absT_quaR_logFL"),
        modelname=extractor.get("modelname", "dino_vits16"),
        vit_depth=int(extractor.get("depth", 12)),
        scale_factors=tuple(extractor.get("scale_factors", (1.0, 1.0 / 2, 1.0 / 3))),
        d_model=int(tr.get("d_model", 512)),
        nhead=int(tr.get("nhead", 4)),
        num_encoder_layers=int(tr.get("num_encoder_layers", 8)),
        dim_feedforward=int(tr.get("dim_feedforward", 1024)),
        timesteps=int(diff.get("timesteps", 100)),
        beta_1=float(diff.get("beta_1", 1e-4)),
        beta_T=float(diff.get("beta_T", 0.1)),
        beta_schedule=diff.get("beta_schedule", "custom"),
    )
    if diff.get("objective", "pred_noise") != "pred_noise":
        raise ValueError("only the pred_noise objective is ported")
    return config


def build_ggs_config(ggs_cfg: Config) -> GGSConfig:
    """cfgs/default.yaml's GGS tree -> ``GGSConfig`` (the reference's keys
    and defaults, as ``posediffusion_tpu.utils.config.build_ggs_config``)."""
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
