"""PoseDiffusion composition root for inference without GGS, as
``posediffusion_tpu.models.pose_diffusion``.

The module tree carries the released checkpoint's keys:
``image_feature_extractor._net.*`` (DINO ViT), ``diffuser.model.*``
(denoiser) and the 13 schedule buffers ``diffuser.<name>``, so a reference
``.pth`` loads with a strict ``load_state_dict``.

``sample`` is the no-GGS main path: ``extract_features_fused`` (ViT trunk on
the kernels) then ``fused_sample_loop`` (all reverse steps on the kernels).
Which code runs each kernel is decided by the images' device alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from posediffusion_tpu_torch.diffusion.schedule import (
    SCHEDULE_BUFFER_NAMES,
    DiffusionSchedule,
    make_schedule,
)
from posediffusion_tpu_torch.models.denoiser import Denoiser
from posediffusion_tpu_torch.models.feature_extractor import (
    MultiScaleImageFeatureExtractor,
    extract_features_fused,
)
from posediffusion_tpu_torch.ops.sampler_kernel import fused_sample_loop


@dataclasses.dataclass(frozen=True)
class PoseDiffusionConfig:
    pose_encoding_type: str = "absT_quaR_logFL"
    target_dim: int = 9
    modelname: str = "dino_vits16"
    z_dim: int = 384
    # denoiser (reference: cfgs/default.yaml:26-34)
    d_model: int = 512
    nhead: int = 4
    num_encoder_layers: int = 8
    dim_feedforward: int = 1024
    mlp_hidden_dim: int = 128
    pivot_cam_onehot: bool = True
    # backbone
    vit_depth: int = 12
    vit_heads: int = 6
    patch_size: int = 16
    scale_factors: Tuple[float, ...] = (1.0, 1.0 / 2, 1.0 / 3)
    # precision of the kernel paths: the weight stacks of both trunks, and
    # bf16 rounding of the ViT's product operands (the JAX main path's
    # defaults); "float32" with False is the f32 mode of the tight tests
    weight_dtype: str = "bfloat16"
    extractor_act_bf16: bool = True
    # diffusion (reference: cfgs/default.yaml:37-40)
    timesteps: int = 100
    beta_1: float = 1e-4
    beta_T: float = 0.1
    beta_schedule: str = "custom"


class GaussianDiffuser(nn.Module):
    """Holds the denoiser as ``model`` and the schedule as buffers."""

    def __init__(self, model: Denoiser, schedule: DiffusionSchedule):
        super().__init__()
        self.model = model
        for name, value in schedule.buffers().items():
            self.register_buffer(name, value.clone())

    @property
    def schedule(self) -> DiffusionSchedule:
        return DiffusionSchedule(**{n: getattr(self, n) for n in SCHEDULE_BUFFER_NAMES})


class PoseDiffusionModel(nn.Module):
    def __init__(self, config: PoseDiffusionConfig = PoseDiffusionConfig()):
        super().__init__()
        if config.pose_encoding_type != "absT_quaR_logFL":
            raise ValueError(f"unknown pose encoding {config.pose_encoding_type}")
        if config.modelname != "dino_vits16":
            raise ValueError(f"backbone {config.modelname} is not ported")
        self.config = config
        c = config
        self.image_feature_extractor = MultiScaleImageFeatureExtractor(
            scale_factors=c.scale_factors, patch_size=c.patch_size, embed_dim=c.z_dim, depth=c.vit_depth,
            num_heads=c.vit_heads,
        )
        denoiser = Denoiser(
            target_dim=c.target_dim, pivot_cam_onehot=c.pivot_cam_onehot,
            z_dim=self.image_feature_extractor.output_dim,
            mlp_hidden_dim=c.mlp_hidden_dim, d_model=c.d_model, nhead=c.nhead,
            num_encoder_layers=c.num_encoder_layers,
            dim_feedforward=c.dim_feedforward,
        )
        schedule = make_schedule(c.timesteps, c.beta_1, c.beta_T, c.beta_schedule)
        self.diffuser = GaussianDiffuser(denoiser, schedule)
        self.eval()

    @property
    def schedule(self) -> DiffusionSchedule:
        return self.diffuser.schedule

    @property
    def weight_dtype(self) -> torch.dtype:
        return getattr(torch, self.config.weight_dtype)

    @torch.no_grad()
    def extract_features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, N, 3, H, W) in [0, 1] -> (B, N, z_dim), trunk on the kernels."""
        B, N = images.shape[:2]
        z = extract_features_fused(
            self.image_feature_extractor._net,
            images.reshape(B * N, *images.shape[2:]),
            scale_factors=self.config.scale_factors,
            act_bf16=self.config.extractor_act_bf16,
            weight_dtype=self.weight_dtype,
        )
        return z.reshape(B, N, -1)

    @torch.no_grad()
    def sample(
        self,
        images: torch.Tensor,  # (B, N, 3, H, W) in [0, 1]
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        noises: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """All reverse steps without GGS -> (B, N, 9) pose encodings.

        ``x0`` (B, N, 9) and ``noises`` (T, B, N, 9) inject the draws in
        step order (t = T-1 first); else they come from ``generator``."""
        z = self.extract_features(images)
        return fused_sample_loop(
            self.diffuser.model, self.schedule, z, mask=mask,
            weight_dtype=self.weight_dtype, x0=x0, noises=noises,
            generator=generator,
        )


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int, std: float = 0.02) -> None:
    """Fill every parameter with seeded draws: N(0, std), plus 1 for
    LayerNorm weights. Buffers (the schedule) keep their values. The draws
    come from one CPU generator, so the weights do not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            draw = torch.randn(p.shape, generator=gen) * std
            if isinstance(module, nn.LayerNorm) and name == "weight":
                draw += 1.0
            p.copy_(draw)
