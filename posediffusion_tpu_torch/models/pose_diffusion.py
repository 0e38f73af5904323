"""PoseDiffusion composition root for inference with and without GGS, as
``posediffusion_tpu.models.pose_diffusion``.

The module tree carries the released checkpoint's keys:
``image_feature_extractor._net.*`` (the ViT; DINOv2's adds
``blocks.N.ls{1,2}.gamma``; a ResNet's are torchvision's),
``diffuser.model.*`` (denoiser) and the 13 schedule buffers
``diffuser.<name>``, so a reference ``.pth`` loads with a strict
``load_state_dict``. Backbones: ``dino_vits16`` (the default),
``dino_vitb16``, ``dinov2_vits14``, ``dinov2_vitg14`` (DINOv2's SwiGLU
ViT-g/14, float32 only; its z is 1,536 wide, ``blocks.N.mlp.w12`` /
``w3``), ``resnet50`` and ``resnet101`` (whose 2,048-wide features the
denoiser takes as z).

``sample`` runs ``extract_features_fused`` (DINO: ViT trunk on the kernels;
DINOv2, and DINO at ``compute_dtype=bfloat16``: ``extract_features_blocks``,
its attention on the kernels; a ResNet: ``extract_features_resnet``, cuDNN
on a card), then, for one sequence,
``fused_sample_loop`` for the unconditioned steps [n_cond, T) (all of them
without GGS), then, with a ``cond_fn``, the conditioned tail t < n_cond in
``p_sample_loop`` with ``denoiser_apply_fused`` (trunk on the kernels) and
the GGS ``cond_fn`` (its phases on the GGS kernels); a batch runs
``p_sample_loop`` over ``denoiser_train_apply`` (the JAX package's batched
route). DDIM (``sampling_timesteps``) and the trajectory route call the
denoiser once a step, as the tail does. Which code runs each kernel is
decided by the images' device alone.

``loss`` is the training loss (``posediffusion_tpu``'s ``loss``, :260-385):
``extract_features_train`` (TPU kernel 9/10's ViT flavour, with LayerScale
for DINOv2; a ResNet through ``extract_features_resnet`` and autograd, as
the JAX package differentiates its Flax module), ``batch_repeat``
tiling of the features and poses, then ``p_losses`` over
``denoiser_train_apply`` (the encoder flavour, with dropout) at the
config's objective and loss type, masked by the frame mask. Its draws (t,
the noise, the dropout seed) are arguments, or come from a
``torch.Generator``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from posediffusion_tpu_torch.diffusion.schedule import (
    SCHEDULE_BUFFER_NAMES,
    DiffusionSchedule,
    make_schedule,
)
from posediffusion_tpu_torch.diffusion.gaussian import (
    DiffusionLoss,
    ddim_sample_loop,
    p_losses,
    p_sample_loop,
)
from posediffusion_tpu_torch.models.denoiser import (
    Denoiser,
    denoiser_apply_fused,
    denoiser_train_apply,
)
from posediffusion_tpu_torch.models.feature_extractor import (
    MultiScaleImageFeatureExtractor,
    extract_features_blocks,
    extract_features_fused,
    extract_features_resnet,
    extract_features_train,
)
from posediffusion_tpu_torch.models.resnet import BatchNormInference, ResNet
from posediffusion_tpu_torch.models.vit import LayerScale
from posediffusion_tpu_torch.ops.denoiser_kernel import stack_trunk_params
from posediffusion_tpu_torch.ops.sampler_kernel import fused_sample_loop


# the JAX package's backbones (posediffusion_tpu/utils/config.py:128), and
# DINOv2's ViT-g/14, which upstream PoseDiffusion loads by name as it does
# every dinov2_* model (models/image_feature_extractor.py:38-40)
KNOWN_BACKBONES = ("dino_vits16", "dino_vitb16", "dinov2_vits14", "dinov2_vitg14",
                   "resnet50", "resnet101")
# (z_dim, vit_depth, vit_heads) that a backbone's name fixes: a config that
# disagrees is refused, not built at another size under the name
BACKBONE_SHAPES = {"dinov2_vitg14": (1536, 40, 24)}


@dataclasses.dataclass(frozen=True)
class PoseDiffusionConfig:
    pose_encoding_type: str = "absT_quaR_logFL"
    target_dim: int = 9
    modelname: str = "dino_vits16"
    freeze_extractor: bool = False  # reference IMAGE_FEATURE_EXTRACTOR.freeze
    z_dim: int = 384
    # denoiser (reference: cfgs/default.yaml:26-34)
    d_model: int = 512
    nhead: int = 4
    num_encoder_layers: int = 8
    dim_feedforward: int = 1024
    dropout: float = 0.1
    mlp_hidden_dim: int = 128
    pivot_cam_onehot: bool = True
    # backbone
    vit_depth: int = 12
    vit_heads: int = 6
    patch_size: int = 16  # DINO's; DINOv2 takes 14 (the extractor sets it)
    scale_factors: Tuple[float, ...] = (1.0, 1.0 / 2, 1.0 / 3)
    # precision of the kernel paths: the weight stacks of both trunks, and
    # bf16 rounding of the ViT's product operands (the JAX main path's
    # defaults); "float32" with False is the f32 mode of the tight tests
    weight_dtype: str = "bfloat16"
    extractor_act_bf16: bool = True
    # precision of the training trunks, as the JAX package's: "bfloat16"
    # rounds the product operands and the residual stream to bf16 (weights
    # and their gradients stay float32)
    compute_dtype: str = "float32"  # the ViT
    denoiser_dtype: str = "float32"  # the denoiser trunk
    # diffusion (reference: cfgs/default.yaml:37-40)
    timesteps: int = 100
    beta_1: float = 1e-4
    beta_T: float = 0.1
    beta_schedule: str = "custom"
    objective: str = "pred_noise"  # or "pred_x0"
    loss_type: str = "l1"  # or "l2"


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
        if config.modelname not in KNOWN_BACKBONES:
            raise ValueError(f"unsupported backbone {config.modelname} "
                             f"(known: {KNOWN_BACKBONES})")
        shape = BACKBONE_SHAPES.get(config.modelname)
        if shape is not None and shape != (config.z_dim, config.vit_depth, config.vit_heads):
            raise ValueError(f"{config.modelname} is z_dim, vit_depth, vit_heads = {shape}, "
                             f"not {(config.z_dim, config.vit_depth, config.vit_heads)}")
        self.config = config
        c = config
        self.image_feature_extractor = MultiScaleImageFeatureExtractor(
            scale_factors=c.scale_factors, modelname=c.modelname,
            patch_size=c.patch_size, embed_dim=c.z_dim, depth=c.vit_depth,
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
        """(B, N, 3, H, W) in [0, 1] -> (B, N, z_dim): DINO's trunk on the
        kernels; DINOv2's blocks in float32 with their attention on the
        kernels; at ``compute_dtype=bfloat16`` the blocks of DINO and
        DINOv2 at the Flax bf16 blocks' rounding sites, as the JAX package
        routes them (:409-414, :432; its extractor's ``dtype``, :170); a
        ResNet at float32 or at its bf16 convolutions' sites."""
        B, N = images.shape[:2]
        net = self.image_feature_extractor._net
        flat = images.reshape(B * N, *images.shape[2:])
        bf16 = self.config.compute_dtype == "bfloat16"
        if isinstance(net, ResNet):
            z = extract_features_resnet(net, flat, self.config.scale_factors, bf16=bf16)
        elif net.layer_scale or bf16:
            z = extract_features_blocks(net, flat, self.config.scale_factors, bf16=bf16)
        else:
            z = extract_features_fused(
                net, flat, scale_factors=self.config.scale_factors,
                act_bf16=self.config.extractor_act_bf16,
                weight_dtype=self.weight_dtype,
            )
        return z.reshape(B, N, -1)

    def loss(
        self,
        images: torch.Tensor,  # (B, N, 3, H, W) in [0, 1]
        pose_encodings: torch.Tensor,  # (B, N, 9) ground-truth encodings
        batch_repeat: int = 0,
        mask: Optional[torch.Tensor] = None,  # (B, N) frame validity
        train: bool = True,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        drop_seed: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> DiffusionLoss:
        """The diffusion training loss, unreduced over (B', N, 9), B' = B x
        max(batch_repeat, 1). ``t`` (B',), ``noise`` (B', N, 9) and
        ``drop_seed`` are the draws; any left out comes from ``generator``
        (a CPU generator, so the draws do not depend on the device)."""
        c = self.config
        B, N = images.shape[:2]
        flat = images.reshape(B * N, *images.shape[2:])
        bf16 = c.compute_dtype == "bfloat16"
        net = self.image_feature_extractor._net
        with torch.set_grad_enabled(torch.is_grad_enabled() and not c.freeze_extractor):
            if isinstance(net, ResNet):
                z = extract_features_resnet(net, flat, c.scale_factors, bf16=bf16)
            else:
                z = extract_features_train(net, flat, c.scale_factors, act_bf16=bf16,
                                           residual_bf16=bf16)
            z = z.reshape(B, N, -1)
        if batch_repeat > 0:
            pose_encodings = pose_encodings.repeat(batch_repeat, 1, 1)
            z = z.repeat(batch_repeat, 1, 1)
            if mask is not None:
                mask = mask.repeat(batch_repeat, 1)
        Bp, dev = pose_encodings.shape[0], pose_encodings.device
        if t is None:
            t = torch.randint(0, c.timesteps, (Bp,), generator=generator)
        if noise is None:
            noise = torch.randn(pose_encodings.shape, generator=generator)
        if drop_seed is None:
            drop_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
        den_bf16 = c.denoiser_dtype == "bfloat16"

        def model_fn(x, tt):
            return denoiser_train_apply(
                self.diffuser.model, x, tt, z, mask=mask, seed=drop_seed,
                dropout=c.dropout if train else 0.0, act_bf16=den_bf16,
                residual_bf16=den_bf16,
            )

        out = p_losses(self.schedule, model_fn, pose_encodings, t.to(dev),
                       noise.to(dev), objective=c.objective, loss_type=c.loss_type)
        if mask is not None:
            out = out._replace(loss=out.loss * mask[..., None].to(out.loss.dtype))
        return out

    @torch.no_grad()
    def sample(
        self,
        images: torch.Tensor,  # (B, N, 3, H, W) in [0, 1]
        generator: Optional[torch.Generator] = None,
        x0: Optional[torch.Tensor] = None,
        noises: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        cond_fn: Optional[Callable] = None,
        cond_start_step: int = 0,
        return_trajectory: bool = False,
        sampling_timesteps: Optional[int] = None,
        ddim_eta: float = 0.0,
    ):
        """The reverse process -> (B, N, 9) pose encodings, or with
        ``return_trajectory`` (encodings, trajectory).

        ``x0`` (B, N, 9) and ``noises`` (R, B, N, 9) inject the draws in
        step order (t = T-1 first); else they come from ``generator``. R is
        T for ancestral sampling and S for DDIM (``sampling_timesteps`` S
        below T; ``ddim_eta`` its eta). With ``cond_fn`` (GGS), the steps
        t < ``cond_start_step`` condition the mean with it and take no
        noise (their draws are unused); they run one sequence (B == 1).
        The trajectory is the (T + 1, B, N, 9) states of ancestral sampling,
        x0 first; DDIM returns None for it, as the JAX package does.

        The routes follow the JAX package's ``sample`` (:436-581), each with
        ``config.objective``. Ancestral sampling of one sequence runs the
        whole-loop sampler on ``weight_dtype`` stacks and its GGS tail
        ``denoiser_apply_fused``; with ``return_trajectory`` every step runs
        ``p_sample_loop`` over ``denoiser_apply_fused``. DDIM of one
        sequence runs ``ddim_sample_loop`` over ``denoiser_apply_fused``. A
        batch (B > 1) runs every step through ``denoiser_train_apply`` on
        float32 weights. At ``denoiser_dtype=bfloat16`` the batch, the GGS
        tail, the trajectory and DDIM take that route on bf16-rounded
        weights with bf16 activations and residual stream."""
        c = self.config
        z = self.extract_features(images)
        den = self.diffuser.model
        T = c.timesteps
        shape = (*z.shape[:2], den.target_dim)
        n_cond = min(max(cond_start_step, 0), T) if cond_fn is not None else 0
        if sampling_timesteps is not None and sampling_timesteps < T:
            x = ddim_sample_loop(
                self.schedule, self._step_fn(z, mask), shape, z.device, sampling_timesteps,
                ddim_eta, generator=generator, x0=x0, noises=noises, cond_fn=cond_fn,
                cond_start_step=cond_start_step, objective=c.objective)
            return (x, None) if return_trajectory else x
        if z.shape[0] > 1 or return_trajectory:
            return p_sample_loop(
                self.schedule, self._step_fn(z, mask), shape, z.device, generator=generator,
                x0=x0, noises=noises, cond_fn=cond_fn, cond_start_step=cond_start_step,
                objective=c.objective, return_trajectory=return_trajectory)
        x = fused_sample_loop(
            den, self.schedule, z, mask=mask, n_cond=n_cond,
            weight_dtype=self.weight_dtype, x0=x0,
            noises=None if noises is None else noises[:T - n_cond],
            generator=generator, objective=c.objective,
        )
        if n_cond == 0:
            return x
        return p_sample_loop(
            self.schedule, self._step_fn(z, mask), x.shape, x.device,
            noises=torch.zeros((n_cond, *x.shape), device=x.device),
            x_init=x, from_t=n_cond, cond_fn=cond_fn, cond_start_step=cond_start_step,
            objective=c.objective,
        )

    def _step_fn(self, z: torch.Tensor, mask: Optional[torch.Tensor]):
        """model_fn of the routes that call the denoiser once a step: one
        sequence over ``denoiser_apply_fused`` (its trunk ``fused_trunk``)
        on ``weight_dtype`` stacks built once; a batch, or any B at
        ``denoiser_dtype=bfloat16``, over ``denoiser_train_apply``."""
        bf16 = self.config.denoiser_dtype == "bfloat16"
        if z.shape[0] > 1 or bf16:
            return self._train_route_fn(z, mask, bf16)
        den = self.diffuser.model
        stacks = stack_trunk_params(den._trunk, self.weight_dtype)
        return lambda xt, t: denoiser_apply_fused(den, xt, t, z, mask, stacks)

    def _train_route_fn(self, z: torch.Tensor, mask: Optional[torch.Tensor],
                        bf16: bool):
        """model_fn over ``denoiser_train_apply`` with dropout off. ``bf16``:
        the weights rounded to bf16 (the JAX package casts them, and its
        float32 operands promote them back), the trunk's product operands
        and residual stream rounded to bf16."""
        den = self.diffuser.model
        if bf16:
            den = copy.deepcopy(den)
            for p in den.parameters():
                p.copy_(p.to(torch.bfloat16).to(p.dtype))
        return lambda xt, t: denoiser_train_apply(den, xt, t, z, mask, act_bf16=bf16,
                                                  residual_bf16=bf16)


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int, std: float = 0.02) -> None:
    """Fill every parameter with seeded draws: N(0, std), plus 1 for
    LayerNorm weights, LayerScale gains (gains near 0 would scale every
    branch and its gradient away) and a ResNet's BatchNorm weights and
    variances; a ResNet's convolution kernels N(0, 1 / fan_in), which keeps
    the stream's scale through its 16-33 blocks (its BatchNorms run on fixed
    statistics and do not renormalise: at N(0, std) each strided shortcut
    shrinks the stream and the BatchNorm biases dominate the features).
    Buffers (the schedule) keep their values. The draws come from one CPU
    generator, so the weights do not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    resnet_convs = {id(m) for r in model.modules() if isinstance(r, ResNet)
                    for m in r.modules() if isinstance(m, nn.Conv2d)}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            draw = torch.randn(p.shape, generator=gen)
            if id(module) in resnet_convs:
                draw *= p[0].numel() ** -0.5
            else:
                draw *= std
            if ((isinstance(module, nn.LayerNorm) and name == "weight")
                    or isinstance(module, LayerScale)
                    or (isinstance(module, BatchNormInference)
                        and name in ("weight", "running_var"))):
                draw += 1.0
            p.copy_(draw)


# jax.nn.initializers.variance_scaling's truncated-normal correction: the std
# of a unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978


def truncated_normal(shape, generator: torch.Generator, std: float) -> torch.Tensor:
    """``std`` x a unit normal truncated to [-2, 2], by the inverse CDF of a
    uniform draw (as ``jax.random.truncated_normal``), float32."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
    return (x.clamp(-2.0, 2.0) * std).to(torch.float32)


@torch.no_grad()
def init_flax_weights(model: nn.Module, seed: int) -> None:
    """Draw every parameter from the law of its Flax counterpart's
    initializer, as the JAX package's ``PoseDiffusionModel.init`` makes it:
    the backbone's Dense and Conv kernels ``lecun_normal`` (a normal
    truncated at 2 sigma, std sqrt(1 / fan_in), fan_in the input width, and
    the patch embedding's 16 x 16 x 3), ``cls_token`` and ``pos_embed``
    ``truncated_normal(0.02)``; the denoiser's Dense kernels (time
    embedding, ``first``, the encoder layers, the output head)
    ``truncated_normal(0.02)`` (``layers.default_kernel_init``); every bias
    zero; LayerNorm and BatchNorm scales, BatchNorm variances and LayerScale
    gains one, BatchNorm means zero. Buffers (the schedule) keep their
    values. The draws come from one CPU generator, so the weights do not
    depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    backbone = {id(p) for p in model.image_feature_extractor.parameters()}
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, (nn.LayerNorm, BatchNormInference, LayerScale)):
                one = name in ("weight", "running_var", "gamma")
                p.fill_(1.0 if one else 0.0)
            elif "bias" in name:
                p.zero_()
            elif id(p) in backbone and name not in ("cls_token", "pos_embed"):
                std = p[0].numel() ** -0.5 / TRUNCATED_STD
                p.copy_(truncated_normal(p.shape, gen, std))
            else:
                p.copy_(truncated_normal(p.shape, gen, 0.02))
