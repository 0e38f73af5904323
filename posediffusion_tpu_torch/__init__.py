"""posediffusion_tpu_torch: the PyTorch + CUDA port of posediffusion_tpu for
NVIDIA Hopper cards.

The layout mirrors the JAX package, so each module's counterpart has the
same path:
    geometry/   quaternions, cameras, pose codec, 7-DoF alignment, ARE
    ops/        embeddings, image ops, the CUDA kernels (csrc/) and the two
                fused trunks built from them (ViT, sampler)
    models/     nn.Modules with the released checkpoint's keys
    diffusion/  DDPM schedule and the plain ancestral sampler
    utils/      JAX-params and .pth conversion, config mapping

It imports torch and never jax; the numpy-only data loader and YAML config
of posediffusion_tpu are reused as they are.
"""
