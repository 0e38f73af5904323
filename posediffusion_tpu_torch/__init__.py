"""posediffusion_tpu_torch: the PyTorch + CUDA port of posediffusion_tpu for
NVIDIA Hopper cards.

The layout mirrors the JAX package, so each module's counterpart has the
same path:
    geometry/   quaternions, cameras, pose codec, epipolar geometry,
                7-DoF alignment, ARE
    ops/        embeddings, image ops, the CUDA kernels (csrc/), the trunks
                built from them (ViT, sampler, denoiser) and the GGS phases
                with their closed-form Sampson gradient
    models/     nn.Modules with the released checkpoint's keys
    diffusion/  DDPM schedule, the plain ancestral sampler with its
                conditioned tail, geometry-guided sampling (GGS)
    utils/      JAX-params and .pth conversion, config mapping

It imports torch and never jax; the numpy-only data loader and YAML config
of posediffusion_tpu are reused as they are.
"""
