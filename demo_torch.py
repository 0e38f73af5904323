"""Single-folder pose inference with the PyTorch port, without GGS.

Same CLI as demo.py (a config name, then dotted overrides):

    python demo_torch.py image_folder=samples/apple GGS.enable=False ckpt=random

Pipeline: load + preprocess the images -> 100-step diffusion sampling (ViT
trunk and sampler on the CUDA kernels when ``device`` is a card) -> decode
to cameras -> 7-DoF alignment to gt_cameras.npz, if present -> absolute
rotation error -> ``<out_dir>/predictions.npz``.

``ckpt`` is a reference ``.pth`` (strict load); anything else that is not an
existing ``.pth`` gives random weights seeded by ``seed``. It runs on the
card when one is present, else on the CPU (the kernels' plain versions).
GGS, the frustum plot and the HTML export are not ported yet.
"""

import os
import time

import numpy as np


def run(cfg, device: str) -> dict:
    """The demo's flow for a loaded config; returns what it saves."""
    import torch

    from posediffusion_tpu.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.geometry.align import align_cameras
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
    from posediffusion_tpu_torch.geometry.metrics import compute_are
    from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.utils.config import model_config_from_cfg
    from posediffusion_tpu_torch.utils.convert import load_reference_state_dict
    from posediffusion_tpu_torch.utils.precision import pin_full_float32

    if cfg.GGS.enable:
        raise NotImplementedError(
            "GGS is not ported to the PyTorch package yet; run with "
            "GGS.enable=False (demo.py runs GGS with the JAX package)"
        )
    pin_full_float32()
    model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    ckpt = str(cfg.get("ckpt", "random"))
    if ckpt.endswith(".pth") and os.path.isfile(ckpt):
        model.load_state_dict(load_reference_state_dict(ckpt), strict=True)
        print(f"Loaded reference checkpoint from: {ckpt}")
    else:
        init_random_weights(model, int(cfg.seed))
        print(f"WARNING: no checkpoint at {ckpt!r}: random weights (seed {cfg.seed})")
    model.to(device)

    folder = cfg.image_folder
    images, _ = load_and_preprocess_images(folder, cfg.image_size)
    images = torch.as_tensor(images, device=device)[None]  # 1 x N x 3 x H x W
    print("=====> Sampling without GGS <=====")

    def infer():
        gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
        start = time.perf_counter()
        enc = model.sample(images, generator=gen)
        if images.is_cuda:
            torch.cuda.synchronize()
        return enc, time.perf_counter() - start

    enc, first = infer()
    print(f"Time taken: {first:.4f} seconds (first call, incl. any kernel build)")
    enc, steady = infer()
    print(f"Time taken: {steady:.4f} seconds (second call)")

    pred = pose_encoding_to_camera(enc)
    out = {
        "pose_encoding": enc.cpu().numpy(),
        "R": pred.R.cpu().numpy(),
        "T": pred.T.cpu().numpy(),
        "focal_length": pred.focal_length.cpu().numpy(),
    }
    gt_path = os.path.join(folder, "gt_cameras.npz")
    if os.path.exists(gt_path):
        gt = np.load(gt_path)
        gt_cameras = PerspectiveCameras.create(
            R=gt["gtR"], T=gt["gtT"], focal_length=gt["gtFL"], device=device
        )
        aligned = align_cameras(pred, gt_cameras, estimate_scale=True)
        are = float(compute_are(aligned.R, gt_cameras.R).mean())
        print(f"For {folder}: the absolute rotation error is {are:.6f} degrees.")
        out["ARE_deg"] = are
    else:
        print("No GT provided. No evaluation conducted.")

    out_dir = cfg.get("out_dir", "outputs")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "predictions.npz"), **out)
    print(f"Saved {os.path.join(out_dir, 'predictions.npz')}")
    return out


def main():
    import torch

    from posediffusion_tpu.utils.config import cli_config

    cfg = cli_config("default")
    print("Model Config:")
    print(cfg.to_yaml())
    return run(cfg, "cuda" if torch.cuda.is_available() else "cpu")


if __name__ == "__main__":
    main()
