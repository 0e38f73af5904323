"""Single-folder pose inference with the PyTorch port, with or without GGS.

Same CLI as demo.py (a config name, then dotted overrides):

    python demo_torch.py image_folder=samples/apple GGS.enable=False ckpt=random
    python demo_torch.py image_folder=samples/apple GGS.enable=False ckpt=random device=cpu
    python demo_torch.py image_folder=samples/apple GGS.matcher_ckpt_dir=weights/ ckpt=random
    python demo_torch.py image_folder=samples/apple GGS.matches_file=m.npz ckpt=random

Pipeline: load + preprocess the images -> with ``GGS.enable``, 2D matches:
an npz from ``GGS.matches_file`` (``kp1``, ``kp2`` (M, 2) pixels, ``i12``
(M, 2) frame pairs with i < j), or else extracted from the images with the
MagicLeap ``superpoint_v1.pth`` and ``superglue_outdoor.pth`` in
``GGS.matcher_ckpt_dir`` (SuperPoint, SuperGlue on the CUDA kernels on a
card, RANSAC, remap into the cropped frame; ``GGS.max_keypoints``,
``GGS.match_threshold``, ``GGS.ransac_threshold_px``,
``GGS.min_pair_matches``) -> diffusion sampling, 100 steps at the
default config (``MODEL.DIFFUSER.timesteps``) with the config's objective,
``pred_noise`` or ``pred_x0`` (ViT trunk and sampler on the CUDA kernels on
a card), whose last ``GGS.start_step`` steps
are geometry-guided when matches exist (the GGS phases on the GGS kernels on
a card) -> decode to cameras -> 7-DoF alignment to gt_cameras.npz, if
present -> absolute rotation error -> ``<out_dir>/predictions.npz``, and the
cameras (with the aligned prediction and the ground truth, when present)
as ``<out_dir>/cameras.html``, an interactive scene, and
``<out_dir>/cameras.png`` where matplotlib is installed (else the demo says
it skipped the PNG).

``ckpt`` is a reference ``.pth`` (strict load); anything else that is not an
existing ``.pth`` gives random weights seeded by ``seed``. It runs on the
card; ``device=cpu`` runs it on the CPU (the kernels' plain versions).
With GGS on but neither a matches file nor matcher weights, the demo says
so and samples without GGS, as demo.py does. ``get_matches`` serves
test_torch.py too.
"""

import os
import time

import numpy as np


def get_matches(cfg, image_info, device):
    """(kp1, kp2, i12) for GGS, as demo.py's get_matches: a precomputed npz
    (``GGS.matches_file``), else extraction from the images with MagicLeap
    weights from ``GGS.matcher_ckpt_dir``, else (None,) * 3. A failure of
    the extraction itself raises: no fallback hides it."""
    matches_file = cfg.GGS.get("matches_file")
    if matches_file and os.path.isfile(str(matches_file)):
        data = np.load(str(matches_file))
        return data["kp1"], data["kp2"], data["i12"]
    weights_dir = cfg.GGS.get("matcher_ckpt_dir")
    if not weights_dir:
        print("[GGS] match extraction unavailable (no matcher weights (set "
              "GGS.matcher_ckpt_dir)); sampling without GGS")
        return None, None, None

    from posediffusion_tpu_torch.matching.extract import extract_match

    start = time.perf_counter()
    kp1, kp2, i12 = extract_match(
        image_paths=image_info["paths"],
        image_info=image_info,
        weights_dir=str(weights_dir),
        max_keypoints=int(cfg.GGS.get("max_keypoints", 4096)),
        match_threshold=float(cfg.GGS.get("match_threshold", 0.2)),
        ransac_threshold_px=float(cfg.GGS.get("ransac_threshold_px", 4.0)),
        min_pair_matches=int(cfg.GGS.get("min_pair_matches", 8)),
        device=device,
    )
    n = 0 if kp1 is None else len(kp1)
    print(f"[GGS] extracted {n} verified matches in {time.perf_counter() - start:.2f} s")
    return kp1, kp2, i12


def run(cfg, device: str) -> dict:
    """The demo's flow for a loaded config; returns what it saves."""
    import torch

    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.geometry.align import align_cameras
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
    from posediffusion_tpu_torch.geometry.metrics import compute_are
    from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera
    from posediffusion_tpu_torch.models.pose_diffusion import (
        PoseDiffusionModel,
        init_random_weights,
    )
    from posediffusion_tpu_torch.diffusion.ggs import build_cond_fn
    from posediffusion_tpu_torch.utils.config import build_ggs_config, model_config_from_cfg
    from posediffusion_tpu_torch.utils.convert import load_reference_state_dict
    from posediffusion_tpu_torch.utils.precision import pin_full_float32
    from posediffusion_tpu_torch.utils.visualize import export_scene_html, plot_cameras

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
    images, image_info = load_and_preprocess_images(folder, cfg.image_size)
    images = torch.as_tensor(images, device=device)[None]  # 1 x N x 3 x H x W

    cond_fn, cond_start_step = None, 0
    kp1, kp2, i12 = get_matches(cfg, image_info, device) if cfg.GGS.enable else (None,) * 3
    if kp1 is not None:
        ggs_cfg = build_ggs_config(cfg.GGS)
        hw = (cfg.image_size, cfg.image_size)
        cond_fn = build_cond_fn(kp1, kp2, i12, images.shape[1], hw, ggs_cfg, device)
        cond_start_step = ggs_cfg.start_step
        print(f"=====> Sampling with GGS ({len(kp1)} matches) <=====")
    else:
        print("=====> Sampling without GGS <=====")

    def infer():
        gen = torch.Generator(device=device).manual_seed(int(cfg.seed))
        start = time.perf_counter()
        enc = model.sample(images, generator=gen, cond_fn=cond_fn,
                           cond_start_step=cond_start_step)
        if images.is_cuda:
            torch.cuda.synchronize()
        return enc, time.perf_counter() - start

    enc, first = infer()
    print(f"Time taken: {first:.4f} seconds (first call, incl. any kernel build)")
    enc, steady = infer()
    print(f"Time taken: {steady:.4f} seconds (second call)")

    pred = pose_encoding_to_camera(enc)
    out = {
        "ggs_matches": 0 if kp1 is None else len(kp1),
        "pose_encoding": enc.cpu().numpy(),
        "R": pred.R.cpu().numpy(),
        "T": pred.T.cpu().numpy(),
        "focal_length": pred.focal_length.cpu().numpy(),
    }
    camera_sets = {"ours_pred": pred}
    gt_path = os.path.join(folder, "gt_cameras.npz")
    if os.path.exists(gt_path):
        gt = np.load(gt_path)
        gt_cameras = PerspectiveCameras.create(
            R=gt["gtR"], T=gt["gtT"], focal_length=gt["gtFL"], device=device
        )
        aligned = align_cameras(pred, gt_cameras, estimate_scale=True)
        are = float(compute_are(aligned.R, gt_cameras.R).mean())
        print(f"For {folder}: the absolute rotation error is {are:.6f} degrees.")
        camera_sets["ours_pred_aligned"] = aligned
        camera_sets["gt_cameras"] = gt_cameras
        out["ARE_deg"] = are
    else:
        print("No GT provided. No evaluation conducted.")

    out_dir = cfg.get("out_dir", "outputs")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "predictions.npz"), **out)
    plots = [export_scene_html(camera_sets, os.path.join(out_dir, "cameras.html"))]
    try:
        plots.append(plot_cameras(camera_sets, os.path.join(out_dir, "cameras.png")))
    except ImportError as e:
        print(f"Skipped cameras.png: matplotlib is not installed ({e})")
    print(f"Saved {os.path.join(out_dir, 'predictions.npz')} + {' + '.join(plots)}")
    out["plots"] = plots
    return out


def main():
    from posediffusion_tpu_torch.utils.config import cli_config, device_from_cfg

    cfg = cli_config("default")
    print("Model Config:")
    print(cfg.to_yaml())
    return run(cfg, device_from_cfg(cfg))


if __name__ == "__main__":
    main()
