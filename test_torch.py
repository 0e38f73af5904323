"""Co3D-v2 evaluation with the PyTorch port, as test.py.

Same config (cfgs/default_test.yaml) and dotted-override CLI:

    python test_torch.py test.CO3D_DIR=... test.CO3D_ANNOTATION_DIR=... \\
        test.resume_ckpt=co3d_model.pth test.category=[apple] GGS.enable=False
    python test_torch.py ... device=cpu      # the kernels' plain versions

Per category and per sequence of at least ``test.num_frames`` frames:
``test.num_frames`` frame ids from ``np.random.choice`` (the global numpy
stream, seeded by ``seed`` as test.py seeds it), the frames read by the
Co3D reader (``eval_time``, sorted by file name) and preprocessed as the
demo does, with ``GGS.enable`` matches (``demo_torch.get_matches``: an npz
from ``GGS.matches_file``, else extracted with the MagicLeap weights in
``GGS.matcher_ckpt_dir``, else none) and their cond_fn, then
``model.sample``, the cameras, and every frame pair's relative rotation and
translation errors against the ground truth. Per category Racc and Tacc at
5, 15 and 30 degrees and AUC@30, then their means, printed as a table and
written to ``results_file`` (JSON, test.py's keys).

It runs on the card (``device=cuda``, the default): the ViT, the sampler,
its GGS tail and phases and the matcher on the kernels; ``device=cpu`` runs
their plain versions. ``test.resume_ckpt`` is a reference ``.pth`` (strict
load) or a checkpoint directory of train_torch.py (its newest); without one
the weights are drawn from ``seed`` with a warning.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

METRIC_NAMES = ["Auc_30", "Racc_5", "Racc_15", "Racc_30", "Tacc_5", "Tacc_15", "Tacc_30"]


def load_weights(model, cfg) -> None:
    """``test.resume_ckpt`` into ``model``, or seeded random weights."""
    from posediffusion_tpu_torch.models.pose_diffusion import init_random_weights
    from posediffusion_tpu_torch.training.checkpoints import latest_checkpoint, restore
    from posediffusion_tpu_torch.utils.convert import load_reference_state_dict

    ckpt = cfg.test.get("resume_ckpt")
    ckpt = str(ckpt) if ckpt else ""
    if ckpt.endswith(".pth") and os.path.isfile(ckpt):
        model.load_state_dict(load_reference_state_dict(ckpt), strict=True)
        print(f"Successfully resumed from {ckpt}")
    elif ckpt and os.path.isdir(ckpt):
        path = latest_checkpoint(ckpt)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt}")
        restore(path, model)
        print(f"Successfully resumed from {path}")
    else:
        init_random_weights(model, int(cfg.seed))
        print(f"WARNING: no checkpoint: evaluating random weights (seed {cfg.seed})")


def evaluate_category(model, category, cfg, ggs_cfg, device, generator):
    """One category's sequences, as test.py's ``_test_one_category``.
    Returns ({"rError": [...], "tError": [...]} over every frame pair, a
    record per sequence: its name, frame ids, pose encodings, ground truth,
    errors, and the seconds of its matches and of its sampling)."""
    import torch

    import demo_torch
    from posediffusion_tpu_torch.data.co3d import Co3dDataset
    from posediffusion_tpu_torch.data.images import load_and_preprocess_images
    from posediffusion_tpu_torch.diffusion.ggs import build_cond_fn
    from posediffusion_tpu_torch.geometry.cameras import PerspectiveCameras
    from posediffusion_tpu_torch.geometry.metrics import camera_to_rel_deg
    from posediffusion_tpu_torch.geometry.pose_codec import pose_encoding_to_camera

    t = cfg.test
    num_frames = int(t.num_frames)
    hw = (int(t.img_size), int(t.img_size))
    dataset = Co3dDataset(
        category=(category,), split="test", eval_time=True, CO3D_DIR=t.CO3D_DIR,
        CO3D_ANNOTATION_DIR=t.CO3D_ANNOTATION_DIR, min_num_images=t.min_num_images,
        img_size=t.img_size, normalize_cameras=t.normalize_cameras,
        first_camera_transform=t.first_camera_transform, compute_optical=t.compute_optical,
        sort_by_filename=True,  # the images in the order of the extracted matches
    )
    errors = {"rError": [], "tError": []}
    records = []
    for seq_name in dataset.sequence_list:
        metadata = dataset.rotations[seq_name]
        if len(metadata) < num_frames:
            print(f"Skip sequence {seq_name}")
            continue
        if not t.random_order:
            raise ValueError("Please specify your own sampling strategy")
        ids = np.random.choice(len(metadata), num_frames, replace=False)
        batch, image_paths = dataset.get_data(sequence_name=seq_name, ids=ids,
                                              return_path=True)
        images, image_info = load_and_preprocess_images(image_paths=image_paths,
                                                        image_size=t.img_size)
        images = torch.as_tensor(images, device=device)[None]

        cond_fn, cond_start_step = None, 0
        start = time.perf_counter()
        if cfg.GGS.enable:
            kp1, kp2, i12 = demo_torch.get_matches(cfg, image_info, device)
            if kp1 is not None:
                cond_fn = build_cond_fn(kp1, kp2, i12, num_frames, hw, ggs_cfg, device)
                cond_start_step = ggs_cfg.start_step
        match_seconds = time.perf_counter() - start

        start = time.perf_counter()
        enc = model.sample(images, generator=generator, cond_fn=cond_fn,
                           cond_start_step=cond_start_step)
        if enc.is_cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        pred = pose_encoding_to_camera(enc)
        gt = PerspectiveCameras.create(R=batch["R"], T=batch["T"], focal_length=batch["fl"],
                                       device=device)
        r_deg, t_deg = camera_to_rel_deg(pred, gt, batch_size=1)
        r_deg, t_deg = r_deg.cpu().numpy(), t_deg.cpu().numpy()
        print(f"{seq_name.ljust(20)}  Rot err {r_deg.mean():8.2f} deg | "
              f"Trans err {t_deg.mean():8.2f} deg | {seconds:.3f} s")
        errors["rError"].extend(r_deg.tolist())
        errors["tError"].extend(t_deg.tolist())
        records.append({
            "sequence": seq_name, "ids": np.asarray(ids), "pose_encoding": enc.cpu().numpy(),
            "R": batch["R"], "T": batch["T"], "fl": batch["fl"], "r_deg": r_deg,
            "t_deg": t_deg, "seconds": seconds, "match_seconds": match_seconds,
            "ggs": cond_fn is not None,
        })
    return errors, records


def category_metrics(r_error, t_error) -> dict:
    """Racc/Tacc@5/15/30 and AUC@30 of one category's pairs, in percent."""
    from posediffusion_tpu_torch.geometry.metrics import calculate_auc_np

    r_error, t_error = np.asarray(r_error), np.asarray(t_error)
    out = {"Auc_30": calculate_auc_np(r_error, t_error, 30) * 100}
    for th in (5, 15, 30):
        out[f"Racc_{th}"] = np.mean(r_error < th) * 100
        out[f"Tacc_{th}"] = np.mean(t_error < th) * 100
    return out


def run(cfg, device: str, records=None) -> dict:
    """test.py's flow for a loaded config; returns the metrics by name and
    category (with "mean"). A ``records`` list receives every sequence's
    record (``evaluate_category``)."""
    import torch

    from posediffusion_tpu_torch.data.co3d import expand_categories
    from posediffusion_tpu_torch.models.pose_diffusion import PoseDiffusionModel
    from posediffusion_tpu_torch.utils.config import build_ggs_config, model_config_from_cfg
    from posediffusion_tpu_torch.utils.precision import pin_full_float32
    from posediffusion_tpu_torch.utils.seeding import seed_all_random_engines

    pin_full_float32()
    seed_all_random_engines(int(cfg.seed))
    model = PoseDiffusionModel(model_config_from_cfg(cfg.MODEL))
    load_weights(model, cfg)
    model.to(device)
    ggs_cfg = build_ggs_config(cfg.GGS)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))

    category = cfg.test.category
    categories = expand_categories(category if isinstance(category, list) else [category])
    print("-" * 100)
    print(f"Testing on {categories}")
    print("-" * 100)

    category_dict = {m: {} for m in METRIC_NAMES}
    for category in categories:
        print(f"----- category {category} start")
        err, recs = evaluate_category(model, category, cfg, ggs_cfg, device, generator)
        if records is not None:
            records.extend(recs)
        if len(err["rError"]) == 0:
            continue
        for m, v in category_metrics(err["rError"], err["tError"]).items():
            category_dict[m][category] = v
        print(f"----- category {category} done")

    for m in METRIC_NAMES:
        vals = list(category_dict[m].values())
        category_dict[m]["mean"] = float(np.mean(vals)) if vals else float("nan")

    for c_name in categories + ["mean"]:
        row = f"{c_name.ljust(20)}: " + " | ".join(
            f"{m} {category_dict[m].get(c_name, float('nan')):.3f}" for m in METRIC_NAMES)
        if c_name == "mean":
            print("-" * 100)
        print(row)

    out_path = cfg.get("results_file", "eval_results.json")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(category_dict, f, indent=2, default=float)
        print(f"wrote {out_path}")
    return category_dict


def main(argv=None, records=None):
    from posediffusion_tpu_torch.utils.config import cli_config, device_from_cfg

    cfg = cli_config("default_test", argv)
    print("Config:")
    print(cfg.to_yaml())
    return run(cfg, device_from_cfg(cfg), records)


if __name__ == "__main__":
    main()
