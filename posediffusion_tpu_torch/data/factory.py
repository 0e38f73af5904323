"""Dataset factory helpers (reference train_util.py:95-143 parity)."""

from __future__ import annotations

from posediffusion_tpu_torch.data.co3d import Co3dDataset


def get_co3d_dataset(cfg):
    """Train + eval Co3D datasets from a train-style config node."""
    t = cfg.train
    common = dict(
        category=(t.category,),
        CO3D_DIR=t.CO3D_DIR,
        CO3D_ANNOTATION_DIR=t.CO3D_ANNOTATION_DIR,
        img_size=t.img_size,
        normalize_cameras=t.normalize_cameras,
        min_num_images=t.min_num_images,
        first_camera_transform=t.first_camera_transform,
        compute_optical=t.compute_optical,
        mask_images=t.get("mask_images", False),
        color_aug=t.get("color_aug", True),
        erase_aug=t.get("erase_aug", False),
    )
    dataset = Co3dDataset(split="train", **common)
    eval_dataset = Co3dDataset(split="test", eval_time=True, **common)
    return dataset, eval_dataset


def get_co3d_dataset_test(cfg, category=None):
    """Test-split dataset (sort_by_filename on, to align with matches)."""
    t = cfg.test
    return Co3dDataset(
        category=(category or t.category,),
        split="test",
        eval_time=True,
        CO3D_DIR=t.CO3D_DIR,
        CO3D_ANNOTATION_DIR=t.CO3D_ANNOTATION_DIR,
        img_size=t.img_size,
        normalize_cameras=t.normalize_cameras,
        min_num_images=t.min_num_images,
        first_camera_transform=t.first_camera_transform,
        compute_optical=t.compute_optical,
        sort_by_filename=True,
    )
