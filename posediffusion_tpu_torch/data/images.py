"""Host-side image loading and preprocessing.

Replaces the reference's loader (pose_diffusion/util/load_img_folder.py:
15-117): sorted folder glob -> float [0, 1] CHW -> center square crop ->
bilinear resize to ``image_size`` -> stacked batch plus the ``image_info``
(crop bboxes + resize scales) GGS needs to remap keypoints.

Torch-free: decode via PIL, resize via a numpy bilinear with half-pixel
centers (same sampling grid as torch ``F.interpolate(align_corners=False)``,
validated against torch in tests).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def resize_bilinear_np(image_chw: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize (C, H, W) float array with half-pixel centers."""
    c, h, w = image_chw.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return image_chw

    def grid(in_size, out_size):
        coords = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
        lo = np.floor(coords).astype(np.int64)
        frac = coords - lo
        lo0 = np.clip(lo, 0, in_size - 1)
        lo1 = np.clip(lo + 1, 0, in_size - 1)
        return lo0, lo1, frac.astype(image_chw.dtype)

    y0, y1, fy = grid(h, oh)
    x0, x1, fx = grid(w, ow)

    top = image_chw[:, y0][:, :, x0] * (1 - fx) + image_chw[:, y0][:, :, x1] * fx
    bot = image_chw[:, y1][:, :, x0] * (1 - fx) + image_chw[:, y1][:, :, x1] * fx
    return top * (1 - fy[None, :, None]) + bot * fy[None, :, None]


def load_image_chw(path: str) -> np.ndarray:
    """Decode an image file to float32 (3, H, W) in [0, 1]."""
    with Image.open(path) as pil_im:
        im = np.asarray(pil_im.convert("RGB"))
    return im.transpose(2, 0, 1).astype(np.float32) / 255.0


def center_crop_square(image_chw: np.ndarray):
    """Center square crop; returns (cropped, bbox_xyxy, min_hw)."""
    h, w = image_chw.shape[1:]
    m = min(h, w)
    top = (h - m) // 2
    left = (w - m) // 2
    cropped = image_chw[:, top : top + m, left : left + m]
    bbox_xyxy = np.array([left, top, left + m, top + m], dtype=np.int64)
    return cropped, bbox_xyxy, m


def load_and_preprocess_images(
    folder_path: Optional[str] = None,
    image_size: int = 224,
    image_paths: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, Dict]:
    """Load a folder (or explicit paths) into an (N, 3, s, s) batch.

    Returns (images, image_info) where image_info carries
    {"size", "bboxes_xyxy", "resized_scales"} for GGS keypoint remapping
    (reference: load_img_folder.py:47).
    """
    if image_paths is None:
        if folder_path is None:
            raise ValueError("need folder_path or image_paths")
        image_paths = [
            os.path.join(folder_path, f)
            for f in os.listdir(folder_path)
            if f.lower().endswith(IMAGE_EXTENSIONS)
        ]
    image_paths = sorted(image_paths)
    if not image_paths:
        raise ValueError(f"no images found ({folder_path})")

    images, bboxes, scales = [], [], []
    min_hw = None
    for path in image_paths:
        img = load_image_chw(path)
        img, bbox_xyxy, m = center_crop_square(img)
        images.append(resize_bilinear_np(img, (image_size, image_size)))
        bboxes.append(bbox_xyxy)
        scales.append(image_size / m)
        min_hw = m

    image_info = {
        "size": (min_hw, min_hw),
        "bboxes_xyxy": np.stack(bboxes),
        "resized_scales": np.asarray(scales, dtype=np.float64),
        "paths": list(image_paths),
    }
    return np.stack(images), image_info
