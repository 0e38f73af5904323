"""Co3D-v2 dataset (relpose-style gzip-JSON annotations).

Replaces the reference dataset (pose_diffusion/datasets/co3d_v2.py:33-444),
torch-free.  Per item: N random frames of one sequence; center-box (or
annotation) bbox with train-time jitter (scale [0.8, 1.2], trans +-0.07);
crop + resize with NDC intrinsics adjustment; per-sequence camera
normalization (optical-axis intersection + first-camera gauge); color/
grayscale/erase augmentation.

Annotation format per category x split (``{category}_{split}.jgz``): JSON
{seq_name: [{filepath, bbox, R, T, focal_length, principal_point}, ...]},
with R/T already in the row-vector NDC camera convention.
"""

from __future__ import annotations

import gzip
import json
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from posediffusion_tpu_torch.data import camera_np
from posediffusion_tpu_torch.data.augment import ColorJitter, RandomErase
from posediffusion_tpu_torch.data.images import load_image_chw, resize_bilinear_np

TRAINING_CATEGORIES = [
    "apple", "backpack", "banana", "baseballbat", "baseballglove", "bench",
    "bicycle", "bottle", "bowl", "broccoli", "cake", "car", "carrot",
    "cellphone", "chair", "cup", "donut", "hairdryer", "handbag", "hydrant",
    "keyboard", "laptop", "microwave", "motorcycle", "mouse", "orange",
    "parkingmeter", "pizza", "plant", "stopsign", "teddybear", "toaster",
    "toilet", "toybus", "toyplane", "toytrain", "toytruck", "tv", "umbrella",
    "vase", "wineglass",
]
TEST_CATEGORIES = [
    "ball", "book", "couch", "frisbee", "hotdog", "kite", "remote",
    "sandwich", "skateboard", "suitcase",
]
DEBUG_CATEGORIES = ["apple", "teddybear"]


def square_bbox(bbox: np.ndarray, padding: float = 0.0) -> np.ndarray:
    bbox = np.asarray(bbox, np.float64)
    center = (bbox[:2] + bbox[2:]) / 2
    extent = max(bbox[2:] - bbox[:2]) / 2 * (1 + padding)
    return np.array(
        [center[0] - extent, center[1] - extent, center[0] + extent, center[1] + extent]
    )


def expand_categories(category: Sequence[str]) -> List[str]:
    cats = list(category)
    if "seen" in cats:
        cats = TRAINING_CATEGORIES
    elif "unseen" in cats:
        cats = TEST_CATEGORIES
    elif "debug" in cats:
        cats = DEBUG_CATEGORIES
    elif "all" in cats:
        cats = TRAINING_CATEGORIES + TEST_CATEGORIES
    return sorted(cats)


class Co3dDataset:
    def __init__(
        self,
        category: Sequence[str] = ("all",),
        split: str = "train",
        CO3D_DIR: Optional[str] = None,
        CO3D_ANNOTATION_DIR: Optional[str] = None,
        min_num_images: int = 50,
        img_size: int = 224,
        eval_time: bool = False,
        normalize_cameras: bool = False,
        first_camera_transform: bool = True,
        compute_optical: bool = False,
        center_box: bool = True,
        sort_by_filename: bool = False,
        mask_images: bool = False,
        color_aug: bool = True,
        erase_aug: bool = False,
        jitter_scale: Tuple[float, float] = (0.8, 1.2),
        jitter_trans: Tuple[float, float] = (-0.07, 0.07),
        seed: int = 0,
    ):
        if CO3D_DIR is None:
            raise ValueError("CO3D_DIR is not specified")
        self.CO3D_DIR = CO3D_DIR
        self.img_size = img_size
        self.eval_time = eval_time
        self.normalize_cameras = normalize_cameras
        self.first_camera_transform = first_camera_transform
        self.compute_optical = compute_optical
        self.center_box = center_box
        self.sort_by_filename = sort_by_filename
        self.mask_images = mask_images
        self.color_aug = color_aug and not eval_time
        self.erase_aug = erase_aug
        if eval_time:
            self.jitter_scale, self.jitter_trans = (1.0, 1.0), (0.0, 0.0)
        else:
            self.jitter_scale, self.jitter_trans = jitter_scale, jitter_trans
        self._jitter = ColorJitter()
        self._erase = RandomErase()
        # Per-item RNG streams: __getitem__ runs on a worker pool, and numpy
        # Generators are not thread-safe.  Batch specs from the sampler carry
        # a per-item seed drawn in deterministic iteration order, so item
        # randomness is independent of worker scheduling; spawn-under-lock is
        # only the fallback for direct (seedless) calls.
        import threading

        self._base_seed = seed
        self._seed_seq = np.random.SeedSequence(seed)
        self._rng_lock = threading.Lock()

        self.rotations: Dict[str, List[dict]] = {}
        self.category_map: Dict[str, str] = {}
        self.low_quality_translations: List[str] = []

        for c in expand_categories(category):
            annotation_file = osp.join(CO3D_ANNOTATION_DIR, f"{c}_{split}.jgz")
            with gzip.open(annotation_file, "r") as fin:
                annotation = json.loads(fin.read())
            for seq_name, seq_data in annotation.items():
                if len(seq_data) < min_num_images:
                    continue
                filtered, bad = [], False
                for d in seq_data:
                    if d["T"][0] + d["T"][1] + d["T"][2] > 1e5:
                        bad = True
                        self.low_quality_translations.append(seq_name)
                        break
                    filtered.append(
                        {k: d[k] for k in (
                            "filepath", "bbox", "R", "T", "focal_length",
                            "principal_point",
                        )}
                    )
                if not bad:
                    self.rotations[seq_name] = filtered
                    self.category_map[seq_name] = c

        self.sequence_list = list(self.rotations.keys())

    def __len__(self):
        return len(self.sequence_list)

    def _item_rng(self, item_seed: Optional[int] = None) -> np.random.Generator:
        if item_seed is not None:
            return np.random.default_rng(
                np.random.SeedSequence([self._base_seed, int(item_seed)])
            )
        with self._rng_lock:
            child = self._seed_seq.spawn(1)[0]
        return np.random.default_rng(child)

    def _jitter_bbox(self, bbox: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        bbox = square_bbox(bbox.astype(np.float32))
        s = rng.uniform(*self.jitter_scale)
        tx, ty = rng.uniform(*self.jitter_trans, size=2)
        side = bbox[2] - bbox[0]
        center = (bbox[:2] + bbox[2:]) / 2 + np.array([tx, ty]) * side
        extent = side / 2 * s
        ul = np.round(center - extent).astype(np.int64)
        lr = ul + np.round(2 * extent).astype(np.int64)
        return np.concatenate([ul, lr])

    def _apply_mask(self, img: np.ndarray, filepath: str, category: str,
                    sequence_name: str) -> np.ndarray:
        """White-out the background using the Co3D mask (reference:
        datasets/co3d_v2.py:242-253: mask > 125 keeps the foreground)."""
        from PIL import Image

        mask_name = osp.basename(filepath).replace(".jpg", ".png")
        mask_path = osp.join(self.CO3D_DIR, category, sequence_name, "masks", mask_name)
        with Image.open(mask_path) as m:
            mask = np.asarray(m.convert("L"), np.float32)
        if mask.shape != img.shape[1:]:
            mask = resize_bilinear_np(mask[None], img.shape[1:])[0]
        keep = (mask > 125)[None]
        return np.where(keep, img, 1.0).astype(np.float32)

    def __getitem__(self, idx_n: Tuple[int, ...]) -> Dict:
        index, n_per_seq = idx_n[0], idx_n[1]
        item_seed = idx_n[2] if len(idx_n) > 2 else None
        seq = self.sequence_list[index]
        metadata = self.rotations[seq]
        rng = self._item_rng(item_seed)
        ids = rng.choice(len(metadata), n_per_seq, replace=False)
        return self.get_data(index=index, ids=ids, rng=rng)

    def get_data(
        self,
        index: Optional[int] = None,
        sequence_name: Optional[str] = None,
        ids: Sequence[int] = (0, 1),
        return_path: bool = False,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict:
        rng = rng or self._item_rng()
        if sequence_name is None:
            sequence_name = self.sequence_list[index]
        metadata = self.rotations[sequence_name]
        category = self.category_map[sequence_name]
        annos = [metadata[i] for i in ids]
        if self.sort_by_filename:
            annos = sorted(annos, key=lambda x: x["filepath"])

        images, new_fls, new_pps, crop_params, image_paths = [], [], [], [], []
        for anno in annos:
            path = osp.join(self.CO3D_DIR, anno["filepath"])
            img = load_image_chw(path)
            if self.mask_images:
                img = self._apply_mask(img, anno["filepath"], category, sequence_name)
            image_paths.append(path)
            h, w = img.shape[1:]

            if self.center_box:
                m = min(h, w)
                top, left = (h - m) // 2, (w - m) // 2
                bbox = np.array([left, top, left + m, top + m])
            else:
                bbox = np.asarray(anno["bbox"])

            bbox_j = bbox if self.eval_time else self._jitter_bbox(bbox, rng)
            bbox_xywh = camera_np.bbox_xyxy_to_xywh(bbox_j).astype(np.float64)

            fl, pp = np.asarray(anno["focal_length"]), np.asarray(anno["principal_point"])
            fl_c, pp_c = camera_np.adjust_intrinsics_to_bbox_crop(
                fl, pp, np.array([w, h], np.float64), bbox_xywh
            )

            # crop (clamp to image bounds like torchvision crop with padding 0)
            x0, y0, x1, y1 = bbox_j
            ch, cw = int(y1 - y0), int(x1 - x0)
            crop = np.zeros((3, ch, cw), np.float32)
            sy0, sy1 = max(0, y0), min(h, y1)
            sx0, sx1 = max(0, x0), min(w, x1)
            crop[:, sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = img[:, sy0:sy1, sx0:sx1]

            fl_n, pp_n = camera_np.adjust_intrinsics_to_image_scale(
                fl_c, pp_c, np.array([cw, ch], np.float64),
                np.array([self.img_size, self.img_size], np.float64),
            )
            new_fls.append(fl_n)
            new_pps.append(pp_n)

            images.append(resize_bilinear_np(crop, (self.img_size, self.img_size)))

            crop_center = (bbox_j[:2] + bbox_j[2:]) / 2
            cc = 2 * crop_center / min(h, w) - 1
            crop_width = 2 * (bbox_j[2] - bbox_j[0]) / min(h, w)
            crop_params.append(np.array([-cc[0], -cc[1], crop_width], np.float32))

        new_fls = np.stack(new_fls).astype(np.float32)
        new_pps = np.stack(new_pps).astype(np.float32)
        R = np.stack([np.asarray(a["R"], np.float64) for a in annos])
        T = np.stack([np.asarray(a["T"], np.float64) for a in annos])

        batch = {
            "seq_id": sequence_name,
            "category": category,
            "n": len(metadata),
            "ind": np.asarray(ids),
            "fl": new_fls,
            "pp": new_pps,
            "crop_params": np.stack(crop_params),
        }

        if self.normalize_cameras:
            Rn, Tn = camera_np.normalize_cameras(
                R, T, new_fls, new_pps,
                compute_optical=self.compute_optical,
                first_camera=self.first_camera_transform,
            )
            batch["R"], batch["T"] = Rn, Tn
            batch["R_original"], batch["T_original"] = (
                R.astype(np.float32), T.astype(np.float32),
            )
            if np.isnan(batch["T"]).any():
                raise RuntimeError(f"NaN T after normalization: {sequence_name}")
        else:
            batch["R"], batch["T"] = R.astype(np.float32), T.astype(np.float32)

        imgs = np.stack(images)
        if self.color_aug:
            # one parameter draw for the whole sequence (reference applies
            # torchvision ColorJitter/RandomGrayscale to the stacked tensor,
            # co3d_v2.py:169-177 + 384-386)
            jitter_params = self._jitter.sample_params(rng)
            imgs = np.stack([self._jitter.apply(im, jitter_params) for im in imgs])
            if self.erase_aug:
                # one flip + one shared region for the whole sequence
                imgs = self._erase.erase_batch(imgs, rng)
        batch["image"] = imgs.astype(np.float32)

        if return_path:
            return batch, image_paths
        return batch
