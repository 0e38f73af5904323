"""RealEstate10K dataset.

Replaces the reference dataset (pose_diffusion/datasets/re10k.py:40-425),
torch-free.  Scene annotations are the RealEstate10K per-scene txt format:
one line per frame with ``timestamp fx fy cx cy k1 k2 3x4-extrinsics``
(intrinsics normalized by image size); extrinsics are COLMAP
(column-vector) world-to-camera, converted here to the row-vector NDC
convention (transpose R, negate the first two columns/components —
reference: re10k.py:343-346).  A pickle cache avoids reparsing.

Train split only, matching the reference (re10k.py:76-77); the eval list
ships as ``re10k_test_1800.txt`` ids.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from posediffusion_tpu_torch.data import camera_np
from posediffusion_tpu_torch.data.augment import RE10K_COLOR_JITTER, RandomErase
from posediffusion_tpu_torch.data.images import load_image_chw, resize_bilinear_np


class Re10KDataset:
    def __init__(
        self,
        split: str = "train",
        Re10K_DIR: Optional[str] = None,
        Re10K_ANNOTATION_DIR: Optional[str] = None,
        min_num_images: int = 50,
        img_size: int = 224,
        eval_time: bool = False,
        normalize_cameras: bool = False,
        first_camera_transform: bool = True,
        compute_optical: bool = False,
        center_box: bool = True,
        crop_longest: bool = False,
        sort_by_filename: bool = False,
        color_aug: bool = True,
        erase_aug: bool = False,
        jitter_scale: Tuple[float, float] = (0.8, 1.0),
        jitter_trans: Tuple[float, float] = (-0.07, 0.07),
        seed: int = 0,
    ):
        if Re10K_DIR is None:
            raise ValueError("Re10K_DIR is not specified")
        if split != "train":
            raise ValueError("only the train split ships annotations (reference parity)")
        self.Re10K_DIR = Re10K_DIR
        self.train_dir = osp.join(Re10K_DIR, "frames/train")
        video_loc = osp.join(self.train_dir, "video_loc.txt")
        self.scenes = np.loadtxt(video_loc, dtype=np.str_)
        self.scene_info_dir = osp.join(Re10K_ANNOTATION_DIR, "train")
        self.min_num_images = min_num_images

        self.img_size = img_size
        self.eval_time = eval_time
        self.normalize_cameras = normalize_cameras
        self.first_camera_transform = first_camera_transform
        self.compute_optical = compute_optical
        self.center_box = center_box
        self.crop_longest = crop_longest
        self.sort_by_filename = sort_by_filename
        self.color_aug = color_aug and not eval_time
        self.erase_aug = erase_aug
        if eval_time:
            self.jitter_scale, self.jitter_trans = (1.0, 1.0), (0.0, 0.0)
        else:
            self.jitter_scale, self.jitter_trans = jitter_scale, jitter_trans
        self._jitter = RE10K_COLOR_JITTER
        self._erase = RandomErase(scale=(0.02, 0.05))
        import threading

        self._base_seed = seed
        self._seed_seq = np.random.SeedSequence(seed)
        self._rng_lock = threading.Lock()

        self.wholedata = self._build_dataset()
        self.sequence_list = sorted(self.wholedata.keys())

    def _build_dataset(self) -> Dict[str, List[dict]]:
        cached = osp.join(osp.dirname(self.scene_info_dir), "processed.pkl")
        if osp.exists(cached):
            with open(cached, "rb") as f:
                return pickle.load(f)
        wholedata = {}
        for scene in np.atleast_1d(self.scenes):
            scene = str(scene)
            info_path = osp.join(self.scene_info_dir, osp.basename(scene) + ".txt")
            scene_info = np.loadtxt(info_path, delimiter=" ", dtype=np.float64, skiprows=1)
            scene_info = np.atleast_2d(scene_info)
            filtered = []
            for raw in scene_info:
                timestamp = raw[0]
                intrinsics = raw[1:7]
                extrinsics = raw[7:]
                imgpath = osp.join(self.train_dir, scene, "%s" % int(timestamp) + ".png")
                if not osp.exists(imgpath):
                    continue
                image_size = Image.open(imgpath).size  # (w, h)
                posemat = extrinsics.reshape(3, 4)
                filtered.append(
                    {
                        "filepath": imgpath,
                        "R": posemat[:3, :3],
                        "T": posemat[:3, -1],
                        "focal_length": intrinsics[:2] * image_size,
                        "principal_point": intrinsics[2:4] * image_size,
                    }
                )
            if len(filtered) > self.min_num_images:
                wholedata["re10k" + scene] = filtered
        return wholedata

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
        from posediffusion_tpu_torch.data.co3d import square_bbox

        bbox = square_bbox(bbox.astype(np.float32))
        s = rng.uniform(*self.jitter_scale)
        tx, ty = rng.uniform(*self.jitter_trans, size=2)
        side = bbox[2] - bbox[0]
        center = (bbox[:2] + bbox[2:]) / 2 + np.array([tx, ty]) * side
        extent = side / 2 * s
        ul = np.round(center - extent).astype(np.int64)
        lr = ul + np.round(2 * extent).astype(np.int64)
        return np.concatenate([ul, lr])

    def __getitem__(self, idx_n: Tuple[int, ...]) -> Dict:
        index, n_per_seq = idx_n[0], idx_n[1]
        item_seed = idx_n[2] if len(idx_n) > 2 else None
        seq = self.sequence_list[index]
        metadata = self.wholedata[seq]
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
        metadata = self.wholedata[sequence_name]
        assert len(np.unique(ids)) == len(ids)
        annos = [metadata[i] for i in ids]
        if self.sort_by_filename:
            annos = sorted(annos, key=lambda x: x["filepath"])

        images, fls, pps, crop_params, image_paths = [], [], [], [], []
        new_fls, new_pps = [], []
        for anno in annos:
            img = load_image_chw(anno["filepath"])
            image_paths.append(anno["filepath"])
            h, w = img.shape[1:]

            # raw pixel intrinsics -> NDC (mirrored pp), reference re10k.py:268-275
            original_wh = np.array([w, h], np.float64)
            scale = min(original_wh) / 2.0
            c0 = original_wh / 2.0
            fl_ndc = np.asarray(anno["focal_length"]) / scale
            pp_ndc = -(np.asarray(anno["principal_point"]) - c0) / scale
            fls.append(fl_ndc)
            pps.append(pp_ndc)

            if self.crop_longest:
                m = max(h, w)
            else:
                m = min(h, w)
            top, left = (h - m) // 2, (w - m) // 2
            bbox = np.array([left, top, left + m, top + m])
            bbox_j = bbox if self.eval_time else self._jitter_bbox(bbox, rng)
            bbox_xywh = camera_np.bbox_xyxy_to_xywh(bbox_j).astype(np.float64)

            fl_c, pp_c = camera_np.adjust_intrinsics_to_bbox_crop(
                fl_ndc, pp_ndc, original_wh, bbox_xywh
            )
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

        # COLMAP (column-vector) -> row-vector NDC extrinsics
        R = np.stack([np.asarray(a["R"], np.float64) for a in annos])
        T = np.stack([np.asarray(a["T"], np.float64) for a in annos])
        R = R.transpose(0, 2, 1).copy()
        R[:, :, :2] *= -1
        T[:, :2] *= -1

        if not self.normalize_cameras:
            raise NotImplementedError("please normalize cameras (reference parity)")
        Rn, Tn = camera_np.normalize_cameras(
            R, T, new_fls, new_pps,
            compute_optical=self.compute_optical,
            first_camera=self.first_camera_transform,
            normalize_T=True,
        )

        imgs = np.stack(images)
        if self.color_aug:
            # per-frame draws, matching the reference's frame loop
            # (re10k.py:224-228)
            out = []
            for im in imgs:
                if self.erase_aug and rng.uniform() < 0.15:
                    # the 0.15 gate above is the only coin flip
                    # (reference re10k.py:383-385)
                    im = self._erase.apply_once(im, rng)
                out.append(self._jitter(im, rng))
            imgs = np.stack(out)
        imgs = np.clip(imgs, 0.0, 1.0)

        batch = {
            "seq_name": sequence_name,
            "frame_num": len(metadata),
            "image": imgs.astype(np.float32),
            "R": Rn,
            "T": Tn,
            "fl": new_fls,
            "pp": new_pps,
            "crop_params": np.stack(crop_params),
        }
        if return_path:
            return batch, image_paths
        return batch
