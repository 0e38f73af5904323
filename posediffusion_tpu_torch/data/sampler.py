"""Dynamic batch sampler with XLA shape bucketing + batch collation.

Replaces the reference ``DynamicBatchSampler``
(pose_diffusion/util/train_util.py:27-59): each batch draws a random
frames-per-sequence n in [lo, hi) and takes ``max_images // n`` sequences.

TPU addition (SURVEY.md section 7 "hard parts"): n is padded up to a fixed
bucket so the number of distinct compiled shapes is bounded by the bucket
list; for each bucket the sequence count is ``max_images // bucket`` so the
token budget per step stays ~constant.  Padded frames carry a validity mask
consumed by the denoiser/loss.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from posediffusion_tpu_torch.data.camera_np import matrix_to_quaternion

DEFAULT_FRAME_BUCKETS = (4, 8, 16, 24, 32, 51)


class DynamicBatchSampler:
    def __init__(
        self,
        num_sequences: int,
        dataset_len: int = 1024,
        max_images: int = 128,
        images_per_seq: Tuple[int, int] = (3, 20),
        frame_buckets: Optional[Sequence[int]] = DEFAULT_FRAME_BUCKETS,
        batch_multiple: int = 1,
        seed: int = 0,
        sequence_indices: Optional[Sequence[int]] = None,
        shape_seed: Optional[int] = None,
    ):
        # batch_multiple: round the sequence count up so the batch axis is
        # divisible by the data-parallel mesh size.
        #
        # sequence_indices: restrict sampling to this index subset — used to
        # shard eval sequences disjointly across hosts (the reference gets
        # this from accelerate's dataloader sharding, train.py:81).
        #
        # shape_seed: seed a SEPARATE rng for the per-batch shape decision
        # (frames-per-sequence -> bucket -> sequence count).  Multi-host SPMD
        # requires every process to assemble the same GLOBAL batch shape each
        # step, so hosts share a shape_seed while drawing their items from
        # process-unique ``seed`` streams.  None (default): shapes and items
        # come from the single ``seed`` stream (single-process behavior,
        # unchanged).
        self.batch_multiple = max(batch_multiple, 1)
        self.num_sequences = num_sequences
        self.sequence_indices = (
            np.asarray(sequence_indices, dtype=np.int64)
            if sequence_indices is not None
            else None
        )
        self.dataset_len = dataset_len
        self.max_images = max_images
        self.images_per_seq = list(range(images_per_seq[0], images_per_seq[1]))
        if frame_buckets is not None:
            hi = max(self.images_per_seq)
            self.frame_buckets = sorted(b for b in frame_buckets if b >= min(self.images_per_seq))
            if self.frame_buckets[-1] < hi:
                self.frame_buckets.append(hi)
        else:
            self.frame_buckets = None
        self.rng = np.random.default_rng(seed)
        self.shape_rng = (
            np.random.default_rng(shape_seed) if shape_seed is not None else self.rng
        )

    def bucket_for(self, n: int) -> int:
        if self.frame_buckets is None:
            return n
        for b in self.frame_buckets:
            if b >= n:
                return b
        return self.frame_buckets[-1]

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        for _ in range(self.dataset_len):
            n_per_seq = int(self.shape_rng.choice(self.images_per_seq))
            bucket = self.bucket_for(n_per_seq)
            n_seqs = max(self.max_images // bucket, 1)
            m = self.batch_multiple
            n_seqs = ((n_seqs + m - 1) // m) * m
            pool = (
                self.sequence_indices
                if self.sequence_indices is not None
                else self.num_sequences
            )
            n_pool = len(pool) if self.sequence_indices is not None else pool
            chosen = self.rng.choice(pool, size=n_seqs, replace=n_pool < n_seqs)
            # Per-item seeds drawn here, in deterministic single-threaded
            # iteration order: item randomness (frame choice, crop jitter,
            # color aug) must not depend on worker-pool scheduling, and
            # duplicate (index, n) draws must still get distinct streams.
            seeds = self.rng.integers(0, 2**63 - 1, size=n_seqs)
            yield [(int(i), n_per_seq, int(s)) for i, s in zip(chosen, seeds)]

    def __len__(self):
        return self.dataset_len


def encode_batch_poses(batch_items: List[Dict]) -> np.ndarray:
    """R/T/fl dicts -> (N, 9) absT_quaR_logFL encodings (host side)."""
    import numpy as np

    from posediffusion_tpu_torch.geometry.pose_codec import LOG_FL_BIAS, MAX_FL, MIN_FL

    out = []
    for item in batch_items:
        R = np.asarray(item["R"], np.float64)
        T = np.asarray(item["T"], np.float64)
        fl = np.asarray(item["fl"], np.float64)
        quat = matrix_to_quaternion(R)
        log_fl = np.log(np.clip(fl, MIN_FL, MAX_FL)) - LOG_FL_BIAS
        out.append(np.concatenate([T, quat, log_fl], axis=-1).astype(np.float32))
    return np.stack(out)


def collate_batch(
    items: List[Dict], pad_frames_to: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Stack per-sequence items into a padded training batch with mask.

    Returns {"images": (B, Nb, 3, H, W), "pose_encodings": (B, Nb, 9),
    "mask": (B, Nb)}.
    """
    n = items[0]["image"].shape[0]
    nb = pad_frames_to or n
    B = len(items)
    _, C, H, W = items[0]["image"].shape

    images = np.zeros((B, nb, C, H, W), np.float32)
    encodings = np.zeros((B, nb, 9), np.float32)
    mask = np.zeros((B, nb), bool)
    enc = encode_batch_poses(items)
    for i, item in enumerate(items):
        ni = item["image"].shape[0]
        images[i, :ni] = item["image"]
        encodings[i, :ni] = enc[i][:ni]
        mask[i, :ni] = True
    return {"images": images, "pose_encodings": encodings, "mask": mask}
