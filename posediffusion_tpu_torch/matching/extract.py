"""End-to-end 2D match extraction for GGS, as
``posediffusion_tpu.matching.extract``.

SuperPoint on every frame (batched per image shape), exhaustive pairs
a < b, SuperGlue over chunks of pairs (``ops/superglue_kernel.
fused_match_pairs``: hand-written kernels on a card), COLMAP-style two-view
verification on the host (``matching/ransac.py``), then the keypoints are
remapped from original-image pixels into the cropped, rescaled frame the
pose model sees.

Returns ``(kp1 (M, 2), kp2 (M, 2), i12 (M, 2))`` with 0-based frame
indices, the contract of the JAX package's ``extract_match``. Weights:
MagicLeap's ``superpoint_v1.pth`` and ``superglue_{outdoor,indoor}.pth``
from ``weights_dir`` (loaded strictly, no conversion), or modules passed in.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from posediffusion_tpu_torch.matching.ransac import PLANAR_OR_PANORAMIC, verify_two_view
from posediffusion_tpu_torch.matching.superglue import SuperGlue, encode_keypoints
from posediffusion_tpu_torch.matching.superpoint import SuperPointNet, detect_keypoints_batched
from posediffusion_tpu_torch.ops.superglue_kernel import (
    fused_match_pairs,
    stack_superglue_params,
)

_GRAY_W = np.array([0.299, 0.587, 0.114], dtype=np.float32)
SUPERPOINT_FILES = ("superpoint_v1.pth",)
SUPERGLUE_FILES = ("superglue_outdoor.pth", "superglue_indoor.pth")

# Frames per SuperPoint forward: the first conv's output alone is
# F x 64 x H x W float32 (520 MB per 1896 x 1072 frame), so a group of
# large frames runs in sub-batches of at most this much of it.
DETECT_ACT_BYTES = 8 * 1024**3
# Pair-chunk memory on the CPU (on a card: a quarter of the free memory).
CPU_MATCH_BYTES = 1024**3


def load_matcher_weights(weights_dir: str, device="cpu") -> Tuple[SuperPointNet, SuperGlue]:
    """Strict load of MagicLeap checkpoints from a directory."""

    def load(module, names):
        for name in names:
            path = os.path.join(weights_dir, name)
            if os.path.isfile(path):
                # a plain dict: BatchNorms then accept files with or without
                # num_batches_tracked
                module.load_state_dict(
                    dict(torch.load(path, map_location="cpu", weights_only=True)),
                    strict=True)
                return module.eval().to(device)
        raise FileNotFoundError(f"none of {names} in {weights_dir}")

    return load(SuperPointNet(), SUPERPOINT_FILES), load(SuperGlue(), SUPERGLUE_FILES)


def load_grays(image_paths: Sequence[str]):
    """Grayscale [0, 1] frames padded to a multiple of 8 (the 65-cell head
    tiles exactly), and their padded (h, w)."""
    from posediffusion_tpu_torch.data.images import load_image_chw

    grays, sizes = [], []
    for path in image_paths:
        gray = np.tensordot(_GRAY_W, load_image_chw(path), axes=(0, 0))
        h, w = gray.shape
        gray = np.pad(gray, ((0, (-h) % 8), (0, (-w) % 8)))
        grays.append(gray)
        sizes.append(gray.shape)
    return grays, sizes


def detect_frames(superpoint: SuperPointNet, grays, max_keypoints: int = 4096,
                  nms_radius: int = 4) -> List[tuple]:
    """SuperPoint on every frame, one forward per same-size group (in
    sub-batches of ``DETECT_ACT_BYTES``): per frame (kpts (K, 2), scores
    (K,), desc (K, 256), valid (K,)) on the detector's device."""
    device = next(superpoint.parameters()).device
    feats: list = [None] * len(grays)
    by_shape: Dict[Tuple[int, int], list] = {}
    for i, g in enumerate(grays):
        by_shape.setdefault(g.shape, []).append(i)
    for (h, w), idxs in by_shape.items():
        per_call = max(1, DETECT_ACT_BYTES // (64 * h * w * 4))
        for g0 in range(0, len(idxs), per_call):
            sub = idxs[g0:g0 + per_call]
            stack = torch.as_tensor(np.stack([grays[i] for i in sub]), device=device)
            out = detect_keypoints_batched(superpoint, stack[:, None], max_keypoints,
                                           nms_radius)
            for j, i in enumerate(sub):
                feats[i] = tuple(a[j] for a in out)
    return feats


def _pairs_per_chunk(K: int, cap: int, device: torch.device) -> int:
    """Pairs per fused_match_pairs call by memory: the coupling and the log
    assignment ((K + 1)^2 floats each) and ~14 D-wide float activations of
    the 2K tokens of each pair."""
    per_pair = 2 * (K + 1) ** 2 * 4 + 2 * K * 14 * 256 * 4
    budget = (torch.cuda.mem_get_info(device)[0] // 4 if device.type == "cuda"
              else CPU_MATCH_BYTES)
    return int(max(1, min(cap, budget // per_pair)))


def stack_feats(feats):
    """Per-frame features -> (kpts, scores, desc, valid) stacked over frames,
    frames with fewer keypoints (smaller than max_keypoints pixels) padded
    with invalid ones, then trimmed to the densest frame's valid count
    rounded up to 128 (top-k is score-sorted, so the trim drops only
    invalid entries)."""
    K_full = max(f[0].shape[0] for f in feats)

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 1) + (0, K_full - a.shape[0]))

    kpts, scores, desc, valid = (torch.stack([pad(f[i]) for f in feats]) for i in range(4))
    k_max = int(valid.sum(1).max())
    K_eff = min(K_full, max(128, ((max(k_max, 1) + 127) // 128) * 128))
    return kpts[:, :K_eff], scores[:, :K_eff], desc[:, :K_eff], valid[:, :K_eff]


def match_all_pairs(superglue: SuperGlue, feats, sizes, pairs, sinkhorn_iterations: int = 50,
                    match_threshold: float = 0.2, pair_chunk: int = 32):
    """SuperGlue over every pair, in chunks of pairs: -> (kpts (F, K, 2)
    host array, matches0 (P, K) host int32 array, -1 where unmatched)."""
    kpts, scores, desc, valid = stack_feats(feats)
    device = kpts.device
    hw = torch.as_tensor(np.asarray(sizes, np.float32), device=device)
    x = encode_keypoints(superglue, desc, kpts, scores, hw)
    stacks = stack_superglue_params(superglue)
    a_idx = torch.as_tensor([p[0] for p in pairs], device=device)
    b_idx = torch.as_tensor([p[1] for p in pairs], device=device)
    chunk = _pairs_per_chunk(x.shape[1], pair_chunk, device)
    out = []
    for i0 in range(0, len(pairs), chunk):
        sa, sb = a_idx[i0:i0 + chunk], b_idx[i0:i0 + chunk]
        matches, _ = fused_match_pairs(
            torch.stack([x[sa], x[sb]], 1), valid[sa], valid[sb], stacks,
            sinkhorn_iters=sinkhorn_iterations, match_threshold=match_threshold)
        out.append(matches)
    return kpts.cpu().numpy(), torch.cat(out).cpu().numpy()


def verify_pairs(kpts_np, all_matches, pairs, n_frames: int, ransac_threshold_px: float = 4.0,
                 min_pair_matches: int = 8, keep_planar: bool = True):
    """COLMAP-style two-view verification of every pair's matches (seed
    a * n + b): lists of the kept pairs' inlier keypoints and frame pairs."""
    kp1_all, kp2_all, i12_all = [], [], []
    for pi, (a, b) in enumerate(pairs):
        matches0 = all_matches[pi]
        sel = matches0 >= 0
        if sel.sum() < min_pair_matches:
            continue
        p0 = kpts_np[a][sel]
        p1 = kpts_np[b][matches0[sel]]
        res = verify_two_view(p0, p1, max_error_px=ransac_threshold_px,
                              min_num_inliers=min_pair_matches, seed=a * n_frames + b)
        count = res["num_inliers"]
        if count < min_pair_matches:
            continue
        if res["config"] == PLANAR_OR_PANORAMIC and not keep_planar:
            continue
        mask = res["inlier_mask"]
        kp1_all.append(p0[mask])
        kp2_all.append(p1[mask])
        i12_all.append(np.repeat([[a, b]], count, axis=0))
    return kp1_all, kp2_all, i12_all


def extract_match(
    image_paths: Optional[Sequence[str]] = None,
    image_folder_path: Optional[str] = None,
    image_info: Optional[Dict] = None,
    weights_dir: Optional[str] = None,
    weights: Optional[Tuple[SuperPointNet, SuperGlue]] = None,
    max_keypoints: int = 4096,
    nms_radius: int = 4,
    sinkhorn_iterations: int = 50,
    match_threshold: float = 0.2,
    ransac_threshold_px: float = 4.0,
    min_pair_matches: int = 8,
    pair_chunk: int = 32,
    keep_planar: bool = True,
    device=None,
):
    """Verified matches across all frame pairs: (kp1, kp2, i12) in the
    cropped, rescaled pixel frame when ``image_info`` is given (else in
    original pixels), or (None,) * 3 when nothing verifies.

    ``max_keypoints`` defaults to 4096 per image (hloc's ``superpoint_inloc``
    configuration, which the reference uses). ``weights`` are modules (they
    are moved to ``device``); ``device`` defaults to the card, where
    SuperPoint runs on cuDNN and SuperGlue on the kernels (``"cpu"`` runs
    the plain routes)."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if weights is not None:
        superpoint, superglue = (w.eval().to(device) for w in weights)
    elif weights_dir:
        superpoint, superglue = load_matcher_weights(weights_dir, device)
    else:
        raise ValueError("no matcher weights (set GGS.matcher_ckpt_dir)")

    if image_paths is None:
        from posediffusion_tpu_torch.data.images import IMAGE_EXTENSIONS

        image_paths = sorted(
            os.path.join(image_folder_path, f) for f in os.listdir(image_folder_path)
            if f.lower().endswith(IMAGE_EXTENSIONS))

    grays, sizes = load_grays(image_paths)
    n = len(grays)
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    if not pairs:
        return None, None, None
    feats = detect_frames(superpoint, grays, max_keypoints, nms_radius)
    kpts_np, all_matches = match_all_pairs(superglue, feats, sizes, pairs,
                                           sinkhorn_iterations, match_threshold, pair_chunk)
    kp1_all, kp2_all, i12_all = verify_pairs(kpts_np, all_matches, pairs, n,
                                             ransac_threshold_px, min_pair_matches,
                                             keep_planar)
    if not kp1_all:
        return None, None, None

    kp1 = np.concatenate(kp1_all).astype(np.float32)
    kp2 = np.concatenate(kp2_all).astype(np.float32)
    i12 = np.concatenate(i12_all)
    if image_info is not None:
        bbox = np.asarray(image_info["bboxes_xyxy"])
        scale = np.asarray(image_info["resized_scales"])
        # original-image pixels -> the cropped, rescaled frame
        kp1 = (kp1 - bbox[i12[:, 0], :2]) * scale[i12[:, 0], None]
        kp2 = (kp2 - bbox[i12[:, 1], :2]) * scale[i12[:, 1], None]
    return kp1, kp2, i12
