"""NumPy twins of the camera geometry used on the host data path.

The datasets adjust intrinsics for crops/resizes and normalize GT cameras
per sequence (reference: datasets/co3d_v2.py:277-353 via
util/camera_transform.py + util/normalize_cameras.py).  Running that through
jnp would bounce every data-loader item off the accelerator, so the host
path uses these numpy twins; tests pin them against the jnp geometry core.

Conventions identical to posediffusion_tpu.geometry: row-vector
world-to-view extrinsics, NDC intrinsics, wxyz quaternions.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- intrinsics


def ndc_to_pixel_intrinsics(fl, pp, image_size_wh):
    half = np.asarray(image_size_wh, np.float64) / 2.0
    rescale = half.min(axis=-1, keepdims=half.ndim > 1)
    return np.asarray(fl) * rescale, half - np.asarray(pp) * rescale


def pixel_to_ndc_intrinsics(fl_px, pp_px, image_size_wh):
    half = np.asarray(image_size_wh, np.float64) / 2.0
    rescale = half.min(axis=-1, keepdims=half.ndim > 1)
    return np.asarray(fl_px) / rescale, (half - np.asarray(pp_px)) / rescale


def adjust_intrinsics_to_bbox_crop(fl, pp, image_size_wh, bbox_xywh):
    bbox_xywh = np.asarray(bbox_xywh, np.float64)
    fl_px, pp_px = ndc_to_pixel_intrinsics(fl, pp, image_size_wh)
    return pixel_to_ndc_intrinsics(fl_px, pp_px - bbox_xywh[..., :2], bbox_xywh[..., 2:])


def adjust_intrinsics_to_image_scale(fl, pp, original_size_wh, new_size_wh):
    original = np.asarray(original_size_wh, np.float64)
    new = np.asarray(new_size_wh, np.float64)
    fl_px, pp_px = ndc_to_pixel_intrinsics(fl, pp, original)
    scale = (new / original).min(axis=-1, keepdims=new.ndim > 1)
    return pixel_to_ndc_intrinsics(fl_px * scale, pp_px * scale, new)


def bbox_xyxy_to_xywh(xyxy: np.ndarray) -> np.ndarray:
    xyxy = np.asarray(xyxy)
    return np.concatenate([xyxy[:2], xyxy[2:] - xyxy[:2]])


# --------------------------------------------------------------- quaternions


def matrix_to_quaternion(matrix: np.ndarray) -> np.ndarray:
    """NumPy twin of geometry.quaternions.matrix_to_quaternion (wxyz)."""
    m = np.asarray(matrix, np.float64)
    batch = m.shape[:-2]
    f = m.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = (f[..., i] for i in range(9))
    q_abs = np.sqrt(
        np.maximum(
            np.stack(
                [
                    1.0 + m00 + m11 + m22,
                    1.0 + m00 - m11 - m22,
                    1.0 - m00 + m11 - m22,
                    1.0 - m00 - m11 + m22,
                ],
                axis=-1,
            ),
            0.0,
        )
    )
    cand = np.stack(
        [
            np.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            np.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            np.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            np.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        axis=-2,
    ) / (2.0 * np.maximum(q_abs[..., None], 0.1))
    best = np.argmax(q_abs, axis=-1)
    return np.take_along_axis(cand, best[..., None, None].astype(np.int64), axis=-2)[
        ..., 0, :
    ]


# ------------------------------------------------------------- normalization


def camera_centers(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    return -np.einsum("nj,nkj->nk", T, R)


def optical_axes(R, T, fl, pp):
    """Per-camera (center, direction) of the optical axis (twin of
    geometry.cameras.optical_axes)."""
    centers = camera_centers(R, T)
    # unproject (pp, depth=1): view point is (0, 0, 1)
    view = np.concatenate([np.zeros_like(pp[..., :1]), np.zeros_like(pp[..., :1]),
                           np.ones_like(pp[..., :1])], axis=-1)
    points = np.einsum("nj,nkj->nk", view - T, R)
    return centers, points - centers


def intersect_skew_lines(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    dim = p.shape[-1]
    r = r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    eye = np.eye(dim)
    proj = eye[None] - r[:, :, None] * r[:, None, :]
    rhs = np.einsum("nij,nj->i", proj, p)
    lhs = proj.sum(axis=0)
    sol, *_ = np.linalg.lstsq(lhs, rhs, rcond=None)
    return sol


def first_camera_transform(R, T):
    R0_t = R[0].T
    new_R = np.einsum("ij,njk->nik", R0_t, R)
    new_T = T - np.einsum("j,njk->nk", T[0], new_R)
    return new_R, new_T


def normalize_cameras(
    R, T, fl, pp, compute_optical=True, first_camera=True, normalize_T=False
):
    """Twin of geometry.normalize.normalize_cameras on numpy arrays.

    Returns (R, T) — intrinsics are unchanged by normalization.
    """
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    if compute_optical:
        centers, dirs = optical_axes(R, T, fl, pp)
        p_intersect = intersect_skew_lines(centers, dirs)
        scale = np.linalg.norm(p_intersect - centers[0])
        if not np.isfinite(p_intersect).all():
            raise ValueError("optical-axis intersection is NaN")
        if scale == 0:
            T = T / np.sqrt(np.linalg.norm(T))
        else:
            T = (T + np.einsum("j,njk->nk", p_intersect, R)) / scale
    else:
        T = T / np.sqrt(np.linalg.norm(T))

    if first_camera:
        R, T = first_camera_transform(R, T)

    if normalize_T:
        t = T[1:]
        scale = np.linalg.norm(t) / np.sqrt(len(t))
        scale = np.clip(scale / 2.0, 0.01, 100.0)
        T = T / scale

    return R.astype(np.float32), T.astype(np.float32)
