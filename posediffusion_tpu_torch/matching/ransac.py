"""ctypes binding of the native two-view RANSAC verifier, as
``posediffusion_tpu.matching.ransac``.

The C++ source is the port's own copy of the JAX package's verifier,
``posediffusion_tpu_torch/matching/csrc/ransac.cpp`` (a test holds the two
files equal). It is compiled with ``g++`` at first use into ``build/ransac/`` (keyed by a hash
of the source and the flags, like the CUDA kernels in ``build/kernels/``).
The JAX binding is not imported: ``posediffusion_tpu.matching`` imports JAX
and Flax in its ``__init__``.

Host-side code: RANSAC verification runs on the CPU in both packages, after
one transfer of every pair's matches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parent / "csrc" / "ransac.cpp"
_BUILD_DIR = _ROOT / "build" / "ransac"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# COLMAP TwoViewGeometry::ConfigurationType values emitted by the verifier.
DEGENERATE = 1
CALIBRATED = 2
UNCALIBRATED = 3
PLANAR_OR_PANORAMIC = 6

CONFIG_NAMES = {
    DEGENERATE: "degenerate",
    CALIBRATED: "calibrated",
    UNCALIBRATED: "uncalibrated",
    PLANAR_OR_PANORAMIC: "planar_or_panoramic",
}

_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    # kp1, kp2, n, threshold, max_iters, confidence, seed, F_out, inlier_mask
    "ransac_fundamental": [_FP, _FP, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           ctypes.c_double, ctypes.c_uint64, _DP, _U8P],
    # kp1, kp2, n, K1, K2, max_error_px, max_iters, confidence,
    # min_num_inliers, seed, F_out, H_out, E_out, inlier_mask, config_out
    "verify_two_view": [_FP, _FP, ctypes.c_int, _DP, _DP, ctypes.c_float,
                        ctypes.c_int, ctypes.c_double, ctypes.c_int,
                        ctypes.c_uint64, _DP, _DP, _DP, _U8P,
                        ctypes.POINTER(ctypes.c_int)],
}


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _BUILD_DIR / f"libransac_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        tmp = os.path.join(tmpdir, path.name)
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _f32(kp1, kp2):
    kp1 = np.ascontiguousarray(kp1, np.float32)
    kp2 = np.ascontiguousarray(kp2, np.float32)
    if len(kp1) != len(kp2):
        raise ValueError("kp1/kp2 length mismatch")
    return kp1, kp2


def verify_matches(
    kp1: np.ndarray,
    kp2: np.ndarray,
    threshold_px: float = 4.0,
    max_iters: int = 10000,
    confidence: float = 0.9999,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """RANSAC fundamental-matrix fit of (N, 2) pixel correspondences.
    Returns (inlier_mask (N,) bool, F (3, 3) with p2^T F p1 = 0, count)."""
    kp1, kp2 = _f32(kp1, kp2)
    n = len(kp1)
    F = np.zeros(9, np.float64)
    mask = np.zeros(n, np.uint8)
    if n == 0:
        return mask.astype(bool), F.reshape(3, 3), 0
    count = load_library().ransac_fundamental(
        kp1.ctypes.data_as(_FP), kp2.ctypes.data_as(_FP), n,
        threshold_px**2, max_iters, confidence, seed,
        F.ctypes.data_as(_DP), mask.ctypes.data_as(_U8P))
    return mask.astype(bool), F.reshape(3, 3), int(count)


def verify_two_view(
    kp1: np.ndarray,
    kp2: np.ndarray,
    K1: np.ndarray = None,
    K2: np.ndarray = None,
    max_error_px: float = 4.0,
    max_iters: int = 10000,
    confidence: float = 0.9999,
    min_num_inliers: int = 15,
    seed: int = 0,
) -> dict:
    """COLMAP-style two-view verification with model selection (F, H, and E
    when both intrinsics are given). Returns ``inlier_mask`` (N,) bool of the
    selected model, ``num_inliers``, ``config`` (COLMAP enum value),
    ``config_name`` and the fitted ``F``, ``H``, ``E`` (3, 3)."""
    kp1, kp2 = _f32(kp1, kp2)
    n = len(kp1)
    if (K1 is None) != (K2 is None):
        raise ValueError("pass both intrinsics or neither")
    F, H, E = (np.zeros(9, np.float64) for _ in range(3))
    mask = np.zeros(max(n, 1), np.uint8)
    config = ctypes.c_int(DEGENERATE)
    count = 0
    if n > 0:
        if K1 is not None:
            K1 = np.ascontiguousarray(K1, np.float64)
            K2 = np.ascontiguousarray(K2, np.float64)
        count = load_library().verify_two_view(
            kp1.ctypes.data_as(_FP), kp2.ctypes.data_as(_FP), n,
            None if K1 is None else K1.ctypes.data_as(_DP),
            None if K2 is None else K2.ctypes.data_as(_DP),
            max_error_px, max_iters, confidence, min_num_inliers, seed,
            F.ctypes.data_as(_DP), H.ctypes.data_as(_DP), E.ctypes.data_as(_DP),
            mask.ctypes.data_as(_U8P), ctypes.byref(config))
    return {
        "inlier_mask": mask[:n].astype(bool),
        "num_inliers": int(count),
        "config": int(config.value),
        "config_name": CONFIG_NAMES[int(config.value)],
        "F": F.reshape(3, 3),
        "H": H.reshape(3, 3),
        "E": E.reshape(3, 3),
    }
