"""Torch-free color augmentation (host side).

Replaces the reference's torchvision transform stack
(reference: datasets/co3d_v2.py:169-181, re10k.py:120-131): random-apply
color jitter (brightness/contrast/saturation/hue), random grayscale, random
erasing, and (Re10K) Gaussian blur.  Operates on float32 (3, H, W) arrays in
[0, 1]; randomness comes from a ``numpy.random.Generator`` so the pipeline
is seedable per worker.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_GRAY_W = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(factor * a + (1.0 - factor) * b, 0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img, factor):
    mean = (_GRAY_W @ img.reshape(3, -1)).mean(dtype=np.float64).astype(np.float32)
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img, factor):
    gray = np.tensordot(_GRAY_W, img, axes=(0, 0))[None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def adjust_hue(img, delta):
    """Shift hue by delta (in turns, [-0.5, 0.5]) via HSV round trip."""
    r, g, b = img[0], img[1], img[2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    diff = maxc - minc
    s = np.where(maxc > 0, diff / np.maximum(maxc, 1e-12), 0.0)
    safe = np.where(diff > 0, diff, 1.0)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + delta) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2]).astype(img.dtype)


def gaussian_blur(img, sigma: float, ksize: int = 5):
    x = np.arange(ksize) - ksize // 2
    kernel = np.exp(-(x**2) / (2 * sigma**2))
    kernel /= kernel.sum()
    pad = ksize // 2
    out = np.pad(img, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    out = np.apply_along_axis(lambda m: np.convolve(m, kernel, mode="valid"), 1, out)
    out = np.pad(out, ((0, 0), (0, 0), (pad, pad)), mode="reflect")
    out = np.apply_along_axis(lambda m: np.convolve(m, kernel, mode="valid"), 2, out)
    return out.astype(img.dtype)


@dataclasses.dataclass
class ColorJitter:
    """Reference Co3D recipe: jitter w.p. 0.65 (b 0.4, c 0.4, s 0.2, h 0.1),
    grayscale w.p. 0.15 (datasets/co3d_v2.py:169-177)."""

    apply_p: float = 0.65
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.2
    hue: float = 0.1
    grayscale_p: float = 0.15
    blur_p: float = 0.0
    blur_sigma: Tuple[float, float] = (0.1, 1.0)

    def sample_params(self, rng: np.random.Generator) -> dict:
        """Draw one set of augmentation parameters (torchvision ColorJitter
        samples once per call, so one draw covers a whole image stack)."""
        return {
            "apply": rng.uniform() < self.apply_p,
            "order": rng.permutation(4),
            "brightness": rng.uniform(1 - self.brightness, 1 + self.brightness),
            "contrast": rng.uniform(1 - self.contrast, 1 + self.contrast),
            "saturation": rng.uniform(1 - self.saturation, 1 + self.saturation),
            "hue": rng.uniform(-self.hue, self.hue),
            "grayscale": rng.uniform() < self.grayscale_p,
            "blur": bool(self.blur_p) and rng.uniform() < self.blur_p,
            "blur_sigma": rng.uniform(*self.blur_sigma),
        }

    def apply(self, img: np.ndarray, p: dict) -> np.ndarray:
        """Apply previously sampled parameters to one (3, H, W) image."""
        if p["apply"]:
            ops = [
                lambda im: adjust_brightness(im, p["brightness"]),
                lambda im: adjust_contrast(im, p["contrast"]),
                lambda im: adjust_saturation(im, p["saturation"]),
                lambda im: adjust_hue(im, p["hue"]),
            ]
            for idx in p["order"]:
                img = ops[idx](img)
        if p["grayscale"]:
            gray = np.tensordot(_GRAY_W, img, axes=(0, 0))
            img = np.broadcast_to(gray[None], img.shape).copy()
        if p["blur"]:
            img = gaussian_blur(img, p["blur_sigma"])
        return img

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return self.apply(img, self.sample_params(rng))


RE10K_COLOR_JITTER = ColorJitter(
    apply_p=0.75, brightness=0.3, contrast=0.4, saturation=0.2, hue=0.1,
    grayscale_p=0.05, blur_p=0.05,
)


@dataclasses.dataclass
class RandomErase:
    """Reference erase aug (off by default, datasets/co3d_v2.py:178-181)."""

    p: float = 0.1
    scale: Tuple[float, float] = (0.02, 0.33)
    ratio: Tuple[float, float] = (0.3, 3.3)

    def sample_region(self, hw: Tuple[int, int], rng: np.random.Generator):
        """One erase rectangle for an (h, w) image, or None (degenerate)."""
        h, w = hw
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self.scale) * area
            aspect = np.exp(rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                return top, left, eh, ew
        return None

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rng.uniform() >= self.p:
            return img
        return self.apply_once(img, rng)

    def apply_once(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Erase unconditionally (the caller handles the probability gate —
        the reference's Re10K loop flips its own 0.15 coin, re10k.py:383)."""
        region = self.sample_region(img.shape[1:], rng)
        if region is None:
            return img
        top, left, eh, ew = region
        img = img.copy()
        img[:, top : top + eh, left : left + ew] = 0.0
        return img

    def erase_batch(self, imgs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """One p-flip and one shared region for a whole (N, 3, H, W) stack
        (torchvision RandomErasing on the stacked tensor, co3d_v2.py:368)."""
        if rng.uniform() >= self.p:
            return imgs
        region = self.sample_region(imgs.shape[2:], rng)
        if region is None:
            return imgs
        top, left, eh, ew = region
        imgs = imgs.copy()
        imgs[:, :, top : top + eh, left : left + ew] = 0.0
        return imgs
