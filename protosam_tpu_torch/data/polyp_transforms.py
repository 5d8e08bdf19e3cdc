"""Paired (image, mask) augmentations for the polyp datasets (JAX
``data/polyp_transforms.py``; reference dataloaders/PolypTransforms.py
:43-612, ``get_polyp_transform`` :590-612).

Every transform takes and returns (image (H, W, 3) float, mask (H, W)
float), draws from ``np.random`` or the ``rng`` given, in JAX's order, so
one seed gives JAX's draws.  What JAX asks of cv2 is numpy here, bit for
bit against cv2 5.0:

  * ``rgb_to_hsv``: ``COLOR_RGB2HSV`` of uint8, OpenCV's fixed point
    (shift 12: ``sdiv[v] = round((255 << 12) / v)``, ``hdiv[d] =
    round((180 << 12) / (6 d))``, both products rounded by + 2048 >> 12);
  * ``hsv_to_rgb``: ``COLOR_HSV2RGB`` of uint8, in float32: s and v times
    ``1/255``, h times ``6/180``, its sector and fraction, the sector
    table ``v``, ``v (1 - s)``, ``v fma(-s, f, 1)``, ``v fma(-s, 1 - f,
    1)``, each times 255, truncated in a row's blocks of 32 pixels and
    rounded to the nearest (ties to even) in its tail;
  * the affine pair: ``cv2.getRotationMatrix2D`` and ``cv2.warpAffine``
    (bilinear image, nearest mask), ``data/transforms.py``.
"""

from __future__ import annotations

import numpy as np

from protosam_tpu_torch.data.prepare import _fma32
from protosam_tpu_torch.data.transforms import (rotation_matrix_2d,
                                                warp_affine)

_HSV_SHIFT = 12
# (b, g, r) <- table index, per sector of the hue circle
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of (H, W, 3) uint8."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    d = v - np.minimum(np.minimum(r, g), b)
    n = np.arange(1, 256)
    sdiv = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / n)])
    hdiv = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6 * n))])
    half = 1 << (_HSV_SHIFT - 1)
    s = (d * sdiv.astype(np.int64)[v] + half) >> _HSV_SHIFT
    hp = np.where(v == r, g - b, np.where(v == g, b - r + 2 * d,
                                          r - g + 4 * d))
    h = (hp * hdiv.astype(np.int64)[d] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of (H, W, 3) uint8."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * (f32(6) / f32(180))
    s = hsv[..., 1].astype(f32) * f32(1 / 255)
    v = hsv[..., 2].astype(f32) * f32(1 / 255)
    sector = np.floor(h)
    frac = h - sector
    one = np.ones_like(s)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, frac, one),
                    v * _fma32(-s, one - frac, one)], axis=-1)
    bgr = np.take_along_axis(
        tab, _SECTORS[sector.astype(np.int64) % 6], axis=-1)[..., ::-1]
    x = bgr * f32(255)
    # each row's vector blocks of 32 pixels truncate; its tail rounds
    simd = np.arange(hsv.shape[-2]) < hsv.shape[-2] // 32 * 32
    return np.where(simd[:, None], np.trunc(x), np.rint(x)).astype(np.uint8)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, mask):
        for t in self.transforms:
            img, mask = t(img, mask)
        return img, mask


class RandomHorizontalFlip:
    def __init__(self, p=0.5, rng=None):
        self.p, self.rng = p, rng or np.random

    def __call__(self, img, mask):
        if self.rng.random() < self.p:
            return img[:, ::-1].copy(), mask[:, ::-1].copy()
        return img, mask


class RandomVerticalFlip:
    def __init__(self, p=0.5, rng=None):
        self.p, self.rng = p, rng or np.random

    def __call__(self, img, mask):
        if self.rng.random() < self.p:
            return img[::-1].copy(), mask[::-1].copy()
        return img, mask


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter on float RGB in [0, 255]."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4,
                 hue=0.1, rng=None):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.rng = rng or np.random

    def __call__(self, img, mask):
        img = img.astype(np.float32)
        if self.b:
            img = img * self.rng.uniform(1 - self.b, 1 + self.b)
        if self.c:
            mean = img.mean()
            img = (img - mean) * self.rng.uniform(1 - self.c, 1 + self.c) + mean
        if self.s:
            gray = img.mean(axis=-1, keepdims=True)
            img = (img - gray) * self.rng.uniform(1 - self.s, 1 + self.s) + gray
        if self.h:
            hsv = rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8)
                             ).astype(np.float32)
            hsv[..., 0] = (hsv[..., 0] +
                           self.rng.uniform(-self.h, self.h) * 180) % 180
            img = hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32)
        return np.clip(img, 0, 255), mask


class RandomAffinePair:
    def __init__(self, degrees=90, translate=(0.1, 0.1), scale=(0.75, 1.25),
                 rng=None):
        self.degrees, self.translate, self.scale = degrees, translate, scale
        self.rng = rng or np.random

    def __call__(self, img, mask):
        h, w = img.shape[:2]
        ang = self.rng.uniform(-self.degrees, self.degrees)
        sc = self.rng.uniform(*self.scale)
        tx = self.rng.uniform(-self.translate[0], self.translate[0]) * w
        ty = self.rng.uniform(-self.translate[1], self.translate[1]) * h
        m = rotation_matrix_2d((w / 2, h / 2), ang, sc)
        m[:, 2] += (tx, ty)
        img = warp_affine(img, m)
        mask = warp_affine(np.asarray(mask)[..., None], m, nearest=True)
        return img, mask[..., 0]


def get_polyp_transform(rng=None):
    """(train_transform, test_transform) — reference
    PolypTransforms.get_polyp_transform :590-612."""
    train = Compose([
        ColorJitter(rng=rng),
        RandomVerticalFlip(rng=rng),
        RandomHorizontalFlip(rng=rng),
        RandomAffinePair(rng=rng),
    ])
    test = Compose([])
    return train, test
