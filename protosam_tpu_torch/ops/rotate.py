"""Rotation test-time augmentation (JAX ``ops/rotate.py``; reference
util/utils.py:40-83, torchvision ``F.rotate`` + an antialiased resize).

Centre rotation by inverse-mapped sampling: a 1-channel input takes
nearest sampling, others bilinear, zero outside the source.  The
coordinate grids are built with ``torch.arange`` on the input's device.
"""

from __future__ import annotations

import math

import torch

from protosam_tpu_torch.ops.resize import (resize_bilinear_antialias,
                                           resize_nearest)


def _expanded_size(h: int, w: int, degrees: float) -> tuple[int, int]:
    """Canvas size after expand=True rotation (torchvision corner-extent)."""
    t = math.radians(degrees)
    c, s = abs(math.cos(t)), abs(math.sin(t))
    return (int(math.ceil(h * c + w * s)), int(math.ceil(h * s + w * c)))


def _sample(x: torch.Tensor, degrees: float, oh: int, ow: int,
            mode: str) -> torch.Tensor:
    """The (oh, ow) canvas centred on x's centre, rotated counterclockwise
    by ``degrees``: each output pixel reads its inverse-rotated source."""
    h, w = x.shape[-2:]
    t = math.radians(degrees)
    cos, sin = math.cos(t), math.sin(t)
    yy = torch.arange(oh, dtype=torch.float32, device=x.device) - (oh - 1) / 2.0
    xx = torch.arange(ow, dtype=torch.float32, device=x.device) - (ow - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    sx = cos * gx - sin * gy + (w - 1) / 2.0
    sy = sin * gx + cos * gy + (h - 1) / 2.0
    if mode == "nearest":
        ix = torch.round(sx).long().clamp(0, w - 1)
        iy = torch.round(sy).long().clamp(0, h - 1)
        out = x[:, :, iy, ix]
    else:
        x0 = torch.floor(sx).long().clamp(0, w - 1)
        y0 = torch.floor(sy).long().clamp(0, h - 1)
        x1 = (x0 + 1).clamp(0, w - 1)
        y1 = (y0 + 1).clamp(0, h - 1)
        fx = (sx - x0).clamp(0.0, 1.0)
        fy = (sy - y0).clamp(0.0, 1.0)
        out = (x[:, :, y0, x0] * (1 - fx) * (1 - fy)
               + x[:, :, y0, x1] * fx * (1 - fy)
               + x[:, :, y1, x0] * (1 - fx) * fy
               + x[:, :, y1, x1] * fx * fy)
    inside = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))


def rotate_expand(x: torch.Tensor, degrees: float,
                  mode: str = "bilinear") -> torch.Tensor:
    """Rotate (B, C, H, W) counterclockwise by ``degrees`` on an expanded
    canvas (zero fill)."""
    oh, ow = _expanded_size(x.shape[-2], x.shape[-1], degrees)
    return _sample(x, degrees, oh, ow, mode)


def rotate_no_expand(x: torch.Tensor, degrees: float) -> torch.Tensor:
    """Centre rotation keeping the canvas (torchvision expand=False),
    bilinear."""
    return _sample(x, degrees, x.shape[-2], x.shape[-1], "bilinear")


def rotate_tensor_no_crop(image: torch.Tensor, degrees: float
                          ) -> tuple[torch.Tensor, tuple[int, int]]:
    """Reference util/utils.py:67-83: rotate with expand, then resize back
    to the input size (antialiased bilinear; nearest for 1 channel).
    Returns the result and the expanded canvas size."""
    if degrees == 0:
        return image, tuple(image.shape[-2:])
    h, w = image.shape[-2:]
    if image.shape[1] == 1:
        rot = rotate_expand(image, degrees, "nearest")
        resized = resize_nearest(rot, (h, w))
    else:
        rot = rotate_expand(image, degrees, "bilinear")
        resized = resize_bilinear_antialias(rot, (h, w))
    return resized, tuple(rot.shape[-2:])


def reverse_tensor(tensor: torch.Tensor, original_h: int, original_w: int,
                   degrees: float) -> torch.Tensor:
    """Reference util/utils.py:40-59: undo ``rotate_tensor_no_crop`` —
    resize to the expanded canvas, rotate back on that canvas, and crop the
    rotation padding.  The reference's crop quirk is kept: an odd size
    difference leaves a one-pixel mismatch, and no crop happens unless
    both sides differ."""
    h, w = tensor.shape[-2:]
    if (h, w) != (original_h, original_w):
        tensor = resize_bilinear_antialias(tensor, (original_h, original_w))
    rot = rotate_no_expand(tensor, degrees)
    h_rm = abs(h - original_h) // 2
    w_rm = abs(w - original_w) // 2
    if h_rm > 0 and w_rm > 0:
        rot = rot[:, :, h_rm:-h_rm, w_rm:-w_rm]
    return rot
