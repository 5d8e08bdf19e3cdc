"""Image resizing with the torch ``F.interpolate`` conventions the reference
pipeline uses (bilinear ``align_corners=False``, legacy nearest, bicubic),
on the trailing (H, W) dims of NCHW-like tensors."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _as4d(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    lead = x.shape[:-2]
    return x.reshape(-1, 1, *x.shape[-2:]), lead


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode='bilinear', align_corners=False)``,
    computed in f32 and cast back to x's dtype."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    y, lead = _as4d(x.float())
    y = F.interpolate(y, size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, *y.shape[-2:]).to(x.dtype)


def _antialias_weights(in_size: int, out_size: int,
                       device: torch.device) -> torch.Tensor:
    """(out, in) matrix of the antialiased bilinear resize (PIL's triangle
    filter, as ``F.interpolate(antialias=True)`` on the CPU and JAX's
    ``jax.image.resize(method='linear', antialias=True)`` compute it):
    output i centred on ``scale * (i + 0.5)``, ``scale = in / out``, the
    triangle widened by ``scale`` on a downscale, each row normalised; in
    f32, as torch's CPU kernel takes them, so that the card gives the CPU's
    weights (torch's CUDA kernel rounds its centres otherwise: 1e-4 apart
    at 800-pixel sides).  ``scale`` and its inverse are IEEE f32 quotients
    taken on the host: CUDA divides a tensor by a scalar through the
    scalar's reciprocal."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = np.float32(in_size) / np.float32(out_size)
    inv = float(np.float32(1.0) / scale) if in_size >= out_size else 1.0
    center = (torch.arange(out_size, **f32) + 0.5) * float(scale)
    j = torch.arange(in_size, **f32)
    w = (1.0 - (((j[None] - center[:, None]) + 0.5) * inv).abs()).clamp(
        min=0.0)
    return w / w.sum(dim=1, keepdim=True)


def resize_bilinear_antialias(x: torch.Tensor,
                              size: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode='bilinear', align_corners=False,
    antialias=True)`` (JAX's ``jax.image.resize(method='linear',
    antialias=True)``) as two weight-matrix products, computed in f32 and
    cast back; the input itself when the size already matches."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    h_in, w_in = x.shape[-2:]
    wr = _antialias_weights(h_in, int(size[0]), x.device)
    wc = _antialias_weights(w_in, int(size[1]), x.device)
    y = torch.einsum("...hw,jw->...hj", x.float(), wc)
    y = torch.einsum("...hj,ih->...ij", y, wr)
    return y.to(x.dtype)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(x, size, mode='nearest')`` (torch's legacy
    ``src = floor(dst * in/out)`` mapping), any dtype."""
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == tuple(size):
        return x
    rows = torch.as_tensor(_nearest_src_np(h_in, int(size[0])),
                           device=x.device)
    cols = torch.as_tensor(_nearest_src_np(w_in, int(size[1])),
                           device=x.device)
    return x[..., rows, :][..., :, cols]


def resize_bicubic_torch(x: torch.Tensor, size: tuple[int, int],
                         scales: tuple[float, float] | None = None,
                         antialias: bool = False) -> torch.Tensor:
    """``F.interpolate(mode='bicubic')`` of the trailing (H, W) dims.

    ``scales`` are torch coordinate scales (in/out-like) per axis: given,
    they reproduce the ``scale_factor=`` call mode, where the given factor
    and not out/in drives the source mapping (DINOv2's
    ``interpolate_offset``); None is size mode.
    """
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    y, lead = _as4d(x.float())
    if scales is None:
        y = F.interpolate(y, size=tuple(size), mode="bicubic",
                          align_corners=False, antialias=antialias)
    else:
        y = F.interpolate(y, scale_factor=(1.0 / scales[0], 1.0 / scales[1]),
                          mode="bicubic", align_corners=False,
                          antialias=antialias)
        if tuple(y.shape[-2:]) != tuple(size):
            raise ValueError(f"scales {scales} give {tuple(y.shape[-2:])}, "
                             f"not {tuple(size)}")
    return y.reshape(*lead, *y.shape[-2:]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _linear_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) bilinear matrix, ``align_corners=False``: half-pixel
    source ``src = (i+0.5)*in/out - 0.5`` in f32 like torch, border-clamped,
    at most two taps per row."""
    i = np.arange(out_size, dtype=np.float32)
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.maximum(scale * (i + np.float32(0.5)) - np.float32(0.5), 0)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    rows = np.arange(out_size)
    w = np.zeros((out_size, in_size), np.float32)
    np.add.at(w, (rows, np.clip(lo, 0, in_size - 1)), 1.0 - frac)
    np.add.at(w, (rows, np.clip(lo + 1, 0, in_size - 1)), frac)
    return w


def _nearest_src_np(in_size: int, out_size: int) -> np.ndarray:
    """Legacy-nearest source index per output index, with f32 arithmetic
    (near-integer products floor differently than in f64)."""
    src = np.floor(np.arange(out_size, dtype=np.float32)
                   * np.float32(in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


def resize_bilinear_then_nearest(x: torch.Tensor, mid: tuple[int, int],
                                 size: tuple[int, int]) -> torch.Tensor:
    """``resize_nearest(resize_bilinear(x, mid), size)`` without the
    ``mid``-sized intermediate: nearest is a row/column selection, so the
    composition is the bilinear weight matrices with their rows selected at
    the nearest source indices (same taps and weights; f32)."""
    if tuple(mid) == tuple(size):
        return resize_bilinear(x, size)
    h_in, w_in = x.shape[-2:]
    wr = _linear_weights_np(h_in, int(mid[0]))[
        _nearest_src_np(int(mid[0]), int(size[0]))]
    wc = _linear_weights_np(w_in, int(mid[1]))[
        _nearest_src_np(int(mid[1]), int(size[1]))]
    wr = torch.as_tensor(wr, device=x.device)
    wc = torch.as_tensor(wc, device=x.device)
    y = torch.einsum("...hw,jw->...hj", x.float(), wc)
    y = torch.einsum("...hj,ih->...ij", y, wr)
    return y.to(x.dtype)
