"""CLAHE without cv2: ``cv2.createCLAHE(clipLimit, tileGridSize).apply``
on uint8 slices, bit for bit, in numpy on the host (JAX runs cv2's on the
host too; the card's machine has no cv2).

OpenCV's arithmetic (``imgproc/src/clahe.cpp``, 8-bit path):

* when either side is not a multiple of its tile count, the histograms are
  taken over the image padded at the bottom and right by ``tiles - side %
  tiles`` (a whole tile where the side divides) with
  ``BORDER_REFLECT_101``; the blend runs over the original size;
* the clip limit is ``max(int(clip * tileArea / 256), 1)``; the clipped
  excess is spread as a batch to every bin, then one more to every
  ``max(256 // residual, 1)``-th bin for the residual;
* the LUT is ``saturate_cast<uchar>(cumsum * (255.f / tileArea))`` in
  float32, which rounds half to even;
* each pixel blends its four tile LUTs bilinearly in float32, with tile
  coordinates ``x * (1.f / tileWidth) - 0.5f``, and rounds half to even.
"""

from __future__ import annotations

import numpy as np

HIST = 256


def clahe(img: np.ndarray, clip_limit: float,
          tile_grid: tuple[int, int] = (7, 7)) -> np.ndarray:
    """CLAHE of a uint8 slice (H, W) or stack (..., H, W), each slice on its
    own; ``tile_grid`` is cv2's ``tileGridSize`` (tiles across, down)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"clahe takes uint8 slices, got {img.dtype}")
    *lead, h, w = img.shape
    x = img.reshape(-1, h, w)
    nb = x.shape[0]
    tx, ty = tile_grid
    if h % ty == 0 and w % tx == 0:
        ext = x
    else:
        ext = np.pad(x, ((0, 0), (0, ty - h % ty), (0, tx - w % tx)),
                     mode="reflect")
    th, tw = ext.shape[1] // ty, ext.shape[2] // tx
    area = th * tw

    # one histogram per (slice, tile)
    tiles = ext[:, :ty * th, :tx * tw].reshape(nb, ty, th, tx, tw)
    tiles = tiles.transpose(0, 1, 3, 2, 4).reshape(nb, ty * tx, area)
    key = np.arange(nb * ty * tx).reshape(nb, ty * tx, 1) * HIST + tiles
    hist = np.bincount(key.ravel(), minlength=nb * ty * tx * HIST)
    hist = hist.reshape(nb, ty * tx, HIST)

    if clip_limit > 0:
        limit = max(int(clip_limit * area / HIST), 1)
        excess = np.maximum(hist - limit, 0).sum(-1, keepdims=True)
        batch = excess // HIST
        residual = excess - batch * HIST
        step = np.maximum(HIST // np.maximum(residual, 1), 1)
        bins = np.arange(HIST)
        hist = (np.minimum(hist, limit) + batch
                + ((bins % step == 0) & (bins // step < residual)))

    scale = np.float32(HIST - 1) / np.float32(area)
    lut = np.cumsum(hist, -1).astype(np.float32) * scale
    lut = np.clip(np.rint(lut), 0, 255).astype(np.float32)
    lut = lut.reshape(nb, ty, tx, HIST)

    def taps(n: int, size: int, count: int):
        inv = np.float32(1) / np.float32(size)
        f = np.arange(n).astype(np.float32) * inv - np.float32(0.5)
        lo = np.floor(f).astype(np.int64)
        frac = f - lo.astype(np.float32)
        return (np.maximum(lo, 0), np.minimum(lo + 1, count - 1), frac,
                np.float32(1) - frac)

    y1, y2, ya, ya1 = taps(h, th, ty)
    x1, x2, xa, xa1 = taps(w, tw, tx)
    b = np.arange(nb)[:, None, None]
    y1, y2 = y1[None, :, None], y2[None, :, None]
    ya, ya1 = ya[:, None], ya1[:, None]
    v = x.astype(np.int64)
    res = ((lut[b, y1, x1, v] * xa1 + lut[b, y1, x2, v] * xa) * ya1
           + (lut[b, y2, x1, v] * xa1 + lut[b, y2, x2, v] * xa) * ya)
    out = np.clip(np.rint(res), 0, 255).astype(np.uint8)
    return out.reshape(*lead, h, w)
