"""Inputs made from the seed: frozen copies of the program's synthetic
recipes, and the CHAOS-T2-shaped fold the evaluation reads.

* ``smooth_slices``: low-frequency slices, random 21² fields upsampled
  bilinearly and ×3, so the coarse mask has anatomy-like structure instead
  of white noise;
* ``support``: one support slice of white noise with a centred square
  label over the middle third;
* ``write_fold``: the scans of a CHAOS-T2 fold laid out as the program's
  data preparation writes its 672² data (``image_<id>.nii.gz`` float32,
  ``label_<id>.nii.gz`` int16, ``classmap_1.json``), with liver, kidneys
  and spleen as ellipsoids of seeded size over a noisy background.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def smooth_slices(n: int, size: int, g: torch.Generator,
                  device) -> torch.Tensor:
    """(n, 3, size, size) float32 on ``device``."""
    field = torch.randn(n, 3, 21, 21, generator=g, device=device)
    return F.interpolate(field, size=(size, size), mode="bilinear",
                         align_corners=False) * 3.0


def support(size: int, g: torch.Generator, device):
    """(image (1, 3, size, size), label (1, size, size)) on ``device``."""
    img = torch.randn(1, 3, size, size, generator=g, device=device)
    lbl = torch.zeros(1, size, size, device=device)
    q = size // 3
    lbl[:, q:2 * q, q:2 * q] = 1.0
    return img, lbl


# ------------------------------------------------------------------- fold

FOLD_NAMES = ["BG", "LIVER", "RK", "LK", "SPLEEN"]
# organ centres (y, x) on a 256² grid, scaled to the fold's side
FOLD_ORGANS = {1: (96, 80), 2: (160, 176), 3: (80, 176), 4: (176, 80)}


def _write_nifti(arr: np.ndarray, path: str,
                 spacing=(1.5, 1.5, 5.0)) -> int:
    """A (z, y, x) array as gzip-compressed NIfTI-1 (level 1); returns the
    bytes written."""
    codes = {np.dtype(np.float32): 16, np.dtype(np.int16): 4}
    z, y, x = arr.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, x, y, z, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, codes[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    struct.pack_into("<h", hdr, 252, 1)
    srow = np.zeros((3, 4), np.float32)
    srow[[0, 1, 2], [0, 1, 2]] = spacing
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1))
    hdr[344:348] = b"n+1\x00"
    with open(path, "wb") as raw, gzip.GzipFile(
            fileobj=raw, mode="wb", compresslevel=1, mtime=0) as f:
        f.write(bytes(hdr) + b"\x00" * 4)
        f.write(np.ascontiguousarray(arr).tobytes())
    return os.path.getsize(path)


def write_fold(base: str, scan_ids: list[int], depth: int, side: int,
               seed: int) -> dict:
    """Write the scans ``scan_ids`` of the fold into ``base``; returns
    ``{"bytes": on disk, "raw_bytes": uncompressed}``."""
    os.makedirs(base, exist_ok=True)
    zz, yy, xx = np.mgrid[:depth, :side, :side].astype(np.float32)
    cz, rz, k = (depth - 1) / 2.0, depth / 3.0, side / 256.0

    def scan(i: int):
        rng = np.random.default_rng([seed % (1 << 63), i])
        img = np.rint(rng.normal(100, 20, (depth, side, side))).astype(
            np.float32)
        lbl = np.zeros((depth, side, side), np.int16)
        for cls, (cy, cx) in FOLD_ORGANS.items():
            r = k * 4.0 * (7 + int(rng.integers(0, 3)))
            blob = (((yy - k * cy) / r) ** 2 + ((xx - k * cx) / r) ** 2
                    + ((zz - cz) / rz) ** 2) <= 1.0
            lbl[blob] = cls
            img[blob] += 80 + 10 * cls
        n = _write_nifti(img, f"{base}/image_{i}.nii.gz")
        n += _write_nifti(lbl, f"{base}/label_{i}.nii.gz")
        zs = {FOLD_NAMES[c]: sorted(int(z) for z in
                                    np.unique(np.nonzero(lbl == c)[0]))
              for c in FOLD_ORGANS}
        zs["BG"] = list(range(depth))
        return n, img.nbytes + lbl.nbytes, zs

    with ThreadPoolExecutor(len(scan_ids)) as ex:
        per_scan = list(ex.map(scan, scan_ids))
    cmap = {name: {str(i): zs[name] for i, (_, _, zs) in
                   zip(scan_ids, per_scan)} for name in FOLD_NAMES}
    for fname in ("classmap_1.json", "classmap_100.json"):
        with open(os.path.join(base, fname), "w") as f:
            json.dump(cmap, f)
    return {"bytes": sum(n for n, _, _ in per_scan),
            "raw_bytes": sum(r for _, r, _ in per_scan)}
