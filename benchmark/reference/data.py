"""Plain reference of the evaluation's data layer and scores, written from
the NIfTI-1 standard and the ProtoSAM evaluation (its
``validation_protosam.py`` and ``dataloaders/ManualAnnoDatasetv2.py``):

* ``read_nifti``: the 348-byte header, the voxels in x-fastest order, the
  scale slope and intercept, as a (z, y, x) array;
* ``episode``: the queries and supports one evaluation of a fold makes:
  MR volumes z-scored per volume and resized to the input size (bilinear,
  half-pixel centres), labels by nearest; the support slices at the
  1/6, 1/2 and 5/6 points of the class's z-extent in the support scan; the
  query slices of every other scan of the fold that hold the class, grouped
  by which third of the class's z-extent they fall in;
* ``slice_scores``: per-slice Dice, IoU, precision and recall, and their
  means over the slices.
"""

from __future__ import annotations

import gzip
import json
import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
           64: np.float64, 256: np.int8, 512: np.uint16}


def read_nifti(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if struct.unpack("<i", raw[:4])[0] != 348:
        raise ValueError(f"{path}: not NIfTI-1")
    dim = struct.unpack("<8h", raw[40:56])
    nx, ny, nz = dim[1], dim[2], dim[3]
    dtype = np.dtype(_DTYPES[struct.unpack("<h", raw[70:72])[0]])
    offset = int(struct.unpack("<f", raw[108:112])[0])
    slope, inter = struct.unpack("<2f", raw[112:120])
    arr = np.frombuffer(raw, dtype, nx * ny * nz, offset).reshape(nz, ny, nx)
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr.astype(np.float64) * (slope or 1.0) + inter
    return arr


def _resize(vol: np.ndarray, size: int, mode: str) -> np.ndarray:
    if vol.shape[-1] == size and vol.shape[-2] == size:
        return vol
    t = torch.from_numpy(np.ascontiguousarray(vol, np.float32))[:, None]
    if mode == "bilinear":
        t = F.interpolate(t, size=(size, size), mode="bilinear",
                          align_corners=False)
    else:
        t = F.interpolate(t, size=(size, size), mode="nearest")
    return t[:, 0].numpy()


def load_scan(base: str, pid: str, size: int) -> tuple[np.ndarray,
                                                      np.ndarray]:
    """MR image (z, size, size) z-scored over the volume, labels (z, size,
    size), both float32."""
    img = read_nifti(f"{base}/image_{pid}.nii.gz").astype(np.float64)
    img = ((img - img.mean()) / img.std()).astype(np.float32)
    lbl = read_nifti(f"{base}/label_{pid}.nii.gz").astype(np.float32)
    return _resize(img, size, "bilinear"), _resize(lbl, size, "nearest")


def episode(base: str, scan_ids: list[str], support_pos: int, cls: int,
            label_name: str, size: int, npart: int = 3) -> dict:
    """The evaluation's inputs: ``chunks`` a list, in part order, of dicts
    with ``part``, ``queries`` (n, 3, size, size), ``labels`` (n, size,
    size) and ``support`` (1, 3, size, size) / ``support_mask`` (1, size,
    size) for that part."""
    with open(os.path.join(base, "classmap_1.json")) as f:
        cmap = json.load(f)[label_name]
    sup_id = scan_ids[support_pos]
    img, lbl = load_scan(base, sup_id, size)
    zs = cmap[sup_id]
    half, step = 1 / (npart * 2), (1.0 - 1.0 / npart) / (npart - 1)
    supports = {}
    for part in range(npart):
        z = zs[int((half + step * part) * len(zs))]
        supports[part] = (np.repeat(img[z][None], 3, 0)[None],
                          (lbl[z] == cls).astype(np.float32)[None])
    by_part: dict[int, list] = {}
    for pid in scan_ids:
        if pid == sup_id:
            continue
        img, lbl = load_scan(base, pid, size)
        zmin, zmax = min(cmap[pid]), max(cmap[pid])
        for z in range(img.shape[0]):
            gt = (lbl[z] == cls).astype(np.float32)
            if gt.max() < 1:
                continue
            part = 0 if zmax == zmin else int((z - zmin)
                                              // ((zmax - zmin) / npart))
            part = min(max(part, 0), npart - 1)
            by_part.setdefault(part, []).append(
                (np.repeat(img[z][None], 3, 0), gt))
    chunks = []
    for part in sorted(by_part):
        q = np.stack([a for a, _ in by_part[part]])
        g = np.stack([b for _, b in by_part[part]])
        sup, msk = supports[part]
        chunks.append({"part": part, "queries": q, "labels": g,
                       "support": sup, "support_mask": msk})
    return chunks


def slice_scores(preds: list[np.ndarray], labels: list[np.ndarray],
                 dtype=np.float64) -> dict:
    """Mean per-slice Dice, IoU, precision and recall (a slice whose label
    is empty scores 0)."""
    out = {"dice": [], "iou": [], "precision": [], "recall": []}
    for p, g in zip(preds, labels):
        p = np.asarray(p, dtype)
        g = np.asarray(g, dtype)
        if g.sum() == 0:
            for k in out:
                out[k].append(0.0)
            continue
        tp, fp, fn = (p * g).sum(), (p * (1 - g)).sum(), ((1 - p) * g).sum()
        eps = dtype(1e-8)
        out["dice"].append(2 * tp / (2 * tp + fp + fn + eps))
        out["iou"].append(tp / (tp + fp + fn + eps))
        out["precision"].append(tp / (tp + fp + eps))
        out["recall"].append(tp / (tp + fn + eps))
    return {k: float(np.mean(np.asarray(v, dtype))) for k, v in out.items()}
