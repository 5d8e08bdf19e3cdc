"""Offline data preparation (JAX ``data/prepare.py``) — the reference's
data_processing.ipynb as code.

Steps (reference data/data_processing.ipynb):
  1. intensity normalization: MR top-0.5% histogram cut; CT windowing is
     assumed done upstream;
  2. spatial resampling to a unified voxel spacing (scipy ``zoom``), then
     the in-plane resize to the target resolution (256 or 672);
  3. superpixel pseudo-label generation: per-slice Felzenszwalb
     (min_size=400, sigma=1, scale=1) masked to the largest foreground
     component with filled holes;
  4. classmap JSONs (per-class z-slice lists with a min-fg-pixel filter).

Felzenszwalb runs in the native C++ library (``native/felzenszwalb.cc``,
built with g++ at first use), one thread a slice.  The foreground's
connected components of a whole volume are one call of K3
(``ops/cca.label_components``) on the card, or its plain version for
``device="cpu"``; the hole filling stays on the host (scipy fills through
4-connected background, which K3's 8-connected labels do not give).  The
in-plane resize reproduces OpenCV 5's float32 ``cv2.resize`` bit for bit
(``resize_linear``, ``resize_nearest``), since Felzenszwalb's sorted joins
turn last-ulp differences into different superpixels.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.ndimage import binary_fill_holes, zoom

from protosam_tpu_torch.data.nifti import NiftiImage, read_nii, write_nii
from protosam_tpu_torch.native import build
from protosam_tpu_torch.ops.cca import BIG, label_components


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("felzenszwalb")
    lib.felzenszwalb_2d.restype = ctypes.c_int
    lib.felzenszwalb_2d.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def felzenszwalb(img: np.ndarray, scale: float = 1.0, sigma: float = 1.0,
                 min_size: int = 400) -> np.ndarray:
    """Per-slice graph segmentation, labels from 0 (skimage convention)."""
    lib = _lib()
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    out = np.empty((h, w), np.int32)
    lib.felzenszwalb_2d(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        h, w, scale, sigma, min_size,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


# ---- the in-plane resize: OpenCV 5's float32 cv2.resize -------------------
#
# INTER_LINEAR (measured against cv2 5.0 on every shape the tests hold):
# the source coordinate (d + 0.5) * (1 / (dst / src)) - 0.5 in float64, its
# floor, the fraction cast to float32; columns past either border copy the
# border pixel; rows are clamped into the image; each pass (horizontal
# first) is one fused multiply-add per pixel, fma(frac, s1 - s0, s0), in
# every column (no scalar tail takes another form).  INTER_NEAREST:
# min(floor(d * (1 / (dst / src))), src - 1) in float64.


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``fma(a, b, c)``, rounded once: the float64 product is exact,
    the float64 sum is made round-to-odd from its TwoSum error, and round-
    to-odd at 53 bits then rounds to 24 bits as one rounding would."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _linear_taps(dst: int, src: int):
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    lo = np.floor(pos).astype(np.int64)
    return lo, (pos - lo).astype(np.float32)


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)`` of
    float32 slices (..., H, W), bit for bit."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[-2:]
    if min(h, w) < 2:
        raise ValueError(f"resize_linear needs slices of 2 x 2 or more, got "
                         f"{h} x {w}")
    lo, frac = _linear_taps(size, w)
    edge = (lo < 0) | (lo >= w - 1)
    lo = np.clip(lo, 0, w - 1)
    s0 = img[..., lo]
    s1 = img[..., np.minimum(lo + 1, w - 1)]
    rows = np.where(edge, s0, _fma32(frac, s1 - s0, s0))
    lo, frac = _linear_taps(size, h)
    r0 = rows[..., np.clip(lo, 0, h - 1), :]
    r1 = rows[..., np.clip(lo + 1, 0, h - 1), :]
    return _fma32(frac[:, None], r1 - r0, r0)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(img, (size, size), interpolation=cv2.INTER_NEAREST)``
    of slices (..., H, W)."""
    h, w = img.shape[-2:]
    idx = lambda n: np.minimum(np.floor(
        np.arange(size) * (1.0 / (size / n))).astype(np.int64), n - 1)
    return img[..., idx(h), :][..., idx(w)]


# ---- foreground masks and superpixels --------------------------------------


def _largest_components(mask: np.ndarray, device) -> np.ndarray:
    """(Z, H, W) bool -> each slice's largest 8-connected component, from
    one ``label_components`` call on ``device``.  A tie goes to the root with
    the lowest flat index: cv2's first label, ``np.argmax``'s pick."""
    z, h, w = mask.shape
    roots = label_components(torch.from_numpy(mask).to(device))
    roots = roots.reshape(z, h * w).long()
    fg = roots < BIG
    counts = torch.zeros((z, h * w + 1), dtype=torch.int64,
                         device=roots.device)
    counts.scatter_add_(1, torch.where(fg, roots, h * w),
                        fg.to(torch.int64))
    # most pixels first, then the lowest root
    idx = torch.arange(h * w, device=roots.device)
    best = (counts[:, :h * w] * (h * w) + (h * w - 1 - idx)).argmax(dim=1)
    largest = fg & (roots == best[:, None])
    return largest.reshape(z, h, w).cpu().numpy()


def fg_masks(vol: np.ndarray, thresh: float, device=None) -> np.ndarray:
    """``fg_mask_2d`` of every slice of a (Z, H, W) volume: the largest
    connected foreground component with holes filled, float32; an empty
    slice stays empty (the notebook's fg_mask2d)."""
    mask = np.asarray(vol) > thresh
    out = mask.astype(np.float32)
    busy = np.flatnonzero(mask.reshape(len(mask), -1).any(axis=1))
    if len(busy):
        largest = _largest_components(mask[busy],
                                      device if device else "cuda")
        for z, comp in zip(busy, largest):
            out[z] = binary_fill_holes(comp).astype(np.float32)
    return out


def fg_mask_2d(img2d: np.ndarray, thresh: float, device=None) -> np.ndarray:
    """Largest connected foreground component with holes filled
    (notebook fg_mask2d)."""
    return fg_masks(np.asarray(img2d)[None], thresh, device)[0]


def superpix_masking(raw_seg: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero superpixels outside the body mask, relabel by sorted value
    (notebook superpix_masking): background 0, superpixels 1..n; where the
    mask leaves no background, the first superpixel takes 0, as in JAX's
    loop."""
    seg = (raw_seg.astype(np.int32) + 1) * (mask > 0)
    return np.unique(seg, return_inverse=True)[1].reshape(seg.shape).astype(
        np.int32)


def superpix_volume(img: np.ndarray, fg_thresh: float, min_size: int = 400,
                    sigma: float = 1.0, device=None) -> np.ndarray:
    """(z, y, x) volume -> per-slice masked superpixel labels."""
    img = np.asarray(img, np.float32)
    with ThreadPoolExecutor(min(len(img), os.cpu_count() or 1) or 1) as ex:
        segs = list(ex.map(lambda s: felzenszwalb(
            s, scale=1.0, sigma=sigma, min_size=min_size), img))
    masks = fg_masks(img, fg_thresh, device)
    return np.stack([superpix_masking(s, m) for s, m in zip(segs, masks)])


# ---- resampling, normalisation, classmaps ---------------------------------


def resample_volume(img: NiftiImage, new_spacing, is_label: bool = False
                    ) -> NiftiImage:
    """Spacing-based resampling (notebook resample_by_res).  Labels are
    resampled channel-by-channel linearly and argmaxed back, like
    resample_lb_by_res."""
    factors = [s_old / s_new for s_old, s_new in
               zip(img.spacing[::-1], new_spacing[::-1])]  # (z, y, x)
    if not is_label:
        arr = zoom(img.array.astype(np.float32), factors, order=1)
    else:
        vals = np.unique(img.array)
        chans = [zoom((img.array == v).astype(np.float32), factors, order=1)
                 for v in vals]
        arr = np.asarray(vals)[np.argmax(np.stack(chans), axis=0)]
    return NiftiImage(arr.astype(img.array.dtype
                                 if is_label else np.float32),
                      spacing=tuple(new_spacing), origin=img.origin,
                      direction=img.direction)


def normalize_mr(arr: np.ndarray, hist_cut_top: float = 0.5) -> np.ndarray:
    """Top-percentile histogram cut (notebook HIST_CUT_TOP)."""
    hir = float(np.percentile(arr, 100.0 - hist_cut_top))
    return np.minimum(arr, hir)


def build_classmaps(label_dir: str, out_dir: str, label_names: list[str],
                    min_fg_list=(1, 100)):
    """classmap_{min_fg}.json: per class, per scan, z slices with >= min_fg
    foreground pixels (reference classmap contract,
    ManualAnnoDatasetv2.py:229-238)."""
    label_files = sorted(glob.glob(os.path.join(label_dir, "label_*.nii.gz")))
    for min_fg in min_fg_list:
        cmap = {name: {} for name in label_names}
        for f in label_files:
            sid = re.findall(r"\d+", os.path.basename(f))[-1]
            lb = read_nii(f)
            for cls, name in enumerate(label_names):
                counts = (lb == cls).reshape(lb.shape[0], -1).sum(axis=1)
                cmap[name][sid] = [int(z) for z in
                                   np.nonzero(counts >= min_fg)[0]]
        with open(os.path.join(out_dir, f"classmap_{min_fg}.json"),
                  "w") as fp:
            json.dump(cmap, fp)


def _resample_scan(img_fid: str, out_dir: str, modality: str,
                   image_size: int, new_spacing) -> tuple[str, NiftiImage]:
    """Read, normalise, resample and resize one scan and its labels, and
    write both; returns the scan id and the prepared image."""
    in_dir = os.path.dirname(img_fid)
    sid = re.findall(r"\d+", os.path.basename(img_fid))[-1]
    img = read_nii(img_fid, peel_info=False)
    lb = read_nii(os.path.join(in_dir, f"label_{sid}.nii.gz"),
                  peel_info=False)
    if modality == "MR":
        img.array = normalize_mr(img.array)
    img = resample_volume(img, new_spacing)
    lb = resample_volume(lb, new_spacing, is_label=True)
    img.array = resize_linear(img.array, image_size)
    lb.array = resize_nearest(lb.array.astype(np.float32), image_size)
    write_nii(img, os.path.join(out_dir, f"image_{sid}.nii.gz"))
    write_nii(lb, os.path.join(out_dir, f"label_{sid}.nii.gz"))
    return sid, img


def prepare_dataset(in_dir: str, out_dir: str, modality: str,
                    label_names: list[str], image_size: int = 672,
                    new_spacing=(1.25, 1.25, 7.70),
                    fg_thresh: float = 1e-4, device=None):
    """Full prep pipeline for a directory of image_*/label_* NIfTI pairs;
    the connected components on the card unless ``device="cpu"``.  Scans
    are read, resampled and written in a pool of threads (scipy, zlib and
    numpy release the interpreter); each scan's superpixels follow in this
    thread, in scan order, one K3 call a scan."""
    os.makedirs(out_dir, exist_ok=True)
    fg_thresh = fg_thresh + (50 if modality == "MR" else 0)
    scans = sorted(glob.glob(os.path.join(in_dir, "image_*.nii.gz")))
    with ThreadPoolExecutor(min(len(scans), os.cpu_count() or 1) or 1) as ex:
        for sid, img in ex.map(lambda f: _resample_scan(
                f, out_dir, modality, image_size, new_spacing), scans):
            sp = superpix_volume(img.array, fg_thresh, device=device)
            write_nii(NiftiImage(sp.astype(np.int16), img.spacing,
                                 img.origin, img.direction),
                      os.path.join(out_dir, f"superpix-MIDDLE_{sid}.nii.gz"))
    build_classmaps(out_dir, out_dir, label_names)
