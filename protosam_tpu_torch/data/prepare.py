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
# INTER_LINEAR (measured against cv2 5.0 on random shapes, 1 to 30
# channels).  OpenCV 5 has two float32 bilinear resizes:
#
#   * 1, 3 or 4 channels: the source coordinate (d + 0.5) * (src / dst) -
#     0.5 in float64, its floor, the fraction cast to float32; columns past
#     either border copy the border pixel; rows are clamped into the image;
#     each pass (horizontal first) is one fused multiply-add per value,
#     fma(frac, s1 - s0, s0).  The columns that copy a border pixel take
#     the vertical pass unfused, s0 + round(frac * (s1 - s0)), when there
#     are 5-15 of them on their side: channels 0 and 1 of 3, or all 4 of 4.
#     Longer runs (upscales past ~30x) take a rounding not reproduced here,
#     and raise;
#   * other channel counts: the coordinate in float32 from (d + 0.5) *
#     (1 / (dst / src)) - 0.5, weights (1 - frac, frac) and two rounded
#     products added, s0 * w0 + s1 * w1, in both passes; border columns
#     copy, border rows keep their weights on the clamped rows.
#
# INTER_NEAREST: min(floor(d * (1 / (dst / src))), src - 1) in float64.


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
    """Lerp taps of the 1/3/4-channel resize: (lo, float32 frac, border)."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    lo = np.floor(pos).astype(np.int64)
    return lo, (pos - lo).astype(np.float32), (lo < 0) | (lo >= src - 1)


def _generic_taps(dst: int, src: int, clamp_weights: bool):
    """Taps of the other channel counts: (lo, hi, w0, w1).  Border columns
    take weights (1, 0); border rows keep theirs on the clamped rows."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(
        np.float32)
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    if clamp_weights:
        frac[(lo < 0) | (lo >= src - 1)] = 0
    return (np.clip(lo, 0, src - 1), np.clip(lo + 1, 0, src - 1),
            np.float32(1) - frac, frac)


def _unfused_border(cn: int, run: int) -> list[int]:
    """The channels of a border run of ``run`` columns that take the
    unfused vertical lerp, as measured (see above)."""
    if cn == 1 or run <= 4:
        return []
    if run > 15:
        raise NotImplementedError(
            f"resize_linear: a border run of {run} columns of a {cn}-channel "
            f"image (an upscale past ~30x) is not reproduced")
    return [0, 1] if cn == 3 else [0, 1, 2, 3]


def _fma32_t(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """``_fma32`` on CPU tensors: float32 ``fma(a, b, c)``, rounded once."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                           .to(s.dtype))
    return torch.where((err != 0) & even, away, s).float()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _resize_lerp(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """(..., H, W, C) with C in (1, 3, 4), the fused-lerp resize of each
    (H, W, C) image (in torch on the CPU: numpy took 8x longer)."""
    h, w, cn = img.shape[-3:]
    x = torch.from_numpy(img)
    lo, frac, edge = _linear_taps(nw, w)
    left, right = int((lo < 0).sum()), int((lo >= w - 1).sum())
    s0 = x.index_select(-2, _t(np.clip(lo, 0, w - 1)))
    s1 = x.index_select(-2, _t(np.minimum(np.clip(lo, 0, w - 1) + 1, w - 1)))
    f = _t(frac)[:, None]
    rows = torch.where(_t(edge)[:, None], s0, _fma32_t(f, s1 - s0, s0))
    lo, frac, _ = _linear_taps(nh, h)
    r0 = rows.index_select(-3, _t(np.clip(lo, 0, h - 1)))
    r1 = rows.index_select(-3, _t(np.clip(lo + 1, 0, h - 1)))
    f = _t(frac)[:, None, None]
    out = _fma32_t(f, r1 - r0, r0)
    for cols, run in ((slice(0, left), left), (slice(nw - right, nw),
                                               right)):
        chans = _unfused_border(cn, run)
        if chans:
            a, b = r0[..., cols, chans], r1[..., cols, chans]
            out[..., cols, chans] = a + f * (b - a)
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _resize_lib() -> ctypes.CDLL:
    lib = build.load("resize")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rs_linear.restype = lib.rs_nearest.restype = None
    lib.rs_linear.argtypes = [ptr, i64, i64, i64, i64] + [ptr] * 10
    lib.rs_nearest.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr]
    return lib


@functools.lru_cache(maxsize=None)
def _resize_pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(min(os.cpu_count() or 1, 8))


def _per_plane(fn, planes: int, size: int) -> None:
    """``fn(k)`` for every plane k, over the thread pool when the output is
    large (ctypes calls drop the GIL)."""
    if size < 1 << 18:
        for k in range(planes):
            fn(k)
    else:
        list(_resize_pool().map(fn, range(planes)))


def _resize_generic(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """(H, W, C), the weighted-sum resize of the other channel counts, in
    the native library (``native/resize.cc``: each product and sum rounded
    to float32 as numpy rounds them), plane by plane.  The result is the
    (H, W, C) view of a (C, H, W) array: the slice stacks of a volume come
    so stored, and are read without a copy.  An exact halving of both
    sides is cv2's INTER_AREA 2 x 2 mean instead, as ``cv2.resize``
    switches."""
    h, w, c = img.shape
    if w == 2 * nw and h == 2 * nh:
        a, b = img[0::2, 0::2], img[0::2, 1::2]
        d, e = img[1::2, 0::2], img[1::2, 1::2]
        return (np.float32(0) + (((a + b) + d) + e)) * np.float32(0.25)
    taps = [np.ascontiguousarray(v) for v in (*_generic_taps(nw, w, True),
                                              *_generic_taps(nh, h, False))]
    ptrs = [v.ctypes.data for v in taps]
    src = np.ascontiguousarray(img.transpose(2, 0, 1))
    tmp = np.empty((c, h, nw), np.float32)
    out = np.empty((c, nh, nw), np.float32)
    lib = _resize_lib()
    _per_plane(lambda k: lib.rs_linear(src[k].ctypes.data, h, w, nh, nw,
                                       *ptrs, tmp[k].ctypes.data,
                                       out[k].ctypes.data), c, out.size)
    return out.transpose(1, 2, 0)


def _dsize(size) -> tuple[int, int]:
    """cv2's ``dsize``: one int for a square, else ``(width, height)``."""
    if isinstance(size, (int, np.integer)):
        return int(size), int(size)
    nw, nh = size
    return int(nw), int(nh)


def resize_linear(img: np.ndarray, size, channels_last: bool = False
                  ) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` of float32
    images, bit for bit: slices (..., H, W), each resized alone, or one
    (H, W, C) image of C channels with ``channels_last``, as cv2 takes it;
    ``size`` is one side or cv2's ``(width, height)``."""
    img = np.asarray(img, np.float32)  # keeps the layout
    h, w = img.shape[-3:-1] if channels_last else img.shape[-2:]
    if min(h, w) < 2:
        raise ValueError(f"resize_linear needs images of 2 x 2 or more, got "
                         f"{h} x {w}")
    nw, nh = _dsize(size)
    if not channels_last:
        return _resize_lerp(img[..., None], nw, nh)[..., 0]
    if img.shape[-1] in (1, 3, 4):
        return _resize_lerp(img, nw, nh)
    return _resize_generic(img, nw, nh)


def _nearest_index(d: int, n: int) -> np.ndarray:
    return np.minimum(np.floor(np.arange(d) * (1.0 / (d / n))).astype(
        np.int64), n - 1)


def resize_nearest(img: np.ndarray, size, channels_last: bool = False
                   ) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`` of slices
    (..., H, W), or of an (H, W, C) image with ``channels_last``.  A float32
    stack stored plane by plane (an (H, W, C) view of a (C, H, W) array) is
    gathered plane by plane in the native library and returned so
    stored."""
    nw, nh = _dsize(size)
    if channels_last and img.ndim == 3 and img.dtype == np.float32 \
            and img.transpose(2, 0, 1).flags.c_contiguous:
        planes = img.transpose(2, 0, 1)
        c, h, w = planes.shape
        xi, yi = _nearest_index(nw, w), _nearest_index(nh, h)
        out = np.empty((c, nh, nw), np.float32)
        lib = _resize_lib()
        _per_plane(lambda k: lib.rs_nearest(
            planes[k].ctypes.data, w, nh, nw, xi.ctypes.data,
            yi.ctypes.data, out[k].ctypes.data), c, out.size)
        return out.transpose(1, 2, 0)
    hax = img.ndim - (3 if channels_last else 2)
    out = np.take(img, _nearest_index(nh, img.shape[hax]), axis=hax)
    return np.take(out, _nearest_index(nw, img.shape[hax + 1]),
                   axis=hax + 1)


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
