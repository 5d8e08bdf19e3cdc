"""Host-side training augmentations without cv2 (JAX ``data/transforms.py``;
reference dataloaders/augutils.py and dataloaders/image_transforms.py).

JAX calls ``cv2.getRotationMatrix2D``, ``cv2.warpAffine`` (flag 3,
``BORDER_CONSTANT``) and ``cv2.GaussianBlur``; the card's machine has no
cv2, so they are written here in numpy / scipy with OpenCV's arithmetic:

  * the warp's flag 3 is ``INTER_AREA``, which ``warpAffine`` runs as
    bilinear.  The affine map is inverted in float64; OpenCV 5 then takes
    float32 source positions and fma lerps for 1, 3 or 4 channels, and
    its remap path for other counts: positions in fixed point (1/1024,
    rounded to 1/32 of a pixel) and a float32 weight table.  Both are
    copied, with zeros outside the image;
  * ``INTER_NEAREST`` (the polyp masks' warp) rounds the same float32
    source positions to the nearest pixel, ties to even;
  * ``GaussianBlur`` takes ``getGaussianKernel``'s weights in float64 and
    ``BORDER_REFLECT_101``, which is scipy's ``mode="mirror"``.

The random draws come in JAX's order from the same generator, so one
``np.random.RandomState`` gives JAX's episode.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
from numpy.lib.stride_tricks import as_strided
from scipy.ndimage import correlate1d, map_coordinates


def get_aug(which_aug: str, input_size: int) -> dict:
    """Aug recipe dicts (reference augutils.py:16-57)."""
    if which_aug == "sabs_aug":
        return {"aug": {
            "flip": {"v": False, "h": False, "t": False, "p": 0.25},
            "affine": {"rotate": 5, "shift": (5, 5), "shear": 5,
                       "scale": (0.9, 1.2)},
            "elastic": {"alpha": 10, "sigma": 5},
            "patch": input_size,
            "reduce_2d": True,
            "gamma_range": (0.5, 1.5),
        }}
    if which_aug == "aug_v3":
        return {"aug": {
            "flip": {"v": False, "h": False, "t": False, "p": 0.25},
            "affine": {"rotate": 30, "shift": (30, 30), "shear": 30,
                       "scale": (0.8, 1.3)},
            "elastic": {"alpha": 20, "sigma": 5},
            "patch": input_size,
            "reduce_2d": True,
            "gamma_range": (0.2, 1.8),
        }}
    raise NotImplementedError(which_aug)


# ---- OpenCV's arithmetic ---------------------------------------------------
#
# JAX warps with ``flags=order`` = 3, which is ``cv2.INTER_AREA``, and
# ``warpAffine`` takes INTER_AREA for INTER_LINEAR: the warp is bilinear.
# OpenCV (5.0 here) has two bilinear warps of float32 images: 1, 3 or 4
# channels take float32 source positions and lerps; other channel counts
# take the remap path, positions in fixed point rounded to 1/32 pixel.

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
AB_BITS = 10                      # max(10, INTER_BITS)
AB_SCALE = 1 << AB_BITS


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the centre as float32 (``Point2f``),
    the rest in float64."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * np.pi / 180
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """The destination -> source map, inverted in float64 as
    ``warpAffine`` does without ``WARP_INVERSE_MAP``."""
    mm = np.asarray(m, dtype=np.float64).reshape(6).copy()
    d = mm[0] * mm[4] - mm[1] * mm[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = mm[4] * d, mm[0] * d
    mm[0], mm[1], mm[3], mm[4] = a11, mm[1] * -d, mm[3] * -d, a22
    mm[2], mm[5] = (-mm[0] * mm[2] - mm[1] * mm[5],
                    -mm[3] * mm[2] - mm[4] * mm[5])
    return mm


def _taps(img: np.ndarray, r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """img[r, c] per pixel, 0 outside (``BORDER_CONSTANT``)."""
    h, w = img.shape[:2]
    ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    v = img[np.clip(r, 0, h - 1), np.clip(c, 0, w - 1)]
    return np.where(ok[..., None], v, np.float32(0))


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``fma(a, b, c)``: the float64 product of two float32 values
    is exact, so one rounding of the sum."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_linear_float(img: np.ndarray, mm: np.ndarray) -> np.ndarray:
    """1, 3 or 4 channels: source positions ``fma(M0, x, y·M1 + M2)`` in
    float32, then ``p00 + a·(p01 - p00)`` by fmas, across then down."""
    h, w = img.shape[:2]
    m = mm.astype(np.float32)
    ys = np.arange(h, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    sx = _fma32(m[0], xs, (ys * m[1] + m[2])[:, None])
    sy = _fma32(m[3], xs, (ys * m[4] + m[5])[:, None])
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    p00, p01 = _taps(img, iy, ix), _taps(img, iy, ix + 1)
    p10, p11 = _taps(img, iy + 1, ix), _taps(img, iy + 1, ix + 1)
    v0 = _fma32(a, p01 - p00, p00)
    v1 = _fma32(a, p11 - p10, p10)
    return _fma32(b, v1 - v0, v0)


def _warp_linear_fixed(img: np.ndarray, mm: np.ndarray) -> np.ndarray:
    """Other channel counts (the remap path): positions in fixed point
    (1/1024, rounded to 1/32), float32 weights ``wy·wx`` of the 1/32
    table, ``((v0·w0 + v1·w1) + v2·w2) + v3·w3``."""
    h, w = img.shape[:2]
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    adelta = np.rint(mm[0] * xs * AB_SCALE).astype(np.int64)
    bdelta = np.rint(mm[3] * xs * AB_SCALE).astype(np.int64)
    rnd = AB_SCALE // INTER_TAB_SIZE // 2
    x0 = np.rint((mm[1] * ys + mm[2]) * AB_SCALE).astype(np.int64) + rnd
    y0 = np.rint((mm[4] * ys + mm[5]) * AB_SCALE).astype(np.int64) + rnd
    fx = (x0[:, None] + adelta[None, :]) >> (AB_BITS - INTER_BITS)
    fy = (y0[:, None] + bdelta[None, :]) >> (AB_BITS - INTER_BITS)
    ix, iy = fx >> INTER_BITS, fy >> INTER_BITS
    tab = np.arange(INTER_TAB_SIZE, dtype=np.float32) \
        * np.float32(1.0 / INTER_TAB_SIZE)
    wx = tab[fx & (INTER_TAB_SIZE - 1)][..., None]
    wy = tab[fy & (INTER_TAB_SIZE - 1)][..., None]
    one = np.float32(1)
    out = _taps(img, iy, ix) * ((one - wy) * (one - wx))
    out = out + _taps(img, iy, ix + 1) * ((one - wy) * wx)
    out = out + _taps(img, iy + 1, ix) * (wy * (one - wx))
    return out + _taps(img, iy + 1, ix + 1) * (wy * wx)


def _warp_nearest(img: np.ndarray, mm: np.ndarray) -> np.ndarray:
    """``INTER_NEAREST``: the float32 source positions of the bilinear warp
    (``fma(M0, x, y·M1 + M2)``), rounded to the nearest, ties to even."""
    h, w = img.shape[:2]
    m = mm.astype(np.float32)
    ys = np.arange(h, dtype=np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    sx = _fma32(m[0], xs, (ys * m[1] + m[2])[:, None])
    sy = _fma32(m[3], xs, (ys * m[4] + m[5])[:, None])
    return _taps(img, np.rint(sy).astype(np.int64),
                 np.rint(sx).astype(np.int64))


def warp_affine(image: np.ndarray, m: np.ndarray,
                nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine(image, m, (W, H), flags=3, borderMode=
    BORDER_CONSTANT)`` of a float32 (H, W, C) array with the (2, 3)
    forward map ``m``: bilinear, zeros outside the source.  ``nearest``
    is ``flags=cv2.INTER_NEAREST`` (1 or 4 channels, as measured).

    The bilinear warp of 1, 3 or 4 channels is cv2's bit for bit in each
    row's blocks of 16 pixels; cv2 takes the last W mod 16 columns through
    a scalar loop whose rounding is not reproduced: there it is within
    2e-5 of the image's range (measured up to 1.2e-5; a deviation, ROADMAP
    §3)."""
    img = np.ascontiguousarray(image, dtype=np.float32)
    mm = _invert_affine(m)
    if nearest:
        if img.shape[2] not in (1, 4):
            raise NotImplementedError(
                f"the nearest warp of {img.shape[2]} channels is not "
                f"reproduced (1 or 4)")
        return _warp_nearest(img, mm)
    if img.shape[2] in (1, 3, 4):
        return _warp_linear_float(img, mm)
    return _warp_linear_fixed(img, mm)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, CV_64F)``."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return t * (1.0 / t.sum())


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of a float64 2-D
    array: the row pass, then the column pass, ``BORDER_REFLECT_101``."""
    k = gaussian_kernel(ksize, sigma)
    out = correlate1d(np.asarray(img, np.float64), k, axis=1, mode="mirror")
    return correlate1d(out, k, axis=0, mode="mirror")


# ---- affine ----------------------------------------------------------------

def _rotation_matrix(deg: float, shape) -> np.ndarray:
    return np.vstack([rotation_matrix_2d((shape[0] / 2, shape[1] // 2),
                                         deg, 1), [0, 0, 1]])


def _zoom_matrix(z: float, shape) -> np.ndarray:
    return np.vstack([rotation_matrix_2d((shape[0] / 2, shape[1] // 2),
                                         0, z), [0, 0, 1]])


def _translation_matrix(tx: float, ty: float) -> np.ndarray:
    return np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]], np.float64)


def _shear_matrix(deg: float) -> np.ndarray:
    t = np.pi * deg / 180
    return np.array([[1, -np.sin(t), 0], [0, np.cos(t), 0], [0, 0, 1]])


class RandomAffine:
    """Random affine (reference image_transforms.py:72-188): rotation,
    translation, shear and zoom matrices composed left to right, one
    transform for every channel, zeros outside.  ``order`` is handed to
    OpenCV as its interpolation flag, as in JAX: 3 (the default) is
    ``INTER_AREA``, which a warp takes for bilinear."""

    def __init__(self, rotation_range=None, translation_range=None,
                 shear_range=None, zoom_range=None, zoom_keep_aspect=True,
                 order=3, rng: np.random.RandomState | None = None):
        if order != 3:
            raise NotImplementedError("only OpenCV's flag 3 (bilinear in "
                                      "a warp) is written without cv2")
        self.rotation_range = rotation_range
        self.translation_range = translation_range
        self.shear_range = shear_range
        self.zoom_range = zoom_range
        self.zoom_keep_aspect = zoom_keep_aspect
        self.order = order
        self.rng = rng or np.random

    def build_matrix(self, shape) -> np.ndarray:
        tfx = []
        if self.rotation_range:
            tfx.append(_rotation_matrix(
                self.rng.uniform(-self.rotation_range, self.rotation_range),
                shape))
        if self.translation_range:
            tx = self.rng.uniform(-self.translation_range[0],
                                  self.translation_range[0])
            ty = self.rng.uniform(-self.translation_range[1],
                                  self.translation_range[1])
            tfx.append(_translation_matrix(tx, ty))
        if self.shear_range:
            tfx.append(_shear_matrix(
                self.rng.uniform(-self.shear_range, self.shear_range)))
        if self.zoom_range:
            sx = self.rng.uniform(*self.zoom_range)
            tfx.append(_zoom_matrix(sx, shape))
        m = np.eye(3)
        for t in tfx:
            m = t @ m
        return m.astype(np.float32)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        m = self.build_matrix(image.shape[:2])[:2]
        shape = image.shape
        warped = warp_affine(image.reshape(shape[:2] + (-1,)), m)
        return warped.reshape(shape)


# ---- elastic ---------------------------------------------------------------

def elastic_transform_nd(image: np.ndarray, alpha: float, sigma: float,
                         rng=None, order: int = 1) -> np.ndarray:
    """Gaussian-smoothed displacement elastic deformation
    (reference image_transforms.py:252-320): a blur of uniform noise, one
    displacement for every channel, reflect-mode resampling."""
    rng = rng or np.random.RandomState(None)
    shape = image.shape
    imsize = shape[:2]
    dim = shape[2:]

    blur = int(4 * sigma) | 1
    dx = gaussian_blur(rng.rand(*imsize) * 2 - 1, blur, sigma) * alpha
    dy = gaussian_blur(rng.rand(*imsize) * 2 - 1, blur, sigma) * alpha

    if len(dim) == 1:
        # (H, W, C): the channel coordinate is an exact integer, so each
        # channel is a 2-D linear resample with the same bits as the 3-D
        # one, at half its taps
        yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                             indexing="ij")
        coords = np.stack([(yy + dy.astype(np.float32)).ravel(),
                           (xx + dx.astype(np.float32)).ravel()])
        return np.stack([map_coordinates(image[..., c], coords, order=order,
                                         mode="reflect")
                         for c in range(dim[0])], axis=-1).reshape(shape)

    dx = as_strided(dx.astype(np.float32),
                    strides=(0,) * len(dim) + (4 * shape[1], 4),
                    shape=dim + (shape[0], shape[1]))
    dx = np.transpose(dx, axes=(-2, -1) + tuple(range(len(dim))))
    dy = as_strided(dy.astype(np.float32),
                    strides=(0,) * len(dim) + (4 * shape[1], 4),
                    shape=dim + (shape[0], shape[1]))
    dy = np.transpose(dy, axes=(-2, -1) + tuple(range(len(dim))))

    coord = np.meshgrid(*[np.arange(s) for s in (shape[1], shape[0]) + dim])
    indices = [np.reshape(e + de, (-1, 1))
               for e, de in zip([coord[1], coord[0]] + list(coord[2:]),
                                [dy, dx] + [0] * len(dim))]
    return map_coordinates(image, indices, order=order,
                           mode="reflect").reshape(shape)


class ElasticTransform:
    def __init__(self, alpha, sigma, order=1, rng=None):
        self.alpha, self.sigma, self.order = alpha, sigma, order
        self.rng = rng

    def __call__(self, image):
        return elastic_transform_nd(image, self.alpha, self.sigma,
                                    rng=self.rng, order=self.order)


class RandomFlip3D:
    def __init__(self, h=True, v=True, t=True, p=0.5, rng=None):
        self.h, self.v, self.t, self.p = h, v, t, p
        self.rng = rng or np.random

    def __call__(self, x):
        if self.h and self.rng.random() < self.p:
            x = x[::-1, ...]
        if self.v and self.rng.random() < self.p:
            x = x[:, ::-1, ...]
        if self.t and self.rng.random() < self.p:
            x = x[..., ::-1]
        return x


# ---- intensity + composition ----------------------------------------------

def gamma_transform(img: np.ndarray, gamma_range, rng=None) -> np.ndarray:
    """Range-preserving random gamma (reference augutils.py:119-136)."""
    rng = rng or np.random
    if gamma_range is False:
        return img
    gamma = rng.rand() * (gamma_range[1] - gamma_range[0]) + gamma_range[0]
    cmin = img.min()
    irange = img.max() - cmin + 1e-5
    img = img - cmin + 1e-5
    img = irange * np.power(img * 1.0 / irange, gamma)
    return img + cmin


def get_geometric_transformer(aug: dict, order=3, rng=None) -> Callable:
    """Flip ∘ affine ∘ elastic (reference augutils.py:65-89)."""
    a = aug["aug"]
    tfx = []
    if "flip" in a:
        tfx.append(RandomFlip3D(**a["flip"], rng=rng))
    if "affine" in a:
        af = a["affine"]
        tfx.append(RandomAffine(af.get("rotate"), af.get("shift"),
                                af.get("shear"), af.get("scale"),
                                af.get("scale_iso", True), order=order,
                                rng=rng))
    if "elastic" in a:
        tfx.append(ElasticTransform(a["elastic"]["alpha"],
                                    a["elastic"]["sigma"], rng=rng))

    def compose(x):
        for t in tfx:
            x = t(x)
        return x

    return compose


def transform_with_label(aug: dict, rng=None) -> Callable:
    """Joint geometric + intensity transform of (H, W, C + 1) arrays whose
    last channel is the label (reference augutils.py:144-190): the label
    goes through the geometry one-hot and is rounded back; the image also
    gets the gamma.  With ``rng=None`` the draws come from ``np.random``
    and the elastic noise from a fresh ``RandomState``, as in JAX."""
    geometric = get_geometric_transformer(aug, rng=rng)
    gamma_range = aug["aug"]["gamma_range"]

    def transform(comp, c_label, c_img, use_onehot, nclass, **kwargs):
        comp = copy.deepcopy(comp)
        assert c_img + 1 == comp.shape[-1], "only single-slice 2D label"
        label = comp[..., c_img]
        h_label = np.float32(np.arange(nclass) == label[..., None])
        comp = np.concatenate([comp[..., :c_img], h_label], -1)
        comp = geometric(comp)
        t_label_h = np.rint(comp[..., c_img:])
        assert t_label_h.max() <= 1
        t_img = gamma_transform(comp[..., 0:c_img], gamma_range, rng=rng)
        if use_onehot:
            return t_img, t_label_h
        return t_img, np.expand_dims(np.argmax(t_label_h, axis=-1), -1)

    return transform
