"""PNG files without cv2: ``read_png`` reproduces ``cv2.imread`` as the
polyp data layer calls it (JAX ``data/polyp.py:24-29``), ``write_png``
writes the 8-bit files the tests and the smoke run build folds from.

The image data is inflated with the stdlib's ``zlib``; its rows are
unfiltered in one pass by the host library ``native/png.cc`` (every row
filter: None, Sub, Up, Average, Paeth; built with g++ at first use by
``native/build.py``, and a build that fails raises).  8-bit grey, grey +
alpha, RGB and RGBA files are read; palette, 16-bit and interlaced files
raise.

As cv2 (through libpng) reads them: colour reads drop the alpha and give
RGB (JAX converts cv2's BGR to RGB); ``grayscale=True`` of a colour file is
libpng's ``rgb_to_gray``, ``(9797 R + 19234 G + 3737 B) >> 15``, which is
not ``cvtColor(COLOR_BGR2GRAY)``'s rounding.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from protosam_tpu_torch.native import build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("png")
    lib.png_unfilter.restype = ctypes.c_int64
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_void_p]
    return lib


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (h, 1 + w * bpp) -> pixels (h, w, bpp) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, w, bpp), np.uint8)
    bad = _lib().png_unfilter(raw.ctypes.data, h, w * bpp, bpp,
                              out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row filter {int(raw[bad - 1, 0])} does not "
                         f"exist")
    return out


def _filter(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Pixel rows (h, w * bpp) -> filtered scanlines (h, 1 + w * bpp), row
    r with filter ``kinds[r]`` (0-4), predicted from the unfiltered bytes
    as the specification defines."""
    h, n = rows.shape
    x = rows.astype(np.int16)
    up = np.vstack([np.zeros((1, n), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int16), x[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int16), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    pred = preds[kinds, np.arange(h)]
    return np.concatenate([kinds[:, None], (x - pred) & 0xFF],
                          axis=1).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file's bytes: (H, W, channels) uint8, channels
    as the file stores them (1, 2, 3 or 4)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            raise NotImplementedError("palette PNGs are not read (colour "
                                      "type 3)")
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise NotImplementedError(f"PNG colour type {ctype} is not read "
                                  f"(palette)")
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNGs are not read (8-bit "
                                  f"only)")
    if interlace:
        raise NotImplementedError("interlaced (Adam7) PNGs are not read")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG image data of the wrong size")
    return _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)


def read_png(path: str, grayscale: bool = False) -> np.ndarray:
    """``cv2.imread(path)`` converted to RGB, (H, W, 3) uint8; or
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, (H, W) uint8.  A ``.jpg``
    raises: there is no JPEG decoder here."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(f"{path!r}: only PNG files are read (no "
                                  f"JPEG decoder without cv2)")
    with open(path, "rb") as f:
        px = decode_png(f.read())
    cn = px.shape[-1]
    if cn in (2, 4):  # the alpha is dropped
        px = px[..., :cn - 1]
    if grayscale:
        if px.shape[-1] == 1:
            return px[..., 0]
        r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
        return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    if px.shape[-1] == 1:
        return np.repeat(px, 3, axis=-1)
    return px


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, filters=0) -> None:
    """Write an 8-bit grey (H, W) or RGB (H, W, 3) image.  ``filters`` is
    the row filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) of every row,
    or a sequence of H, one a row, as an adaptive encoder picks them."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        ctype, bpp = 0, 1
    elif img.ndim == 3 and img.shape[-1] == 3:
        ctype, bpp = 2, 3
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    kinds = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if ((kinds < 0) | (kinds > 4)).any():
        raise ValueError(f"PNG row filters are 0-4, got {filters}")
    raw = _filter(img.reshape(h, w * bpp), kinds, bpp)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
