"""The port's PNG reader and writer (``data/png.py``) against ``cv2.imread``
(OpenCV 5.0): files cv2 writes, and files written here with each of the
five row filters, bit-equal in colour (RGB) and grayscale reads."""

import struct
import zlib

import numpy as np
import pytest

try:  # the reference; the GPU machine has no cv2 and runs only `-m cuda`
    import cv2
except ImportError:
    pass

from protosam_tpu_torch.data import png


def _smooth(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([127 + 100 * np.sin(x / 17 + i) * np.cos(y / 23 - i)
                     + rng.integers(0, 20, (h, w)) for i in range(c)],
                    axis=-1).clip(0, 255).astype(np.uint8)


def _cv2_reads(path):
    return (cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB),
            cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _encode(img, ctype, filters, depth=8, interlace=0):
    """A PNG of ``img`` whose row r uses filter ``filters[r]``."""
    h, w = img.shape[:2]
    bpp = img.shape[2] if img.ndim == 3 else 1
    x = img.reshape(h, w * bpp).astype(np.int64)
    up = np.vstack([np.zeros((1, w * bpp), np.int64), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), x[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, paeth]
    rows = [np.concatenate([[k], (x[r] - preds[k][r]) & 255])
            for r, k in enumerate(filters)]
    raw = np.stack(rows).astype(np.uint8)
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, interlace))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(61, 83, 3), (40, 41, 1), (30, 20, 4)],
                         ids=["rgb", "grey", "rgba"])
def test_reads_what_cv2_writes(tmp_path, shape):
    img = _smooth(np.random.default_rng(0), *shape)
    if shape[2] == 1:
        img = img[..., 0]
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    colour, grey = _cv2_reads(path)
    np.testing.assert_array_equal(png.read_png(path), colour)
    np.testing.assert_array_equal(png.read_png(path, grayscale=True), grey)


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (4, 2), (6, 4)],
                         ids=["grey", "rgb", "grey-alpha", "rgba"])
@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth",
                                  "mixed"])
def test_every_filter_matches_cv2(tmp_path, ctype, channels, filt):
    """Each filter alone and all five mixed row by row; colour reads drop
    the alpha, grayscale reads of colour files are libpng's rgb_to_gray."""
    rng = np.random.default_rng(ctype)
    img = _smooth(rng, 37, 29, channels)
    if channels == 1:
        img = img[..., 0]
    kinds = ["none", "sub", "up", "average", "paeth"]
    filters = (rng.integers(0, 5, 37) if filt == "mixed"
               else np.full(37, kinds.index(filt)))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_encode(img, ctype, filters))
    colour, grey = _cv2_reads(path)
    np.testing.assert_array_equal(png.read_png(path), colour)
    np.testing.assert_array_equal(png.read_png(path, grayscale=True), grey)


@pytest.mark.parametrize("channels", [1, 3])
def test_writer_round_trip(tmp_path, channels):
    img = _smooth(np.random.default_rng(1), 24, 35, channels)
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    back = png.read_png(path, grayscale=channels == 1)
    np.testing.assert_array_equal(back, img)
    colour, _ = _cv2_reads(path)
    want = img if channels == 3 else np.repeat(img[..., None], 3, axis=-1)
    np.testing.assert_array_equal(colour, want)


@pytest.mark.parametrize("filt", ["sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [1, 3])
def test_writer_filters_read_by_cv2(tmp_path, filt, channels):
    """``write_png(filters=...)``: each filter on every row, and the five
    cycled row by row, read back by cv2 and by ``read_png`` unchanged."""
    img = _smooth(np.random.default_rng(3), 33, 26, channels)
    if channels == 1:
        img = img[..., 0]
    kinds = ["none", "sub", "up", "average", "paeth"]
    filters = (np.arange(33) % 5 if filt == "mixed" else kinds.index(filt))
    path = str(tmp_path / "w.png")
    png.write_png(path, img, filters=filters)
    with open(path, "rb") as f:
        stored = png.decode_png(f.read())
    np.testing.assert_array_equal(stored.reshape(img.shape), img)
    colour, grey = _cv2_reads(path)
    want = img if channels == 3 else np.repeat(img[..., None], 3, axis=-1)
    np.testing.assert_array_equal(colour, want)
    np.testing.assert_array_equal(png.read_png(path), want)
    np.testing.assert_array_equal(png.read_png(path, grayscale=True), grey)


def test_unknown_row_filter_raises(tmp_path):
    raw = _encode(_smooth(np.random.default_rng(4), 6, 5, 3), 2,
                  np.zeros(6, int))
    img = _smooth(np.random.default_rng(4), 6, 5, 3)
    rows = np.concatenate([np.zeros((6, 1), np.uint8), img.reshape(6, 15)],
                          axis=1)
    rows[3, 0] = 7
    data = (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 2, 0, 0,
                                              0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + png._chunk(b"IEND", b""))
    assert png.decode_png(raw).shape == (6, 5, 3)
    with pytest.raises(ValueError, match="row filter 7"):
        png.decode_png(data)
    with pytest.raises(ValueError, match="0-4"):
        png.write_png(str(tmp_path / "x.png"), img, filters=5)


@pytest.mark.parametrize("kind", ["palette", "16-bit", "interlaced", "jpeg"])
def test_refusals_name_what_is_missing(tmp_path, kind):
    img = _smooth(np.random.default_rng(2), 8, 8, 3)
    path = str(tmp_path / ("a.jpg" if kind == "jpeg" else "a.png"))
    if kind == "palette":
        data = _encode(img[..., 0], 3, np.zeros(8, int))
        match = "palette"
    elif kind == "16-bit":
        data = _encode(img[..., 0], 0, np.zeros(8, int), depth=16)
        match = "16-bit"
    elif kind == "interlaced":
        data = _encode(img, 2, np.zeros(8, int), interlace=1)
        match = "interlaced"
    else:
        data, match = b"\xff\xd8\xff", "JPEG"
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match=match):
        png.read_png(path)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "b.png"), img.astype(np.float32))
