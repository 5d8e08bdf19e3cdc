"""Run-length mask encoding (reference segment_anything/utils/amg.py:107-152;
the JAX package's `models/sam/rle.py`, copied: numpy only)."""

from __future__ import annotations

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> uncompressed column-major RLE
    {'size': [H, W], 'counts': [...]}, starting with a background run."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major (F order)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in rle["counts"]:
        flat[pos:pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T


def area_from_rle(rle: dict) -> int:
    return sum(rle["counts"][1::2])


def coco_encode_rle(rle: dict) -> dict:
    """Uncompressed RLE -> COCO compressed-string RLE.

    Pure-python port of pycocotools' rleToString (maskApi.c): 5 data bits
    per char + a continuation bit, ASCII offset 48, counts delta-encoded
    against counts[i-2] from the 4th element on.  The reference reaches
    this through pycocotools (segment_anything/utils/amg.py:294-300,
    coco_encode_rle); output is byte-compatible."""
    cnts = rle["counts"]
    chars = []
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # python's >> on negatives is arithmetic, like C long
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return {"size": rle["size"], "counts": "".join(chars)}


def coco_decode_rle(rle: dict) -> dict:
    """COCO compressed-string RLE -> uncompressed RLE (pycocotools'
    rleFrString inverse, for round-trip verification)."""
    s = rle["counts"]
    cnts: list[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return {"size": rle["size"], "counts": cnts}
