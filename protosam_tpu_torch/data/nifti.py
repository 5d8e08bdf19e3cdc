"""Minimal NIfTI-1 reader/writer in pure numpy.

The reference reads volumes with SimpleITK (dataloaders/niftiio.py:10-47);
a full ITK dependency is more than the .nii/.nii.gz medical volumes the
datasets use need, and this package takes none.  This implements the
NIfTI-1 standard directly: 348-byte header, optional gzip, scl slope/inter
scaling, and the spacing/origin/direction metadata the eval drivers carry
through to prediction writing (validation.py:322-330).

Array convention matches SimpleITK's GetArrayFromImage: (z, y, x) —
i.e. the transpose of the on-disk (x, y, z) Fortran order — so slice
indexing in the datasets behaves identically to the reference.

A copy of ``protosam_tpu/data/nifti.py`` (numpy, gzip and struct only), so
that this package needs no JAX.  ``read_nii`` counts the file's bytes
(``bytes_read``), the bytes it decompressed (``bytes_decoded``) and the
file (``files``) on the spans open around it (``utils/profiling.count``).
``header_info`` gives a file's metadata from its first ``HEADER_BYTES``
decompressed, for a reader that inflated them already.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from pathlib import Path

import numpy as np

from protosam_tpu_torch.utils import profiling

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    """Volume + the metadata subset the pipeline round-trips."""

    array: np.ndarray | None   # (z, y, x) [SimpleITK convention]; None
    #                            for the header's metadata alone
    spacing: tuple             # (sx, sy, sz) voxel size in mm
    origin: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    @property
    def shape(self):
        return self.array.shape


def _open(path: str | Path, mode: str = "rb"):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


HEADER_BYTES = 352   # the 348-byte header and the extension flag


@dataclasses.dataclass
class _Layout:
    """Where a file's voxels lie and how they scale."""

    shape_xyz: tuple
    dtype: np.dtype
    vox_offset: int
    scl_slope: float
    scl_inter: float


def _parse_header(hdr: bytes, path) -> tuple[_Layout, NiftiImage]:
    """The first ``HEADER_BYTES`` of a NIfTI-1 file -> (its voxels'
    layout, its metadata as a ``NiftiImage`` whose ``array`` is None)."""
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    if sizeof_hdr != 348:
        raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr}): "
                         f"{path}")
    dim = struct.unpack("<8h", hdr[40:56])
    ndim = dim[0]
    shape_xyz = dim[1:1 + max(ndim, 3)]
    datatype = struct.unpack("<h", hdr[70:72])[0]
    pixdim = struct.unpack("<8f", hdr[76:108])
    vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
    scl_slope = struct.unpack("<f", hdr[112:116])[0]
    scl_inter = struct.unpack("<f", hdr[116:120])[0]
    qoffset = struct.unpack("<3f", hdr[268:280])
    srow = struct.unpack("<12f", hdr[280:328])
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")

    sr = np.asarray(srow).reshape(3, 4)
    rot = sr[:, :3]
    sp = np.asarray(pixdim[1:4], np.float64)
    sp = np.where(sp == 0, 1.0, sp)
    with np.errstate(invalid="ignore", divide="ignore"):
        dirmat = np.where(sp[None, :] != 0, rot / sp[None, :], np.eye(3))
    if not np.isfinite(dirmat).all() or np.allclose(rot, 0):
        dirmat = np.eye(3)
    info = NiftiImage(
        array=None,
        spacing=tuple(float(s) for s in sp),
        origin=tuple(float(o) for o in qoffset),
        direction=tuple(float(d) for d in dirmat.reshape(-1)),
    )
    return _Layout(shape_xyz, np.dtype(_DTYPES[datatype]), vox_offset,
                   scl_slope, scl_inter), info


def header_info(hdr: bytes, path="") -> NiftiImage:
    """The metadata ``read_nii(..., peel_info=False)`` gives, from the
    first ``HEADER_BYTES`` of the file's (decompressed) bytes, as a
    ``NiftiImage`` whose ``array`` is None: what ``write_nii``'s ``ref``
    reads, without the voxels."""
    return _parse_header(hdr, path)[1]


def read_nii(path: str | Path, peel_info: bool = True):
    """Read a .nii / .nii.gz volume.

    Returns ndarray (z, y, x) if peel_info else NiftiImage — mirroring
    reference niftiio.read_nii_bysitk's peel_info flag (niftiio.py:10-25).
    """
    with _open(path) as f:
        layout, info = _parse_header(f.read(HEADER_BYTES), path)
        dtype = layout.dtype
        f.seek(layout.vox_offset)
        count = int(np.prod(layout.shape_xyz[:3]))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)
    profiling.count("bytes_read", os.path.getsize(path))
    profiling.count("bytes_decoded", layout.vox_offset + len(raw))
    profiling.count("files", 1)

    # on-disk is Fortran-order (x fastest); expose as (z, y, x)
    arr = data.reshape(layout.shape_xyz[:3][::-1])
    slope, inter = layout.scl_slope, layout.scl_inter
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr.astype(np.float32) * (slope if slope != 0.0 else 1.0) \
            + inter

    arr = np.ascontiguousarray(arr)
    if peel_info:
        return arr
    return dataclasses.replace(info, array=arr)


def write_nii(img: NiftiImage | np.ndarray, path: str | Path,
              ref: NiftiImage | None = None):
    """Write (z, y, x) data as .nii/.nii.gz, optionally copying metadata from
    a reference image (the reference's convert_to_sitk + WriteImage flow,
    niftiio.py:27-47)."""
    if isinstance(img, np.ndarray):
        img = NiftiImage(array=img,
                         spacing=ref.spacing if ref else (1.0, 1.0, 1.0),
                         origin=ref.origin if ref else (0.0, 0.0, 0.0),
                         direction=ref.direction if ref else
                         (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0))
    arr = np.ascontiguousarray(img.array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _CODES:
        arr = arr.astype(np.float32)
    code = _CODES[arr.dtype]

    z, y, x = arr.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, x, y, z, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)  # bitpix
    sx, sy, sz = img.spacing
    struct.pack_into("<8f", hdr, 76, 1.0, sx, sy, sz, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<h", hdr, 252, 1)       # sform_code
    d = np.asarray(img.direction).reshape(3, 3)
    sp = np.asarray(img.spacing)
    sr = (d * sp[None, :])
    srow = np.concatenate([sr, np.asarray(img.origin).reshape(3, 1)], axis=1)
    struct.pack_into("<3f", hdr, 268, *img.origin)
    struct.pack_into("<12f", hdr, 280, *srow.reshape(-1).astype(np.float32))
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00\x00\x00\x00")  # extension flag
        # disk order is Fortran (x fastest) == C-order of the (z,y,x) view
        f.write(arr.tobytes())
