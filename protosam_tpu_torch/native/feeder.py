"""ctypes bindings for the native NIfTI feeder (``nifti_feeder.cc``; JAX
``native/feeder.py``).

The file is read here (``gzip`` for ``.nii.gz``) and its bytes are parsed
by one C entry, ``nf_parse_volume``, so the library needs no zlib.  The
library builds with g++ at first use (``native/build.py``); a build that
fails raises.  ``calls`` counts the calls into the library, so a caller
can show which ingest path ran.  The calls release the interpreter, so
scans load in parallel on threads.
"""

from __future__ import annotations

import ctypes
import functools
import gzip
import os
import threading

import numpy as np

from protosam_tpu_torch.data import nifti
from protosam_tpu_torch.native import build
from protosam_tpu_torch.utils import profiling

calls = 0

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("nifti_feeder")
    lib.nf_parse_volume.restype = ctypes.c_int
    lib.nf_parse_volume.argtypes = [
        ctypes.c_char_p, _I64, ctypes.POINTER(_I64), _FLOAT_P,
        ctypes.POINTER(_FLOAT_P)]
    lib.nf_preprocess.restype = ctypes.c_int
    lib.nf_preprocess.argtypes = [_FLOAT_P, _I64, _I64, _I64, _I64,
                                  ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float, _FLOAT_P]
    lib.nf_resize_nearest.restype = ctypes.c_int
    lib.nf_resize_nearest.argtypes = [_FLOAT_P, _I64, _I64, _I64, _I64,
                                      _FLOAT_P]
    lib.nf_free.restype = None
    lib.nf_free.argtypes = [_FLOAT_P]
    return lib


_calls_lock = threading.Lock()


def _call(name: str, *args) -> int:
    global calls
    rc = getattr(_lib(), name)(*args)
    with _calls_lock:
        calls += 1
    return rc


def native_available() -> bool:
    """Whether the native path can run: False only where no g++ is
    installed.  Builds the library; a compile that fails raises."""
    if build.compiler() is None:
        return False
    _lib()
    return True


def read_volume_native(path: str, info: bool = False, parent=None):
    """-> (array (z, y, x) float32, spacing (sx, sy, sz)), and with
    ``info`` the file's metadata as ``read_nii(..., peel_info=False)``
    gives it, from the same decompressed bytes (``nifti.header_info``: a
    ``NiftiImage`` whose ``array`` is None).  One ``data.decode`` span
    (under ``parent`` where given), which counts the file's bytes
    (``bytes_read``), the bytes decompressed (``bytes_decoded``) and the
    file (``files``)."""
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with profiling.span("data.decode", parent=parent,
                        file=os.path.basename(path)):
        with opener(path, "rb") as f:
            raw = f.read()
        profiling.count("bytes_read", os.path.getsize(path))
        profiling.count("bytes_decoded", len(raw))
        profiling.count("files", 1)
        dims = (_I64 * 3)()
        spacing = (ctypes.c_float * 3)()
        data = _FLOAT_P()
        rc = _call("nf_parse_volume", raw, len(raw), dims, spacing,
                   ctypes.byref(data))
        if rc != 0:
            raise IOError(f"nf_parse_volume({path}) failed with code {rc}")
        z, y, x = dims[0], dims[1], dims[2]
        arr = np.ctypeslib.as_array(data, shape=(z, y, x)).copy()
        _lib().nf_free(data)
        if info:
            return arr, tuple(spacing), nifti.header_info(
                raw[:nifti.HEADER_BYTES], path)
    return arr, tuple(spacing)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_FLOAT_P)


def preprocess_volume_native(vol: np.ndarray, out_hw: int, modality: str,
                             ct_mean: float = 0.0, ct_std: float = 1.0
                             ) -> np.ndarray:
    """Per-slice bilinear resize + normalization, C++ single pass."""
    vol = np.ascontiguousarray(vol, np.float32)
    z, y, x = vol.shape
    out = np.empty((z, out_hw, out_hw), np.float32)
    mode = 1 if modality == "MR" else 0
    rc = _call("nf_preprocess", _ptr(vol), z, y, x, out_hw, mode, ct_mean,
               ct_std, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"nf_preprocess failed with code {rc}")
    return out


def resize_labels_native(vol: np.ndarray, out_hw: int) -> np.ndarray:
    """Per-slice nearest resize (torch's legacy floor) of a label volume."""
    vol = np.ascontiguousarray(vol, np.float32)
    z, y, x = vol.shape
    out = np.empty((z, out_hw, out_hw), np.float32)
    rc = _call("nf_resize_nearest", _ptr(vol), z, y, x, out_hw, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"nf_resize_nearest failed with code {rc}")
    return out
