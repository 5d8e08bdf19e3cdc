"""Build and load the host C++ libraries of ``native/`` with g++.

Each ``<name>.cc`` compiles with ``g++ -O3 -shared -fPIC`` into
``protosam_tpu_torch/_build/``, keyed on a hash of its source and the
flags (as ``kernels.py`` keys the CUDA library), so an edited source
rebuilds and an unchanged one loads at once.  The build runs at first use,
never while a module is imported.  A compile that fails raises with g++'s
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")


def compiler() -> str | None:
    """The C++ compiler the libraries build with, or None where none is
    installed."""
    return shutil.which("g++")


def library_path(name: str) -> pathlib.Path:
    src = NATIVE_DIR / f"{name}.cc"
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``native/<name>.cc`` into its keyed library (a no-op when it
    exists).  The result is renamed into place, so processes building at
    once never load a half-written file."""
    lib = library_path(name)
    if lib.exists():
        return lib
    gxx = compiler()
    if gxx is None:
        raise RuntimeError(f"g++ not found: native/{name}.cc cannot build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        part = pathlib.Path(tmp) / lib.name
        proc = subprocess.run(
            [gxx, *FLAGS, str(NATIVE_DIR / f"{name}.cc"), "-o", str(part)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on native/{name}.cc:\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(part, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cc``, built on first call."""
    return ctypes.CDLL(str(build(name)))
