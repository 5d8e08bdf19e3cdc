"""Build and load the hand-written Hopper kernels of ``csrc/``.

The CUDA sources compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use into ``protosam_tpu_torch/_build/``, keyed on a hash of the sources
and flags, so an edited ``.cu`` rebuilds and an unchanged one loads at once.
Nothing is built or imported while this module is imported.

The op wrappers (``ops/norm.layer_norm_rows``,
``ops/attention.masked_flash_attention_packed``, ``ops/cca.label_components``,
``ops/vitdet_flash.relpos_patch_attention``, ``ops/alp.alp_match_fused``,
``ops/mlp.dense_residual``, ``ops/mlp.mlp_fused``, ``ops/quant.quantize_rows``,
``ops/quant.int8_matmul_dequant``) allocate outputs with
``torch.empty``, launch through ``launch`` on their tensors' device and its
current stream, and raise on a non-zero ``cudaGetLastError()``.
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

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC")

F32, BF16 = 0, 1
_DTYPE_CODES = {torch.float32: F32, torch.bfloat16: BF16}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                  ctypes.c_float)
# C entry points: argument types, in order (every one returns an int error)
_SIGNATURES = {
    "ptk_layer_norm_rows": (_P, _P, _P, _P, _L, _I, _F, _I, _I, _P),
    "ptk_packed_masked_attention": (_P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                                    _P),
    "ptk_relpos_patch_attention": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                   _I, _P),
    "ptk_cca_label": (_P, _P, _P, _I, _I, _I, _P),
    "ptk_alp_match": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ptk_dense_residual": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    "ptk_mlp_fused": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    "ptk_quantize_rows": (_P, _P, _P, _L, _I, _I, _P),
    "ptk_int8_dense": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def sources() -> list[pathlib.Path]:
    return sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprotosam_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into the keyed shared library (no-op when it
    exists).  Each ``.cu`` compiles in its own ``nvcc`` process, in
    parallel, then one link; the result is renamed into place atomically so
    processes building at the same time never load a half-written file."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            if src.suffix != ".cu":
                continue
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c",
                 str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        part = pathlib.Path(tmp) / lib.name
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                        str(part)], check=True, capture_output=True)
        os.replace(part, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ptk_error_string.argtypes = [ctypes.c_int]
    lib.ptk_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry point ``name`` on ``device``, the device of its tensors
    (``check_cuda`` returns it), with that device's current stream appended
    as the last argument, and raise if it reports a CUDA error.  The call
    runs under ``torch.cuda.device(device)``, so ``cudaFuncSetAttribute`` and
    the launch act on the tensors' card whatever the current one is."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, stream(device))
    if err:
        msg = lib.ptk_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def stream(device: torch.device) -> int:
    """The current stream of ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Validate what a kernel's pointers may point at: CUDA, contiguous,
    16-byte aligned, all on one device.  Returns that device, the one the
    kernel must launch on (``launch(..., device=)``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor is not 16-byte aligned")
    return dev
