"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` builds them in seconds into one shared library. The library goes to
``tpu3dsis_torch/_build/``, named by a hash of the sources and flags, so an
edit to a source triggers a rebuild and an unchanged tree reuses the library.
A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "roi_pool3d.cu", _PKG / "csrc" / "nms3d.cu")
BUILD_DIR = _PKG / "_build"
# --fmad=false: the IoU and the bin bounds must round exactly as the plain
# PyTorch versions do, which never contract a multiply and an add into an FMA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build kernels")
    return nvcc


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu3dsis_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if the library for these sources is missing.

    Returns (library path, compiler log; empty when the library existed).
    Writes to a temporary name and renames, so concurrent builds are safe.
    """
    path = _library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, res.stdout + res.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with every signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.tpu3dsis_roi_pool3d.argtypes = [
        _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _F, _F, _F, _I, _P, _P,
    ]
    lib.tpu3dsis_roi_pool3d.restype = _I
    lib.tpu3dsis_nms3d.argtypes = [_P, _P, _I, _I, _F, _P, _P, _P]
    lib.tpu3dsis_nms3d.restype = _I
    lib.tpu3dsis_nms3d_scan_smem.argtypes = [_I]
    lib.tpu3dsis_nms3d_scan_smem.restype = ctypes.c_longlong
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
