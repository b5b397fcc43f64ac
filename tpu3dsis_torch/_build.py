"""Build the hand-written CUDA kernels (and the host's chunk decoder) at
first use and bind them with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers), so
``nvcc`` builds each in seconds into a shared library of its own, all sources
at once in parallel. The libraries go to ``tpu3dsis_torch/_build/``, each
named by a hash of its source and the flags, so an edit to a source rebuilds
that library and an unchanged tree reuses it. A missing ``nvcc`` or a failed
build raises: there is no fallback. The host C++ chunk decoder
(``csrc/chunk_decoder.cpp``, no CUDA) is built the same way with ``g++``
(``build_host``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from types import SimpleNamespace

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "roi_pool3d.cu", CSRC / "roi_pool3d_bwd.cu", CSRC / "nms3d.cu", CSRC / "fuse_views.cu",
           CSRC / "fuse_views_bwd.cu")
# the headers the sources include (from csrc/, on nvcc's include path); each
# library's hash covers them all
HEADERS = (CSRC / "fuse_views_common.cuh",)
BUILD_DIR = _PKG / "_build"
# --fmad=false: the IoU, the bin bounds and the projections must round exactly
# as the plain PyTorch versions do, which never contract a multiply and an add
# into an FMA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the host library: no -march=native, since a build directory copied to
# another machine must still run there
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-fPIC", "-shared")
_host_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# every exported function: (argtypes, restype)
_SIGNATURES = {
    "tpu3dsis_roi_pool3d": ([_I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P], _I),
    "tpu3dsis_roi_pool3d_smem": ([_I, _I, _I], _LL),
    "tpu3dsis_roi_pool3d_launches": ([], _LL),
    "tpu3dsis_roi_pool3d_bwd": ([_I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P], _I),
    "tpu3dsis_roi_pool3d_bwd_threads": ([_I, _I], _I),
    "tpu3dsis_roi_pool3d_bwd_smem": ([_I, _I], _LL),
    "tpu3dsis_roi_pool3d_bwd_launches": ([], _LL),
    "tpu3dsis_roi_pool3d_bwd_counts": ([_P], _I),
    "tpu3dsis_nms3d": ([_P, _P, _P, _I, _I, _F, _P, _P], _I),
    "tpu3dsis_nms3d_smem": ([_I, _I], _LL),
    "tpu3dsis_nms3d_launches": ([], _LL),
    "tpu3dsis_fuse_views": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _P, _P],
                            _I),
    "tpu3dsis_fuse_views_smem": ([_I], _LL),
    "tpu3dsis_fuse_views_launches": ([], _LL),
    "tpu3dsis_fuse_views_bwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                 _F, _P, _P, _P, _P], _I),
    "tpu3dsis_fuse_views_bwd_smem": ([_I, _I], _LL),
    "tpu3dsis_fuse_views_bwd_launches": ([], _LL),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}: cannot build kernels")
    return nvcc


def nvcc_command(nvcc: str, src: Path, out: Path) -> list:
    """The compile of one source into a shared library, csrc/ on the include
    path (a probe's edited copy of a source lives elsewhere)."""
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def _library_path(src: Path, flags=NVCC_FLAGS, headers=HEADERS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    for header in headers:
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build() -> tuple[list[Path], str]:
    """Compile every source whose library is missing, all in parallel.

    Returns (library paths, compiler logs; empty for libraries that existed).
    Each build writes to a temporary name and renames, so concurrent builds
    are safe.
    """
    paths = [_library_path(src) for src in SOURCES]
    todo = [(src, path) for src, path in zip(SOURCES, paths) if not path.exists()]
    if not todo:
        return paths, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for src, path in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = nvcc_command(nvcc, src, Path(tmp))
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, proc, tmp, path))
        logs = []
        for cmd, proc, tmp, path in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            os.replace(tmp, path)
            logs.append(out)
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths, "".join(logs)


def build_host(src: Path) -> Path:
    """Compile a host C++ source (no CUDA) with ``g++`` (or ``$CXX``) into
    its hashed library under ``_build/``, unless it is there; returns its
    path. Written to a temporary name and renamed, so processes that build
    at once are safe; a missing compiler or a failed build raises."""
    path = _library_path(src, HOST_CXX_FLAGS, ())
    with _host_lock:
        if path.exists():
            return path
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError(f"no C++ compiler (g++ or $CXX): cannot build {src.name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [cxx, *HOST_CXX_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"host build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


@functools.cache
def load_library() -> SimpleNamespace:
    """The kernels' exported functions, built if needed, every signature
    declared, as attributes of one namespace."""
    paths, _ = build()
    libs = [ctypes.CDLL(str(p)) for p in paths]
    fns = {}
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = restype
        fns[name] = fn
    return SimpleNamespace(libraries=libs, **fns)


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
