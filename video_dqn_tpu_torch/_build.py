"""Build and load the port's CUDA kernels.

Every csrc/*.cu is compiled by nvcc for sm_90a into one shared library
with a plain C interface, _build/libvdqn_kernels.so, at first use and
from the sources in the package only; ctypes loads it. A failed build or
load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB = BUILD_DIR / "libvdqn_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()

# Each kernel entry takes one pointer to its argument struct
# (ops/resize_normalize.py `_IdentityArgs`, `_BandedArgs`).
_SIGNATURES = {
    "vdqn_resize_normalize_identity": [ctypes.c_void_p],
    "vdqn_resize_normalize_banded": [ctypes.c_void_p],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build() -> str:
    """Compile csrc/*.cu into LIB and return the compiler's output (the
    ptxas register and shared-memory lines). Raises on failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB)
    return proc.stdout + proc.stderr


def _stale() -> bool:
    if not LIB.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return LIB.stat().st_mtime < newest


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or older than a
    source."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
