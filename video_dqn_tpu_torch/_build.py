"""Build and load the port's native libraries.

Two shared libraries with plain C interfaces, each built at first use from
the sources in the package only, into _build/, and loaded with ctypes:
  * the CUDA kernels: every csrc/*.cu (resize+normalize, NMS, NV12 -> RGB),
    compiled by nvcc for sm_90a into _build/libvdqn_kernels.so (`build`,
    `load`);
  * the host library: every csrc/host/*.cc (the JPEG decode stage, the
    JPEG writer, the LZ4 frame decoder, the FMM solver, the fake env's
    raycaster, the mesh simulator's BVH raycaster, the MP4 demuxer and the
    H.264 decoder),
    compiled by the system C++ compiler into
    _build/libvdqn_host.so (`build_host`, `load_host`).
Each source compiles in a compiler process of its own, all started
together, and the objects are then linked into the library.
Each is rebuilt when it is older than one of its sources. A file lock
keeps two processes from building the same library at once, and each
build writes a temporary file of its own that replaces the library in one
rename. A failed build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# -march=native as the JAX package's native/ Makefiles build: with FMA the
# compiler contracts a*b + c, and the FMM and the raycaster then give the
# JAX package's bits
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "c++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++) found: the host library cannot be built")
    return cxx


@dataclass
class _Library:
    path: Path
    source_dir: Path
    patterns: Tuple[str, ...]  # sources first, then the headers they include
    compile: Callable[[Path, Path], List[str]]  # (source, object) -> command
    link: Callable[[Path, List[Path]], List[str]]  # (library, objects) -> command
    # C entry -> (argtypes, restype)
    signatures: Dict[str, Tuple[list, type]]
    handle: object = field(default=None, repr=False)
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def sources(self) -> List[Path]:
        return sorted(self.source_dir.glob(self.patterns[0]))

    def stale(self) -> bool:
        if not self.path.exists():
            return True
        newest = max(p.stat().st_mtime for pattern in self.patterns
                     for p in self.source_dir.glob(pattern))
        return self.path.stat().st_mtime < newest

    def build(self) -> str:
        """Compile the sources into the library and return the compiler's
        output. Raises on failure."""
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{os.getpid()}.{threading.get_ident()}"
        tmp = self.path.with_name(f"{self.path.name}.{tag}.tmp")
        sources = self.sources()
        objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        try:
            procs = [(src, subprocess.Popen(self.compile(src, obj), stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
                     for src, obj in zip(sources, objects)]
            output, failed = "", []
            for src, proc in procs:
                text = proc.communicate()[0]
                output += text
                if proc.returncode != 0:
                    failed.append(f"{src.name} (code {proc.returncode}):\n{text}")
            if failed:
                raise RuntimeError(f"building {self.path.name} failed: " + "\n".join(failed))
            proc = subprocess.run(self.link(tmp, objects), capture_output=True, text=True)
        finally:
            for obj in objects:
                obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {self.path.name} failed with code "
                               f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, self.path)
        return output + proc.stdout + proc.stderr

    def load(self) -> ctypes.CDLL:
        """The library, built first if it is missing or older than a
        source."""
        with self.lock:
            if self.handle is None:
                BUILD_DIR.mkdir(exist_ok=True)
                with open(BUILD_DIR / f"{self.path.name}.lock", "w") as lock_file:
                    fcntl.flock(lock_file, fcntl.LOCK_EX)
                    if self.stale():
                        self.build()
                    lib = ctypes.CDLL(str(self.path))
                for name, (argtypes, restype) in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                self.handle = lib
        return self.handle


# Each kernel entry takes one pointer to its argument struct
# (ops/resize_normalize.py `_IdentityArgs`, `_BandedArgs`;
# models/detector/boxes.py `_NmsArgs`; ops/nv12.py `_Nv12Args`).
KERNELS = _Library(
    BUILD_DIR / "libvdqn_kernels.so", CSRC, ("*.cu", "*.cuh"),
    lambda src, obj: [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
    lambda out, objs: [_nvcc(), "-shared", "-o", str(out), *map(str, objs)],
    {"vdqn_resize_normalize_identity": ([ctypes.c_void_p], ctypes.c_int),
     "vdqn_resize_normalize_banded": ([ctypes.c_void_p], ctypes.c_int),
     "vdqn_nms": ([ctypes.c_void_p], ctypes.c_int),
     "vdqn_nv12_rgb": ([ctypes.c_void_p], ctypes.c_int)})
HOST = _Library(
    BUILD_DIR / "libvdqn_host.so", CSRC / "host", ("*.cc", "*.h"),
    lambda src, obj: [_cxx(), *CXX_FLAGS, "-c", "-o", str(obj), str(src)],
    lambda out, objs: [_cxx(), "-shared", "-pthread", "-o", str(out), *map(str, objs)],
    {"vdqn_jpeg_decode_batch": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
     "vdqn_jpeg_encode_batch": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int],
                                ctypes.c_int),
     "vdqn_lz4_frame_decode": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int64], ctypes.c_int64),
     "vdqn_fmm_distance": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], None),
     "vdqn_fmm_distance_bounded": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_void_p], None),
     "vdqn_render_views": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                            ctypes.c_double, ctypes.c_double, ctypes.c_double,
                            ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
                            ctypes.c_void_p], None),
     "vdqn_mesh_create": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p], ctypes.c_void_p),
     "vdqn_mesh_destroy": ([ctypes.c_void_p], None),
     "vdqn_mesh_bounds": ([ctypes.c_void_p, ctypes.c_void_p], None),
     "vdqn_mesh_render": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_double, ctypes.c_double, ctypes.c_double,
                           ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p], None),
     "vdqn_mesh_floor_probe": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                                ctypes.c_void_p, ctypes.c_void_p], None),
     "vdqn_mesh_floor_levels": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_double, ctypes.c_double,
                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p], None),
     "vdqn_mesh_column_blocked": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                                   ctypes.c_void_p], None),
     "vdqn_mesh_raycast": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p], None),
     "vdqn_mp4_open": ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int],
                       ctypes.c_void_p),
     "vdqn_mp4_info": ([ctypes.c_void_p, ctypes.c_void_p], None),
     "vdqn_mp4_samples": ([ctypes.c_void_p] * 6, None),
     "vdqn_mp4_read": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                        ctypes.c_int], ctypes.c_int64),
     "vdqn_mp4_close": ([ctypes.c_void_p], None),
     "vdqn_h264_open": ([], ctypes.c_void_p),
     "vdqn_h264_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
     "vdqn_h264_info": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p], ctypes.c_int),
     "vdqn_h264_copy": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                         ctypes.c_void_p, ctypes.c_int64], ctypes.c_int),
     "vdqn_h264_release": ([ctypes.c_void_p, ctypes.c_int64], None),
     "vdqn_h264_close": ([ctypes.c_void_p], None)})
LIB = KERNELS.path
HOST_LIB = HOST.path


def build() -> str:
    """Compile csrc/*.cu into LIB and return nvcc's output (the ptxas
    register and shared-memory lines). Raises on failure."""
    return KERNELS.build()


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    return KERNELS.load()


def build_host() -> str:
    """Compile csrc/host/*.cc into HOST_LIB. Raises on failure."""
    return HOST.build()


def load_host() -> ctypes.CDLL:
    """The host library, built first if it is missing or stale."""
    return HOST.load()
