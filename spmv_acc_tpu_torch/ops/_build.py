"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes plain C functions; it is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under the repo's
gitignored ``build/`` at first use, and loaded with ``ctypes``.  The library's
name carries a hash of the source and the command, so an edited source is
rebuilt and a stale build is never loaded.  ``build_all`` starts one ``nvcc``
per source at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

__all__ = ["CSRC_DIR", "BUILD_DIR", "SWELL_SRC", "TILE_SRC", "ELL_SRC", "PLANE_SRC", "SOURCES",
           "nvcc_path", "nvcc_command", "build", "build_all", "load_lib"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
SWELL_SRC = os.path.join(CSRC_DIR, "swell_spmv.cu")
TILE_SRC = os.path.join(CSRC_DIR, "tile_spmv.cu")
ELL_SRC = os.path.join(CSRC_DIR, "ell_rowsum.cu")
PLANE_SRC = os.path.join(CSRC_DIR, "plane_split.cu")

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# source -> {C entry: its argument types}; every entry returns a CUDA error code
SOURCES = {
    SWELL_SRC: {
        "swell_spmm": [_I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P,
                       _I64, _I64, _I64, _P],
        "swell_spmv_planes": [_I32, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P,
                              _I64, _I64, _I64, _P],
    },
    TILE_SRC: {"tile_spmv": [_I32, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _I64, _I64,
                             _P]},
    ELL_SRC: {"ell_rowsum": [_I32, _I32, _P, _P, _P, _P, _P, _I64, _I64, _P]},
    PLANE_SRC: {"plane_split": [_I32, _P, _P, _I64, _I64, _I64, _P]},
}

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # source path -> (seconds, compiler output) of builds in this process


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(src: str, out: str) -> list:
    """The nvcc invocation for one ``.cu`` file: Hopper ``sm_90a`` code, a shared
    library with a plain C interface; ``--ptxas-options=-v`` reports registers and spills."""
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v", "-o", out, src]


def build(src: str) -> str:
    """Compile ``src`` unless an up-to-date build exists; returns the ``.so`` path."""
    with open(src, "rb") as f:
        text = f.read()
    stem = os.path.splitext(os.path.basename(src))[0]
    tag = zlib.crc32(" ".join(nvcc_command(src, "")[1:]).encode(), zlib.crc32(text))
    out = os.path.join(BUILD_DIR, f"{stem}_{tag:08x}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    r = subprocess.run(nvcc_command(src, tmp), capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    build_log[src] = (time.perf_counter() - t0, r.stdout + r.stderr)
    return out


def build_all(srcs=tuple(SOURCES)) -> list:
    """``build`` every source in ``srcs``, one ``nvcc`` each, all started
    together; returns their ``.so`` paths in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(srcs))) as pool:
        return list(pool.map(build, srcs))


def load_lib(src: str):
    """The kernel library of one ``csrc`` source, built at first use, with its
    C entries' argument types set (``SOURCES``)."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build(src))
            for entry, argtypes in SOURCES[src].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[src] = lib
        return lib
