"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes plain C functions; it is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under the repo's gitignored
``build/`` at first use, and loaded with ``ctypes``.  The library's name carries
a hash of the source and the command, so an edited source is rebuilt and a
stale build is never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
import zlib

__all__ = ["CSRC_DIR", "BUILD_DIR", "SWELL_SRC", "nvcc_path", "nvcc_command", "build", "load_swell_lib"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
SWELL_SRC = os.path.join(CSRC_DIR, "swell_spmv.cu")

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
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    r = subprocess.run(nvcc_command(src, tmp), capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    build_log[src] = (time.perf_counter() - t0, r.stdout + r.stderr)
    return out


def load_swell_lib():
    """The swell kernel library (``swell_spmm``), built at first use."""
    with _lock:
        lib = _libs.get(SWELL_SRC)
        if lib is None:
            lib = ctypes.CDLL(build(SWELL_SRC))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.swell_spmm.argtypes = [i32, i32, i32, p, p, p, p, p, p, p, p,
                                       i64, i64, i64, i64, p]
            lib.swell_spmm.restype = ctypes.c_int
            _libs[SWELL_SRC] = lib
        return lib
