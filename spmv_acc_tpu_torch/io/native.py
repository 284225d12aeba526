"""ctypes access to the repo's native C++ host library (``native/spmv_native.cpp``),
the same shared ``native/libspmv_native.so`` the JAX package loads.

This is host code, not a device kernel: the swell analyze pass
(csr_adaptive_plus_analyze.cpp analog) in one OpenMP pass over row-blocks, the
tile analyze of ``adaptive_plus`` (one scan plus a sort of the block keys), and
the r x r block condense of the BSR plans.  The library is built with
``make -C native`` at first use; without a compiler the callers take their
numpy paths, which compute the same results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["get_lib", "tile_analyze_native", "swell_analyze_native", "bsr_condense_native",
           "available"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libspmv_native.so")
_LOCK_PATH = os.path.join(_ROOT, "build", "native.lock")
_ABI_VERSION = 5  # native/spmv_native.cpp spmv_native_abi_version()
_lock = threading.Lock()
_lib = None
_tried = False


# The Makefile's flags without -fopenmp: a compiler without OpenMP support (no
# libgomp) still builds the same library, serial (the source guards every pragma).
_SERIAL_FLAGS = "CXXFLAGS=-O3 -std=c++17 -fPIC -shared -Wall"


def _open():
    """The library at ``_LIB_PATH`` if it loads and has the expected ABI, else
    None.  A stale ABI is retried on a copy under a new path: re-CDLL of the
    same path returns the already-mapped handle even after a rebuild."""
    if not os.path.exists(_LIB_PATH):
        return None
    for load in (lambda: ctypes.CDLL(_LIB_PATH), _load_fresh):
        try:
            lib = load()
        except OSError:  # e.g. a file another process is still writing
            return None
        lib.spmv_native_abi_version.restype = ctypes.c_int32
        if lib.spmv_native_abi_version() == _ABI_VERSION:
            return lib
    return None


def _build() -> bool:
    """``make -C native`` under an exclusive lock file in ``build/``, into a
    temporary name moved into place, so concurrent processes (test workers)
    build the library once and no loader sees a half-written file."""
    import fcntl

    os.makedirs(os.path.dirname(_LOCK_PATH), exist_ok=True)
    with open(_LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _open() is not None:  # built by another process meanwhile
            return True
        tmp = f"libspmv_native.tmp{os.getpid()}.so"
        for extra in ([], [_SERIAL_FLAGS]):
            cmd = ["make", "-C", _NATIVE_DIR, "-s", f"TARGET={tmp}", *extra]
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                return False
            if r.returncode == 0 and os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
                os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
                return True
    return False


def _load_fresh():
    """CDLL via a temp copy: re-CDLL of the same path can return the already-
    mapped stale handle, so a rebuilt .so is loaded under a new path."""
    import shutil
    import tempfile

    tmp = tempfile.NamedTemporaryFile(prefix="spmv_native_", suffix=".so", delete=False)
    tmp.close()
    shutil.copy2(_LIB_PATH, tmp.name)
    return ctypes.CDLL(tmp.name)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _open()
        if lib is None:  # missing, half-written by a concurrent build, or stale
            if not _build():
                return None
            lib = _open()
            if lib is None:
                return None
        p = ctypes.c_void_p
        lib.tile_analyze.restype = ctypes.c_int64
        lib.tile_analyze.argtypes = [p, p, ctypes.c_int32, ctypes.c_int32, p, p, p, p]
        lib.swell_analyze.restype = ctypes.c_int64
        lib.swell_analyze.argtypes = [p, p, ctypes.c_int64, ctypes.c_int32, p, p, p, p,
                                      ctypes.c_int64, p, p, p, p, ctypes.c_int32]
        lib.bsr_count.restype = ctypes.c_int64
        lib.bsr_count.argtypes = [p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, p]
        lib.bsr_fill.restype = ctypes.c_int32
        lib.bsr_fill.argtypes = [p, p, p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                                 p, p, p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def tile_analyze_native(row_ptr, col_idx, m, nct):
    """Native tile analyze (``native/spmv_native.cpp::tile_analyze``): for the
    (128-row x 128-column)-window decomposition, every element's block key and
    slot, and each distinct block's depth.

    Returns (elem_block i64, elem_slot i32, block_keys i64 sorted, block_depth
    i32), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int32)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    nnz = int(row_ptr[-1])
    elem_block = np.empty(nnz, dtype=np.int64)
    elem_slot = np.empty(nnz, dtype=np.int32)
    block_keys = np.empty(max(nnz, 1), dtype=np.int64)
    block_depth = np.empty(max(nnz, 1), dtype=np.int32)
    nb = lib.tile_analyze(row_ptr.ctypes.data, col_idx.ctypes.data, m, nct,
                          elem_block.ctypes.data, elem_slot.ctypes.data,
                          block_keys.ctypes.data, block_depth.ctypes.data)
    return elem_block, elem_slot, block_keys[:nb], block_depth[:nb]


def swell_analyze_native(row_ptr, col_idx, m, delta):
    """Native swell analyze pass (OpenMP over row-blocks).

    Returns (slab_of_nnz i32, lidx u8, slot_in_slab u8, layer_k i8,
             slab_rb i32, slab_w i32, slab_k i8, slab_wide bool) or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    rp = np.ascontiguousarray(row_ptr, dtype=np.int64)
    ci = np.ascontiguousarray(col_idx, dtype=np.int32)
    nnz = int(rp[-1])
    if nnz == 0 or nnz >= 2**31:
        return None
    slab_of_nnz = np.empty(nnz, dtype=np.int32)
    lidx = np.empty(nnz, dtype=np.uint8)
    slot = np.empty(nnz, dtype=np.uint8)
    layer_k = np.empty(nnz, dtype=np.int8)
    cap = nnz
    slab_rb = np.empty(cap, dtype=np.int32)
    slab_w = np.empty(cap, dtype=np.int32)
    slab_k = np.empty(cap, dtype=np.int8)
    slab_wide = np.empty(cap, dtype=np.uint8)
    ns = lib.swell_analyze(
        rp.ctypes.data, ci.ctypes.data, m, delta,
        slab_of_nnz.ctypes.data, lidx.ctypes.data, slot.ctypes.data, layer_k.ctypes.data,
        cap, slab_rb.ctypes.data, slab_w.ctypes.data, slab_k.ctypes.data,
        slab_wide.ctypes.data, min(os.cpu_count() or 1, 16),
    )
    if ns < 0:
        return None
    return (slab_of_nnz, lidx, slot, layer_k,
            slab_rb[:ns].copy(), slab_w[:ns].copy(), slab_k[:ns].copy(),
            slab_wide[:ns].astype(bool))


def bsr_condense_native(rp, ci, v, m, r, mb):
    """Native r x r block condense (node-row-parallel r-way merge) of canonical
    float64 CSR.  Returns (rp_b int64 (mb+1,), ci_b int64, vals2d (nnzb, r*r)
    float64), or None for other value types, r outside [2, 16], or without the
    library."""
    if np.dtype(v.dtype) != np.float64 or not 2 <= r <= 16:
        return None
    lib = get_lib()
    if lib is None:
        return None
    rp = np.ascontiguousarray(rp, dtype=np.int64)
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.float64)
    rpb = np.zeros(mb + 1, dtype=np.int64)
    nnzb = lib.bsr_count(rp.ctypes.data, ci.ctypes.data, m, r, mb, rpb.ctypes.data)
    if nnzb < 0:
        return None
    cib = np.empty(nnzb, dtype=np.int64)
    vals2d = np.zeros((nnzb, r * r), dtype=np.float64)
    rc = lib.bsr_fill(rp.ctypes.data, ci.ctypes.data, v.ctypes.data, m, r, mb,
                      rpb.ctypes.data, cib.ctypes.data, vals2d.ctypes.data)
    if rc != 0:
        return None
    return rpb, cib, vals2d
