"""The ``vector_row`` strategy on PyTorch: row sums over the padded ELL slab in a
hand-written Hopper kernel, and their plain PyTorch version.

Counterpart of ``spmv_acc_tpu/ops/vector_row.py``.  There the gather
``x[ell.col_idx]`` ran in XLA before a Pallas row-sum kernel, because Mosaic
has no general gather; here ``ell_rowsum`` reads the column of each cell and
gathers x inside the kernel (``csrc/ell_rowsum.cu``), with a vector of ``vs``
lanes per row that stops at the row's ``ELL.row_len`` cells, and sums in FP64
for float64 and float32 alike.  On a CPU tensor it runs ``ell_rowsum_plain``.
There is no fallback from one to the other.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .xla import axpby_finish

__all__ = ["LAUNCHES", "vector_size", "ell_rowsum", "ell_rowsum_plain", "spmv_vector_row"]

# Kernel launches in this process by (dtype, vs); set to 0 (``.clear()``) to
# count a run.  Only the kernel's launch site adds to it.
LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = {torch.float64: "f64", torch.float32: "f32"}

# 16-B vectors each lane of a row's vector is given at least (vector_size)
LANE_VECTORS = 2


def vector_size(width: int, itemsize: int) -> int:
    """Lanes of the vector that owns one ELL row of ``width`` cells of
    ``itemsize``-byte values: the largest power of two within [2, 32] that
    leaves every lane at least ``LANE_VECTORS`` of the row's 16-B vectors
    (2 values in float64, 4 in float32).

    The reference sizes its vectors by powers of two over row-length bands
    (hip-vector-row/vector_row.cpp:15-27).  The kernel loads 16 B at a time, so
    the bands count vectors.  The rule gives the fastest of 2..32 lanes in the
    H100 sweep of ``chip_smoke.py`` (PERF.md): width 40 -> 8 lanes in
    float64 (boneS10, Ga41As41H72) and 4 in float32 (boneS10), 448 -> 32
    (TSOPF_RS_b2383); af23560 (width 24 -> 4) is too small to tell."""
    vectors = width * itemsize // 16
    vs = 2
    while vs < 32 and 2 * vs * LANE_VECTORS <= vectors:
        vs *= 2
    return vs


def _check(ell, x, name) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch.Tensor, got {type(x).__name__}")
    if x.dtype != ell.values.dtype:
        raise ValueError(f"{name}: x is {x.dtype}, the ELL values {ell.values.dtype}")
    if x.dim() != 1 or x.shape[0] != ell.shape[1]:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, the matrix {ell.shape[1]} "
                         f"columns")
    if x.device != ell.values.device:
        raise ValueError(f"{name}: x is on {x.device}, the ELL on {ell.values.device}")


def _launch(ell, x: torch.Tensor, vs: int) -> torch.Tensor:
    """Row sums of a CUDA ELL slab: one kernel launch with ``vs`` lanes per row
    (``ell_rowsum`` takes ``vector_size``; the on-card test covers each).  The
    kernel reads each row's ``row_len`` cells, or the whole width where the
    slab has no ``row_len``."""
    from ._build import ELL_SRC, load_lib

    named = [("values", ell.values), ("col_idx", ell.col_idx), ("x", x)]
    if ell.row_len is not None:
        named.append(("row_len", ell.row_len))
        if ell.row_len.dtype != torch.int32 or tuple(ell.row_len.shape) != (ell.padded_rows,):
            raise ValueError(f"ell_rowsum: row_len must be int32 of shape ({ell.padded_rows},), "
                             f"got {ell.row_len.dtype} {tuple(ell.row_len.shape)}")
        if ell.row_len.device != x.device:
            raise ValueError(f"ell_rowsum: row_len is on {ell.row_len.device}, x on {x.device}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"ell_rowsum: {name} must be contiguous")
    if ell.col_idx.dtype != torch.int32:
        raise ValueError(f"ell_rowsum: col_idx must be int32, got {ell.col_idx.dtype}")
    lib = load_lib(ELL_SRC)
    y = torch.empty(ell.padded_rows, dtype=ell.values.dtype, device=x.device)
    ptr = ctypes.c_void_p
    lens = None if ell.row_len is None else ell.row_len.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ell_rowsum(int(ell.values.dtype == torch.float64), vs,
                            ptr(ell.values.data_ptr()), ptr(ell.col_idx.data_ptr()), ptr(lens),
                            ptr(x.data_ptr()), ptr(y.data_ptr()), ell.padded_rows, ell.width,
                            ptr(stream))
    if rc != 0:
        raise RuntimeError(f"ELL row-sum kernel launch failed: CUDA error {rc}")
    LAUNCHES[(_DTYPES[ell.values.dtype], vs)] += 1
    return y


def ell_rowsum_plain(ell, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: (m_pad,) row sums of
    ``values * x[col_idx]`` over the whole slab, padding included, in float64,
    cast to the values' dtype.  The CPU path of ``ell_rowsum`` and the kernel's
    reference."""
    _check(ell, x, "ell_rowsum_plain")
    if ell.shape[1] == 0:  # padding cells hold column 0, which an empty x lacks
        return ell.values.new_zeros(ell.padded_rows)
    prod = ell.values.double() * x.double()[ell.col_idx.long()]
    return prod.sum(1).to(ell.values.dtype)


def ell_rowsum(ell, x: torch.Tensor) -> torch.Tensor:
    """(m_pad,) row sums of ``values * x[col_idx]`` over an ELL slab, in the
    values' dtype (float64 or float32).  Launches the Hopper kernel, with
    ``vector_size(width, itemsize)`` lanes per row, for a CUDA ``x`` and runs the plain
    version for a CPU ``x``; any other device raises.  A matrix with no columns
    gives zeros on either device."""
    _check(ell, x, "ell_rowsum")
    if ell.values.dtype not in _DTYPES:
        raise ValueError(f"ell_rowsum runs float64 and float32, not {ell.values.dtype}")
    if x.device.type == "cuda":
        if ell.shape[1] == 0:
            return ell.values.new_zeros(ell.padded_rows)
        return _launch(ell, x, vector_size(ell.width, ell.values.element_size()))
    if x.device.type == "cpu":
        return ell_rowsum_plain(ell, x)
    raise NotImplementedError(f"vector_row has no kernel for device {x.device}")


def spmv_vector_row(alpha, beta, ell, x, y, num_rows):
    """Strategy entry, as ``xla.spmv_ell``: the row sums of the ELL slab (the
    one ``dispatch`` caches), then y_out = alpha*A@x + beta*y."""
    return axpby_finish(alpha, beta, ell_rowsum(ell, x)[:num_rows], y)
