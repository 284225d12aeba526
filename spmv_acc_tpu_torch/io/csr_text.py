"""Reader/writer for the reference's 4-line ``.csr`` text format.

Layout (reference cli/csr_mtx_reader.hpp:49-91): line 0 is a free-form header
(ignored by the reference reader), line 1 = space-separated values, line 2 = column
indices, line 3 = row_ptr, line 4 = the dense vector x.  ``rows = len(row_ptr)-1``,
``cols = len(x)``, ``nnz = len(values)`` (csr_mtx_reader.hpp:104-110).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["read_csr_text", "write_csr_text"]


def _parse_numbers(line: str, dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        try:
            arr = np.fromstring(line, dtype=np.float64, sep=" ")
        except Exception:
            arr = np.array(line.split(), dtype=np.float64)
    return arr.astype(dtype, copy=False)


def read_csr_text(path, dtype=np.float64):
    """Returns (row_ptr, col_idx, values, x, shape)."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    if len(lines) < 5:
        raise ValueError(f"csr text file {path!r} has fewer than 5 lines")
    values = _parse_numbers(lines[1], dtype)
    col_idx = _parse_numbers(lines[2], np.int32)
    row_ptr = _parse_numbers(lines[3], np.int32)
    x = _parse_numbers(lines[4], dtype)
    m = len(row_ptr) - 1
    n = len(x)
    if int(row_ptr[-1]) != len(values) or len(col_idx) != len(values):
        raise ValueError(
            f"inconsistent csr text file {path!r}: row_ptr[-1]={row_ptr[-1]}, "
            f"nnz(values)={len(values)}, nnz(cols)={len(col_idx)}"
        )
    return row_ptr, col_idx, values, x, (m, n)


def _fmt_floats(a):
    return " ".join(repr(float(v)) for v in a)


def write_csr_text(path, row_ptr, col_idx, values, x, header: str = "% csr"):
    with open(path, "w") as f:
        f.write(header + "\n")
        f.write(_fmt_floats(values) + "\n")
        f.write(" ".join(str(int(v)) for v in col_idx) + "\n")
        f.write(" ".join(str(int(v)) for v in row_ptr) + "\n")
        f.write(_fmt_floats(x) + "\n")
