"""Host-side (numpy) format conversions, the same functions as the JAX package's
``spmv_acc_tpu/formats/convert.py`` (reference ``cli/sparse_format.h:100-128``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["coo_to_csr_arrays", "csr_transpose_arrays"]


def coo_to_csr_arrays(
    rows: np.ndarray, cols: np.ndarray, values: np.ndarray, shape: Tuple[int, int]
):
    """Sort (row, col) and build row_ptr by counting (cli/sparse_format.h:100-128).

    Duplicate (row, col) entries are summed.
    """
    m, _ = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values)
    order = np.lexsort((cols, rows))
    rows, cols, values = rows[order], cols[order], values[order]
    if len(rows) > 1:
        dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if dup.any():
            keep = np.concatenate(([True], ~dup))
            group = np.cumsum(keep) - 1
            values = np.bincount(group, weights=values, minlength=group[-1] + 1).astype(
                values.dtype, copy=False
            )
            rows, cols = rows[keep], cols[keep]
    counts = np.bincount(rows, minlength=m)
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return (
        row_ptr.astype(np.int32),
        cols.astype(np.int32),
        values,
    )


def csr_transpose_arrays(row_ptr, col_idx, values, shape):
    """Host transpose A^T: CSR(m,n) -> CSR(n,m).  Used for trans='T'."""
    m, n = shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(np.asarray(row_ptr)))
    return coo_to_csr_arrays(np.asarray(col_idx), rows, np.asarray(values), (n, m))
