"""CPU golden model — the ground truth everything else is verified against.

Mirrors the reference's host loop ``host_spmv`` (cli/verification.cpp:56-78), the
same numpy code as the JAX package's ``spmv_acc_tpu/ops/golden.py``.  Tensors are
accepted and read back to the host.
"""

from __future__ import annotations

import numpy as np

from ..utils.host import host_array

__all__ = ["host_spmv", "host_spmv_plain", "host_spmm"]


def host_spmv(alpha, beta, row_ptr, col_idx, values, x, y):
    """y_out = alpha*A*x + beta*y (cli/verification.cpp:56-66). Vectorised numpy."""
    row_ptr = host_array(row_ptr)
    col_idx = host_array(col_idx)
    values = host_array(values).astype(np.float64, copy=False)
    x = host_array(x).astype(np.float64, copy=False)
    y = host_array(y).astype(np.float64, copy=False)
    m = len(row_ptr) - 1
    prod = values * x[col_idx]
    # row-wise sums via reduceat (empty rows produce garbage from reduceat; mask them)
    lens = np.diff(row_ptr)
    sums = np.zeros(m, dtype=np.float64)
    nz_rows = lens > 0
    if prod.size:
        starts = row_ptr[:-1][nz_rows]
        sums[nz_rows] = np.add.reduceat(prod, starts)
    return alpha * sums + beta * y


def host_spmv_plain(row_ptr, col_idx, values, x):
    """y = A*x (cli/verification.cpp:68-78)."""
    m = len(host_array(row_ptr)) - 1
    return host_spmv(1.0, 0.0, row_ptr, col_idx, values, x, np.zeros(m))


def host_spmm(alpha, beta, row_ptr, col_idx, values, X, Y):
    """Multi-RHS golden: Y_out = alpha*A@X + beta*Y, X of shape (n, k)."""
    row_ptr = host_array(row_ptr)
    col_idx = host_array(col_idx)
    values = host_array(values).astype(np.float64, copy=False)
    X = host_array(X).astype(np.float64, copy=False)
    Y = host_array(Y).astype(np.float64, copy=False)
    m = len(row_ptr) - 1
    prod = values[:, None] * X[col_idx]  # (nnz, k)
    lens = np.diff(row_ptr)
    out = np.zeros((m, X.shape[1]), dtype=np.float64)
    nz = lens > 0
    if prod.size:
        out[nz] = np.add.reduceat(prod, row_ptr[:-1][nz], axis=0)
    return alpha * out + beta * Y
