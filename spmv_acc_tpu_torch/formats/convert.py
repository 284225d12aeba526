"""Host-side (numpy) format conversions, the same functions as the JAX package's
``spmv_acc_tpu/formats/convert.py`` (reference ``cli/sparse_format.h:100-128``).
``csr_to_ell`` and ``csr_to_bsr`` put their result on the CSR's device."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .containers import BSR, CSR, ELL

__all__ = ["coo_to_csr_arrays", "csr_transpose_arrays", "csr_to_dense", "csr_to_ell_arrays",
           "csr_to_ell", "csr_to_bsr"]


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


def csr_to_dense(row_ptr, col_idx, values, shape) -> np.ndarray:
    m, n = shape
    row_ptr = np.asarray(row_ptr)
    dense = np.zeros((m, n), dtype=np.asarray(values).dtype)
    rows = np.repeat(np.arange(m), np.diff(row_ptr))
    dense[rows, np.asarray(col_idx)] = np.asarray(values)
    return dense


def csr_to_ell_arrays(row_ptr, col_idx, values, shape, width_multiple=8, sublanes=8):
    """Pad each row to a uniform width (multiple of ``width_multiple``) and the
    rows to a multiple of ``sublanes``; pad entries point at column 0 with value
    0 (the vector-per-row analog, hip-vector-row/vector_row.cpp:15-27).
    Returns (ell_cols, ell_vals, width, padded_rows)."""
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    values = np.asarray(values)
    m = shape[0]
    lens = np.diff(row_ptr)
    width = int(lens.max()) if m else 0
    width = max(width_multiple, -(-width // width_multiple) * width_multiple)
    mp = max(sublanes, -(-m // sublanes) * sublanes)
    ell_cols = np.zeros((mp, width), dtype=np.int32)
    ell_vals = np.zeros((mp, width), dtype=values.dtype)
    if len(col_idx):
        rows = np.repeat(np.arange(m), lens)
        offs = np.arange(len(col_idx)) - np.repeat(row_ptr[:-1], lens)
        ell_cols[rows, offs] = col_idx
        ell_vals[rows, offs] = values
    return ell_cols, ell_vals, width, mp


def csr_to_ell(csr: CSR, width_multiple=8, sublanes=8) -> ELL:
    """The padded slab of ``csr_to_ell_arrays`` with each row's length
    (``np.diff(row_ptr)``, 0 on padded rows), on the CSR's device."""
    rp, ci, v, shape = csr.to_numpy()
    ec, ev, _, mp = csr_to_ell_arrays(rp, ci, v, shape, width_multiple, sublanes)
    row_len = np.zeros(mp, dtype=np.int32)
    row_len[: shape[0]] = np.diff(rp)
    dev = csr.device
    return ELL(torch.from_numpy(ec).to(dev), torch.from_numpy(ev).to(dev), csr.shape,
               torch.from_numpy(row_len).to(dev))


def csr_to_bsr(csr: CSR, blocksize=(8, 128)) -> BSR:
    """Group nnz into dense (bh, bw) blocks, zero-filled (host numpy)."""
    bh, bw = blocksize
    rp, ci, v, (m, n) = csr.to_numpy()
    mb, nb = -(-m // bh), -(-n // bw)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    ci = ci.astype(np.int64)
    key = (rows // bh) * nb + ci // bw
    uniq = np.unique(key)
    vals = np.zeros((len(uniq), bh, bw), dtype=v.dtype)
    vals[np.searchsorted(uniq, key), rows % bh, ci % bw] = v
    row_ptr = np.zeros(mb + 1, dtype=np.int32)
    np.cumsum(np.bincount(uniq // nb, minlength=mb), out=row_ptr[1:])
    dev = csr.device
    return BSR(torch.from_numpy(row_ptr).to(dev),
               torch.from_numpy((uniq % nb).astype(np.int32)).to(dev),
               torch.from_numpy(vals).to(dev), (mb * bh, nb * bw), (bh, bw))
