"""Byte-compatible reader/writer for the reference's ``bin2`` binary CSR format.

On-disk layout (reference cli/csr_binary_reader.hpp:37-106, writer in
tools/suitesparse-dl/conv/mm_parser.go): little-endian
``int32 magic=0x20211015, int32 version=2, int32 value_type, int32 rows, int32 cols,
int32 nnz``, then ``row_ptr[rows+1] int32``, ``col_index[nnz] int32``, then the value
payload.  Value types: 1=bool (no payload; values are 1.0), 2=int32, 3=float64,
4=complex (read as float64 pairs; we keep the real part, matching dtype double).
"""

from __future__ import annotations

import struct

import numpy as np

from ..config import BIN2_MAGIC, BIN2_VERSION

__all__ = ["read_bin2", "write_bin2", "TP_BOOL", "TP_INT", "TP_FLOAT", "TP_COMPLEX"]

TP_BOOL, TP_INT, TP_FLOAT, TP_COMPLEX = 1, 2, 3, 4
_HEADER = struct.Struct("<6i")


def read_bin2(path, dtype=np.float64):
    """Returns (row_ptr, col_idx, values, shape)."""
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
        magic, version, val_type, rows, cols, nnz = _HEADER.unpack(raw)
        if magic != BIN2_MAGIC:
            raise ValueError(
                f"read file failed with mismatch magic number, file: {path}"
            )
        if version != BIN2_VERSION:
            raise ValueError(f"we only support bin file version 2, bin file: {path}")
        if val_type not in (TP_BOOL, TP_INT, TP_FLOAT, TP_COMPLEX):
            raise ValueError(f"matrix value type not supported, bin file: {path}")
        row_ptr = np.fromfile(f, dtype="<i4", count=rows + 1)
        col_idx = np.fromfile(f, dtype="<i4", count=nnz)
        if val_type == TP_BOOL:
            values = np.ones(nnz, dtype=dtype)
        elif val_type == TP_INT:
            values = np.fromfile(f, dtype="<i4", count=nnz).astype(dtype)
        elif val_type == TP_FLOAT:
            values = np.fromfile(f, dtype="<f8", count=nnz).astype(dtype, copy=False)
        else:  # TP_COMPLEX — stored as (real, imag) float64 pairs; real part only
            pairs = np.fromfile(f, dtype="<f8", count=2 * nnz)
            values = pairs[0::2].astype(dtype, copy=False)
    if len(row_ptr) != rows + 1 or len(col_idx) != nnz or len(values) != nnz:
        raise ValueError(f"truncated bin2 file: {path}")
    return row_ptr, col_idx, values, (rows, cols)


def write_bin2(path, row_ptr, col_idx, values, shape, val_type=TP_FLOAT):
    rows, cols = shape
    nnz = len(values)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(BIN2_MAGIC, BIN2_VERSION, val_type, rows, cols, nnz))
        np.asarray(row_ptr, dtype="<i4").tofile(f)
        np.asarray(col_idx, dtype="<i4").tofile(f)
        if val_type == TP_BOOL:
            pass
        elif val_type == TP_INT:
            np.asarray(values, dtype="<i4").tofile(f)
        elif val_type == TP_FLOAT:
            np.asarray(values, dtype="<f8").tofile(f)
        else:
            pairs = np.zeros(2 * nnz, dtype="<f8")
            pairs[0::2] = np.asarray(values, dtype=np.float64)
            pairs.tofile(f)
