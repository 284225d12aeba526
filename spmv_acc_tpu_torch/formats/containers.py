"""Sparse-matrix containers over torch tensors.

The port's counterpart of ``spmv_acc_tpu/formats/containers.py``: the reference's
``csr_desc<I,T>`` (``src/acc/api/types.h:8-41``) as three tensors on one device
plus the static shape, and the JAX package's BSR and ELL.  COO is still to port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["CSR", "BSR", "ELL", "sparse_operation"]


class sparse_operation:
    """Transpose flag enum (reference src/acc/api/types.h:8-10)."""

    SPARSE_OPERATION_NON_TRANSPOSE = "N"
    SPARSE_OPERATION_TRANSPOSE = "T"


def _as_tensor_nodowncast(values, device) -> torch.Tensor:
    """A tensor copy of ``values`` that refuses to narrow float values silently.

    A device without float64 support (or a caller passing ``dtype=``) must not
    quietly turn the f64 golden data into f32; cast explicitly instead."""
    arr = values if isinstance(values, torch.Tensor) else np.asarray(values)
    out = arr.to(device) if isinstance(arr, torch.Tensor) else torch.tensor(arr, device=device)
    src = arr.dtype.itemsize if isinstance(arr, np.ndarray) else arr.element_size()
    if out.is_floating_point() and out.element_size() < src:
        raise ValueError(
            f"silent float downcast {arr.dtype} -> {out.dtype}; cast values "
            f"explicitly (values.astype) before constructing the container"
        )
    return out


def _as_index(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


@dataclasses.dataclass(frozen=True)
class CSR:
    """CSR matrix: ``row_ptr`` (m+1, int32), ``col_idx`` (nnz, int32), ``values``
    (nnz, T), all on one device, with the static ``shape`` (types.h:12-27)."""

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def rows(self) -> int:
        return int(self.shape[0])

    @property
    def cols(self) -> int:
        return int(self.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def astype(self, dtype) -> "CSR":
        return CSR(self.row_ptr, self.col_idx, self.values.to(dtype), self.shape)

    def to(self, device) -> "CSR":
        """The same matrix on ``device`` (self when it is already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return CSR(self.row_ptr.to(device), self.col_idx.to(device),
                   self.values.to(device), self.shape)

    @staticmethod
    def from_numpy(row_ptr, col_idx, values, shape, device="cpu") -> "CSR":
        """Build from host arrays (copied); this is also the carry-over from the
        JAX package: ``CSR.from_numpy(*jax_csr.to_numpy())``."""
        return CSR(
            _as_index(row_ptr, device),
            _as_index(col_idx, device),
            _as_tensor_nodowncast(values, device),
            (int(shape[0]), int(shape[1])),
        )

    def to_numpy(self):
        return (
            self.row_ptr.cpu().numpy(),
            self.col_idx.cpu().numpy(),
            self.values.cpu().numpy(),
            self.shape,
        )


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-CSR with dense ``(bh, bw)`` blocks stored as ``values[nblocks, bh, bw]``
    (new scope relative to the reference, which is scalar CSR only)."""

    row_ptr: torch.Tensor  # (mb + 1,) int32 — block-row pointer
    col_idx: torch.Tensor  # (nblocks,) int32 — block-column index
    values: torch.Tensor   # (nblocks, bh, bw)
    shape: Tuple[int, int]  # element shape (m, n); multiples of (bh, bw)
    blocksize: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return int(self.values.shape[0])

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.blocksize[0]

    @property
    def nnz(self) -> int:
        """Stored element count (incl. explicit zeros inside blocks)."""
        return self.nblocks * self.blocksize[0] * self.blocksize[1]

    @property
    def device(self) -> torch.device:
        return self.values.device


@dataclasses.dataclass(frozen=True)
class ELL:
    """Row-padded ELLPACK slab: ``col_idx``/``values`` are ``(m_padded, width)``;
    padding entries point at column 0 with value 0, so gathers stay in bounds.
    ``row_len`` (int32, ``(m_padded,)``, 0 on padded rows) holds each row's
    stored cells, which lead the row; the ELL row-sum kernel reads only those.
    A slab without it is read whole.  Produced by
    :func:`spmv_acc_tpu_torch.formats.convert.csr_to_ell`."""

    col_idx: torch.Tensor  # (m_padded, width) int32
    values: torch.Tensor   # (m_padded, width)
    shape: Tuple[int, int]  # logical (m, n)
    row_len: Optional[torch.Tensor] = None  # (m_padded,) int32

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    @property
    def padded_rows(self) -> int:
        return int(self.values.shape[0])
