"""Matrix ingest layer — the analog of the reference CLI's three readers
(cli/main.cpp:47-86 selects by ``-f csr|mtx|bin2``)."""

from __future__ import annotations

import numpy as np
import torch

from ..formats.containers import CSR
from ..formats.convert import coo_to_csr_arrays
from .binary import read_bin2, write_bin2
from .csr_text import read_csr_text, write_csr_text
from .matrix_market import read_mtx, write_mtx

__all__ = [
    "read_bin2",
    "write_bin2",
    "read_csr_text",
    "write_csr_text",
    "read_mtx",
    "write_mtx",
    "load_matrix",
    "load_csr",
    "detect_format",
]


def detect_format(path: str) -> str:
    p = str(path).lower()
    if p.endswith(".mtx"):
        return "mtx"
    if p.endswith(".bin2") or p.endswith(".bin"):
        return "bin2"
    return "csr"


def load_matrix(path, fmt: str | None = None, dtype=np.float64):
    """Load any supported format.

    Returns ``(row_ptr, col_idx, values, shape, x_or_None)`` as host arrays — the
    ``csr`` text format carries a dense x in the file (cli/utils.hpp:65-85); the
    others return ``None`` and the caller generates x.
    """
    fmt = fmt or detect_format(path)
    if fmt == "csr":
        row_ptr, col_idx, values, x, shape = read_csr_text(path, dtype=dtype)
        return row_ptr, col_idx, values, shape, x
    if fmt == "mtx":
        r, c, v, shape = read_mtx(path, dtype=dtype)
        row_ptr, col_idx, values = coo_to_csr_arrays(r, c, v, shape)
        return row_ptr, col_idx, values, shape, None
    if fmt == "bin2":
        row_ptr, col_idx, values, shape = read_bin2(path, dtype=dtype)
        return row_ptr, col_idx, values, shape, None
    raise ValueError(f"unknown format {fmt!r} (expected csr|mtx|bin2)")


def load_csr(path, fmt: str | None = None, dtype=np.float64, device="cuda") -> CSR:
    """The matrix in ``path`` as a :class:`CSR` on ``device``: the card by
    default, as the JAX package's ``load_csr`` places it on its default device.
    Raises RuntimeError for a CUDA device when there is none; pass
    ``device="cpu"`` to load it on the host."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_csr: no CUDA device; pass device='cpu' to load on the CPU")
    row_ptr, col_idx, values, shape, _ = load_matrix(path, fmt=fmt, dtype=dtype)
    return CSR.from_numpy(row_ptr, col_idx, values, shape, device=device)
