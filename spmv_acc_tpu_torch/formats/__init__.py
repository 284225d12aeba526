"""Sparse formats: the CSR container, host conversions and generators."""

from .containers import CSR, sparse_operation
from .convert import coo_to_csr_arrays, csr_transpose_arrays
from .generate import (
    EXAMPLE_SHAPES,
    banded_csr,
    dense_row_outlier_csr,
    example_like,
    fem_like_csr,
    powerlaw_csr,
    random_csr,
    random_x_y,
)

__all__ = [
    "CSR",
    "sparse_operation",
    "coo_to_csr_arrays",
    "csr_transpose_arrays",
    "EXAMPLE_SHAPES",
    "banded_csr",
    "dense_row_outlier_csr",
    "example_like",
    "fem_like_csr",
    "powerlaw_csr",
    "random_csr",
    "random_x_y",
]
