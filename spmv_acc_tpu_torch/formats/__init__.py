"""Sparse formats: the CSR, BSR and ELL containers, host conversions and generators."""

from .containers import BSR, CSR, ELL, sparse_operation
from .convert import (
    coo_to_csr_arrays,
    csr_to_bsr,
    csr_to_dense,
    csr_to_ell,
    csr_to_ell_arrays,
    csr_transpose_arrays,
)
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
    "BSR",
    "ELL",
    "sparse_operation",
    "coo_to_csr_arrays",
    "csr_to_bsr",
    "csr_to_dense",
    "csr_to_ell",
    "csr_to_ell_arrays",
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
