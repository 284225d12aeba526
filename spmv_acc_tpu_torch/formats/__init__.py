"""Sparse formats: the CSR, COO, BSR and ELL containers, conversions and generators."""

from .containers import BSR, COO, CSR, ELL, replace_values, sparse_operation
from .convert import (
    coo_to_csr,
    coo_to_csr_arrays,
    csr_to_bsr,
    csr_to_coo,
    csr_to_dense,
    csr_to_ell,
    csr_to_ell_arrays,
    csr_transpose_arrays,
)
from .generate import (
    EXAMPLE_SHAPES,
    aniso_laplacian_csr,
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
    "COO",
    "BSR",
    "ELL",
    "sparse_operation",
    "replace_values",
    "coo_to_csr",
    "coo_to_csr_arrays",
    "csr_to_bsr",
    "csr_to_coo",
    "csr_to_dense",
    "csr_to_ell",
    "csr_to_ell_arrays",
    "csr_transpose_arrays",
    "EXAMPLE_SHAPES",
    "aniso_laplacian_csr",
    "banded_csr",
    "dense_row_outlier_csr",
    "example_like",
    "fem_like_csr",
    "powerlaw_csr",
    "random_csr",
    "random_x_y",
]
