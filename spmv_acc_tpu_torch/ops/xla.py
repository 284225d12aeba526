"""Plain PyTorch strategies — the counterparts of the JAX package's pure-XLA
``spmv_acc_tpu/ops/xla.py`` (no hand-written kernel behind them, as there was
none in the reference).

  * ``axpby_finish`` — y_out = alpha*(A@x) + beta*y, the one combiner every
    strategy funnels through, so true alpha/beta semantics always hold.
  * ``spmv_default`` — gather, multiply and ``index_add_`` over the plan's row
    ids: the sanity strategy (analog of src/acc/hip/spmv_hip_acc_imp.cpp:15-35)
    and what ``spmv-cli --device-verify`` checks against.
  * ``spmv_line`` — stage all products, prefix-scan, take row-boundary
    differences: the CSR-Stream/"line" idea (hip-line/line_imp_one_pass.inl:52-86).
  * ``spmv_ell`` — row-padded dense reduction over the ELL slab (vector-row
    analog, hip-vector-row/vector_row_native.hpp:13-58).
  * ``spmm_ell`` — multi-RHS SpMM on the padded ELL format: gather rows of X,
    contract the width.
"""

from __future__ import annotations

import torch

__all__ = ["axpby_finish", "spmv_default", "spmv_line", "spmv_ell", "spmm_ell"]


def axpby_finish(alpha, beta, ax: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y_out = alpha*(A@x) + beta*y (the reference's line/flat kernels silently
    assume beta == 1, SURVEY.md §7.3; here the contract always holds)."""
    return alpha * ax + beta * y.to(ax.dtype)


def spmv_default(alpha, beta, csr, x, y, plan):
    """Scatter-add over (value, col, row_id) triplets."""
    ax = torch.zeros(csr.rows, dtype=csr.values.dtype, device=csr.device)
    ax.index_add_(0, plan.row_ids[: csr.nnz], csr.values * x[csr.col_idx.long()])
    return axpby_finish(alpha, beta, ax, y)


def spmv_line(alpha, beta, csr, x, y, plan=None):
    """Prefix-scan formulation (CSR-Stream / hip-line analog): row i's sum is
    the difference of the running sum at its two row_ptr bounds."""
    s = torch.cumsum(csr.values * x[csr.col_idx.long()], 0)
    s0 = torch.cat([s.new_zeros(1), s])
    rp = csr.row_ptr.long()
    return axpby_finish(alpha, beta, s0[rp[1:]] - s0[rp[:-1]], y)


def spmv_ell(alpha, beta, ell, x, y, num_rows):
    """Row-padded dense reduction — best when rows are near-uniform length
    (the picker's 'regular' branch)."""
    ax = (ell.values * x[ell.col_idx.long()]).sum(1)[:num_rows]
    return axpby_finish(alpha, beta, ax, y)


def spmm_ell(alpha, beta, ell, X, Y, num_rows):
    """Multi-RHS SpMM on the padded format; the gather amortises over RHS columns."""
    gathered = X[ell.col_idx.long()]  # (m_pad, width, k)
    ax = torch.einsum("mw,mwk->mk", ell.values.to(X.dtype), gathered)[:num_rows]
    return axpby_finish(alpha, beta, ax, Y)
