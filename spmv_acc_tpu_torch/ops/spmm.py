"""CSR SpMM (multi-RHS): Y_out = alpha*A@X + beta*Y with X of shape (n, k).

Counterpart of ``spmv_acc_tpu/ops/spmm.py`` (new scope against the reference,
which is SpMV only).  Strategies:
  * ``spmm_segment`` — gather rows of X per nnz, ``index_add_`` by row (plain
    PyTorch; irregular matrices off the card);
  * ``spmm_ell``     — padded (m, width) gather and width contraction (plain
    PyTorch; regular matrices, from ``ops.xla``);
  * ``spmm_swell``   — the swell plan through the Hopper kernel, one read of
    the layout serving every column of a group (``ops.swell.swell_amx``).
"""

from __future__ import annotations

import torch

from .xla import axpby_finish, spmm_ell

__all__ = ["spmm_segment", "spmm_ell", "spmm_swell", "spmm"]


def spmm_segment(alpha, beta, csr, X, Y, plan):
    ax = torch.zeros(csr.rows, X.shape[1], dtype=X.dtype, device=X.device)
    ax.index_add_(0, plan.row_ids[: csr.nnz],
                  csr.values.to(X.dtype)[:, None] * X[csr.col_idx.long()])
    return axpby_finish(alpha, beta, ax, Y)


def spmm_swell(alpha, beta, csr, X, Y):
    """Multi-RHS SpMM over the swell plan (BSR micro-blocks included): the
    kernel reads each slot's values and index once for a group of columns."""
    from .swell import get_swell_plan, swell_amx

    return axpby_finish(alpha, beta, swell_amx(get_swell_plan(csr), X), Y)


def spmm(csr, X, Y=None, alpha=1.0, beta=0.0, strategy: str = "adaptive"):
    """Y_out = alpha*A@X + beta*Y with X of shape (n, k).

    ``strategy="adaptive"`` keeps the reference's decision (``ops/spmm.py:73-81``):
    a regular matrix (row-length CV < 0.5, max row ≤ 4× the mean) goes to
    ``ell``; otherwise ``swell`` on the device that has the hand-written kernel
    (here a CUDA card, where the reference says TPU) and ``segment`` on the CPU.
    """
    from ..dispatch import _get_ell
    from ..plan import get_plan

    plan = get_plan(csr)
    if Y is None:
        Y = torch.zeros(csr.rows, X.shape[1], dtype=csr.values.dtype, device=csr.device)
        beta = 0.0
    if strategy == "adaptive":
        s = plan.stats
        regular = s.row_len_cv < 0.5 and s.max_nnz_per_row <= 4 * max(s.avg_nnz_per_row, 1)
        if regular:
            strategy = "ell"
        elif X.device.type == "cuda":
            strategy = "swell"
        else:
            strategy = "segment"
    if strategy == "ell":
        return spmm_ell(alpha, beta, _get_ell(csr, plan.tune), X, Y, csr.rows)
    if strategy == "segment":
        return spmm_segment(alpha, beta, csr, X, Y, plan)
    if strategy == "swell":
        return spmm_swell(alpha, beta, csr, X, Y)
    raise ValueError(f"unknown spmm strategy {strategy!r}")
