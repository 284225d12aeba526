"""The ``flat`` strategy in plain PyTorch: pure nnz splitting (hip-flat, the
HPDC'23 paper's first algorithm, flat_imp.inl / flat_reduce.hpp).

Counterpart of ``spmv_acc_tpu/ops/flat.py``.  The GPU original gives each block
a fixed nnz chunk and resolves rows that cross chunk borders with atomicAdd
(flat_reduce.hpp:65-156); here, as in the JAX package, the cross-chunk sums are
deterministic:

  1. products = values * x[cols];
  2. per-chunk sums keyed by the *local* row (row - chunk_first_row), at most
     ``max_rows_per_chunk`` of them per chunk (the break_points of
     flat_imp.inl:107-131, from the plan);
  3. one scatter-add of the (num_chunks, max_rows_per_chunk) partials onto y.

When one chunk can span more than ``MAX_ROWS_PER_CHUNK`` rows the partials would
bloat, so the direct sorted segment sum over the plan's row ids runs instead.
Both choices come from the plan (``flat_rows_per_chunk``, ``flat_two_level``,
made on the host at analyze time): an SpMV reads nothing back from the device,
so a captured CUDA graph can hold it.
"""

from __future__ import annotations

import torch

from ..plan import FLAT_MAX_ROWS_PER_CHUNK as MAX_ROWS_PER_CHUNK
from .xla import axpby_finish

__all__ = ["spmv_flat", "MAX_ROWS_PER_CHUNK"]


def _flat_two_level(csr, x, plan, max_rpc):
    m, nnz = csr.rows, csr.nnz
    C, chunk = plan.num_chunks, plan.chunk_nnz
    prod = torch.zeros(C * chunk, dtype=csr.values.dtype, device=csr.device)
    prod[:nnz] = csr.values * x[csr.col_idx.long()]
    rows = plan.row_ids[: C * chunk].view(C, chunk)  # padding rows are m
    first = plan.chunk_first_row[:C].long()[:, None]
    local = (rows - first).clamp(0, max_rpc - 1)
    prod = torch.where(rows < m, prod.view(C, chunk), 0.0)
    base = torch.arange(C, device=csr.device)[:, None] * max_rpc
    partial = torch.zeros(C * max_rpc, dtype=prod.dtype, device=csr.device)
    partial.index_add_(0, (base + local).reshape(-1), prod.reshape(-1))
    out_rows = (first + torch.arange(max_rpc, device=csr.device)[None, :]).clamp(max=m)
    y = torch.zeros(m + 1, dtype=prod.dtype, device=csr.device)
    y.index_add_(0, out_rows.reshape(-1), partial)
    return y[:m]


def _flat_direct(csr, x, plan):
    ax = torch.zeros(csr.rows, dtype=csr.values.dtype, device=csr.device)
    ax.index_add_(0, plan.row_ids[: csr.nnz], csr.values * x[csr.col_idx.long()])
    return ax


def spmv_flat(alpha, beta, csr, x, y, plan):
    """Full strategy entry (dispatch contract): y_out = alpha*A@x + beta*y."""
    if plan.flat_two_level:
        ax = _flat_two_level(csr, x, plan, plan.flat_rows_per_chunk)
    else:
        ax = _flat_direct(csr, x, plan)
    return axpby_finish(alpha, beta, ax, y)
