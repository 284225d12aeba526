"""BSR (block-CSR) SpMV/SpMM over dense (bh, bw) blocks, in plain PyTorch.

Counterpart of ``spmv_acc_tpu/ops/bsr.py``, which is plain XLA (new scope
against the scalar-CSR reference): x is gathered at block granularity,
contiguous bw-wide slices, and every stored block is one small dense product.
"""

from __future__ import annotations

import torch

from ..formats.containers import BSR
from .xla import axpby_finish

__all__ = ["bsr_spmv", "bsr_spmm"]


def _block_row_ids(bsr: BSR) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(bsr.block_rows, device=bsr.device), torch.diff(bsr.row_ptr.long()))


def bsr_spmm(bsr: BSR, X, Y=None, alpha=1.0, beta=0.0):
    """Y = alpha*A@X + beta*Y on BSR; X has bsr.shape[1] rows."""
    bh, bw = bsr.blocksize
    if Y is None:
        Y = torch.zeros(bsr.shape[0], X.shape[1], dtype=bsr.values.dtype, device=bsr.device)
        beta = 0.0
    xb = X.reshape(-1, bw, X.shape[1])[bsr.col_idx.long()]         # (nblocks, bw, k)
    prod = torch.einsum("nij,njk->nik", bsr.values.to(X.dtype), xb)  # (nblocks, bh, k)
    out = torch.zeros(bsr.block_rows, bh, X.shape[1], dtype=X.dtype, device=X.device)
    out.index_add_(0, _block_row_ids(bsr), prod)
    return axpby_finish(alpha, beta, out.reshape(-1, X.shape[1]), Y)


def bsr_spmv(bsr: BSR, x, y=None, alpha=1.0, beta=0.0):
    """y = alpha*A@x + beta*y on BSR; x length must equal bsr.shape[1]."""
    if y is None:
        y = torch.zeros(bsr.shape[0], dtype=bsr.values.dtype, device=bsr.device)
        beta = 0.0
    return bsr_spmm(bsr, x[:, None], y[:, None], alpha, beta)[:, 0]
