"""Row partitioning of a CSR matrix over the ranks of a process group.

Counterpart of ``spmv_acc_tpu/parallel/partition.py``: contiguous row blocks
per shard (``local_rows`` rows each, rounded up to 8; each shard's nnz padded
to the largest, rounded up to 128), stacked as ``(D, nnz_pad)`` arrays equal
to the JAX package's array for array.  The JAX package places the stacked
arrays on a device mesh; here they are host tensors, and
:func:`~.dist_spmv.shard_partitioned` keeps only the rank's row, on the rank's
device (one process per device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.containers import CSR

__all__ = ["PartitionedCSR", "partition_rows", "balance_row_cuts", "pad_vector", "unpad_vector"]


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Stacked per-shard CSR slabs.

    ``values``, ``col_idx``, ``row_ids`` and ``col_idx_padded`` are ``(D,
    nnz_pad)`` host tensors (``shard`` None), or the one row ``(1, nnz_pad)``
    of shard ``shard`` on its rank's device.  Padding lanes carry column 0,
    value 0 and the row sentinel ``local_rows``.  ``row_offset`` (D,) int32
    holds every shard's first global row in both forms."""

    values: torch.Tensor          # (D or 1, nnz_pad)
    col_idx: torch.Tensor         # (D or 1, nnz_pad) int32, GLOBAL column indices
    row_ids: torch.Tensor         # (D or 1, nnz_pad) int32, LOCAL row ids, sentinel local_rows
    row_offset: torch.Tensor      # (D,) int32, host
    # column indices in PADDED coordinates: global column j owned by shard d
    # (cuts[d] <= j < cuts[d+1]) maps to d*local_rows + (j - cuts[d]), the
    # coordinates of the concatenated per-shard (local_rows,) vectors, used by
    # square-partitioned solvers (dist CG) where x is sharded like y
    col_idx_padded: torch.Tensor  # (D or 1, nnz_pad) int32
    num_shards: int
    local_rows: int
    global_shape: Tuple[int, int]
    nnz: int
    shard: Optional[int] = None

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.local_rows


def balance_row_cuts(row_ptr: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous row cut points equalising nnz per shard: cut k at the row
    where the cumulative nnz crosses k * nnz / D."""
    m = len(row_ptr) - 1
    nnz = int(row_ptr[-1])
    targets = (np.arange(1, num_shards) * nnz) // num_shards
    cuts = np.searchsorted(row_ptr, targets, side="left")
    return np.concatenate([[0], np.clip(cuts, 0, m), [m]]).astype(np.int64)


def partition_rows(csr: CSR, num_shards: int, balance: bool = True) -> PartitionedCSR:
    """Cut ``csr`` into ``num_shards`` contiguous row blocks (nnz-balanced
    with ``balance``, else equal row counts); the stacked host arrays."""
    rp, ci, v, (m, n) = csr.to_numpy()
    rp = rp.astype(np.int64)
    if balance:
        cuts = balance_row_cuts(rp, num_shards)
    else:
        step = -(-m // num_shards)
        cuts = np.minimum(np.arange(num_shards + 1) * step, m)
    local_rows = int(max(np.diff(cuts).max(), 1))
    local_rows = -(-local_rows // 8) * 8
    shard_nnz = rp[cuts[1:]] - rp[cuts[:-1]]
    nnz_pad = int(max(shard_nnz.max(), 1))
    nnz_pad = -(-nnz_pad // 128) * 128

    vals = np.zeros((num_shards, nnz_pad), dtype=v.dtype)
    cols = np.zeros((num_shards, nnz_pad), dtype=np.int32)
    cols_pad = np.zeros((num_shards, nnz_pad), dtype=np.int32)
    rows = np.full((num_shards, nnz_pad), local_rows, dtype=np.int32)
    # owner shard of every global column (square layouts, where x is sharded
    # like y; for n != m cols_pad degenerates to a clamp, as in the reference)
    col_cuts = np.minimum(cuts, n)
    for d in range(num_shards):
        a, b = int(rp[cuts[d]]), int(rp[cuts[d + 1]])
        k = b - a
        vals[d, :k] = v[a:b]
        cols[d, :k] = ci[a:b]
        gl_rows = np.repeat(
            np.arange(cuts[d], cuts[d + 1], dtype=np.int64), np.diff(rp[cuts[d]: cuts[d + 1] + 1])
        )
        rows[d, :k] = (gl_rows - cuts[d]).astype(np.int32)
        owner = np.clip(np.searchsorted(col_cuts, ci[a:b], side="right") - 1, 0, num_shards - 1)
        cols_pad[d, :k] = (owner * local_rows + (ci[a:b] - col_cuts[owner])).astype(np.int32)
    return PartitionedCSR(
        values=torch.from_numpy(vals),
        col_idx=torch.from_numpy(cols),
        row_ids=torch.from_numpy(rows),
        row_offset=torch.from_numpy(cuts[:-1].astype(np.int32)),
        col_idx_padded=torch.from_numpy(cols_pad),
        num_shards=num_shards,
        local_rows=local_rows,
        global_shape=(m, n),
        nnz=csr.nnz,
    )


def _pad_map(part: PartitionedCSR) -> np.ndarray:
    """Global row i -> padded index d*local_rows + (i - cuts[d])."""
    off = part.row_offset.numpy().astype(np.int64)
    m = part.global_shape[0]
    counts = np.diff(np.concatenate([off, [m]]))
    return np.concatenate(
        [d * part.local_rows + np.arange(counts[d]) for d in range(part.num_shards)]
    ).astype(np.int64)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def pad_vector(part: PartitionedCSR, v) -> torch.Tensor:
    """Scatter a global (m,) vector into the padded per-shard layout
    (D*local_rows,), a host tensor; rank d's block is
    ``[d*local_rows, (d+1)*local_rows)``."""
    v = _host(v)
    out = np.zeros(part.num_shards * part.local_rows, dtype=v.dtype)
    out[_pad_map(part)] = v
    return torch.from_numpy(out)


def unpad_vector(part: PartitionedCSR, v_padded) -> torch.Tensor:
    """The valid rows of a padded per-shard vector in global order (a tensor
    on the device of ``v_padded``, or a host tensor for a numpy array)."""
    if isinstance(v_padded, torch.Tensor):
        return v_padded[torch.from_numpy(_pad_map(part)).to(v_padded.device)]
    return torch.from_numpy(np.asarray(v_padded)[_pad_map(part)])
