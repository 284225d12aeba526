"""Host-side analyze pass and plan cache.

Counterpart of the JAX package's ``spmv_acc_tpu/plan.py``: one O(m) numpy scan of
``row_ptr`` (the csr_adaptive_plus_analyze.cpp:12-98 analog) gives the row
statistics the strategy picker walks, the row id of every stored element and the
flat strategy's chunk break points, the latter two as tensors on the CSR's
device.  Plans are cached per matrix so repeated SpMV amortises the scan.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import DEFAULT_TUNE, TuneConfig
from .formats.containers import CSR

__all__ = ["RowStats", "Plan", "analyze", "get_plan", "clear_plan_cache"]


@dataclasses.dataclass(frozen=True)
class RowStats:
    """Matrix statistics driving the strategy picker (adaptive.cpp:24-31 analog)."""

    rows: int
    cols: int
    nnz: int
    avg_nnz_per_row: float
    max_nnz_per_row: int
    min_nnz_per_row: int
    empty_rows: int
    # nnz in each quarter of the row range (reference samples row_ptr at m/4..m)
    quarter_nnz: Tuple[int, int, int, int]
    row_len_cv: float  # std/avg of row lengths

    @property
    def half_imbalance(self) -> float:
        """max(first half, second half) / min(...) nnz ratio (adaptive.cpp:33-40)."""
        h1 = self.quarter_nnz[0] + self.quarter_nnz[1]
        h2 = self.quarter_nnz[2] + self.quarter_nnz[3]
        lo = min(h1, h2)
        return float(max(h1, h2)) / float(max(lo, 1))


def _row_stats(row_ptr: np.ndarray, cols: int) -> RowStats:
    m = len(row_ptr) - 1
    nnz = int(row_ptr[-1])
    lens = np.diff(row_ptr)
    q = row_ptr[[m // 4, m // 2, (3 * m) // 4, m]] if m >= 4 else np.array([0, 0, 0, nnz])
    q0 = int(q[0])
    q1 = int(q[1]) - int(q[0])
    q2 = int(q[2]) - int(q[1])
    q3 = nnz - int(q[2])
    avg = nnz / max(m, 1)
    std = float(lens.std()) if m else 0.0
    return RowStats(
        rows=m,
        cols=cols,
        nnz=nnz,
        avg_nnz_per_row=avg,
        max_nnz_per_row=int(lens.max()) if m else 0,
        min_nnz_per_row=int(lens.min()) if m else 0,
        empty_rows=int((lens == 0).sum()),
        quarter_nnz=(q0, q1, q2, q3),
        row_len_cv=std / max(avg, 1e-30),
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """Analysis shared by the strategies; tensors live on the CSR's device."""

    stats: RowStats
    # (nnz_padded,) int64: row of every stored element, padded with row id == rows
    row_ids: torch.Tensor
    nnz_padded: int
    chunk_nnz: int
    num_chunks: int
    # (num_chunks + 1,) int32: first row touched by each chunk (flat break_points)
    chunk_first_row: torch.Tensor
    tune: TuneConfig


def analyze(csr: CSR, tune: TuneConfig = DEFAULT_TUNE) -> Plan:
    """O(m)+O(nnz) host scan — the csr_adaptive_plus_analyze.cpp:12-98 analog."""
    row_ptr = csr.row_ptr.cpu().numpy()
    m, n = csr.shape
    nnz = csr.nnz
    stats = _row_stats(row_ptr, n)
    chunk_nnz = tune.flat_chunk_nnz
    num_chunks = max(1, -(-nnz // chunk_nnz))
    nnz_padded = num_chunks * chunk_nnz
    row_ids = np.full(nnz_padded, m, dtype=np.int64)
    row_ids[:nnz] = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    bounds = np.arange(num_chunks + 1, dtype=np.int64) * chunk_nnz
    cfr = np.searchsorted(row_ptr, np.minimum(bounds, nnz), side="right") - 1
    cfr = np.clip(cfr, 0, m).astype(np.int32)
    return Plan(
        stats=stats,
        row_ids=torch.from_numpy(row_ids).to(csr.device),
        nnz_padded=nnz_padded,
        chunk_nnz=chunk_nnz,
        num_chunks=num_chunks,
        chunk_first_row=torch.from_numpy(cfr).to(csr.device),
        tune=tune,
    )


# Keyed on the CSR's row_ptr tensor + tuning.  The entry holds that tensor and is
# used only when it is the very object passed in, so a recycled id() never serves
# another matrix's plan (the JAX package keys on id() alone).
_PLAN_CACHE: dict = {}


def get_plan(csr: CSR, tune: TuneConfig = DEFAULT_TUNE) -> Plan:
    key = (id(csr.row_ptr), csr.shape, csr.nnz, tune)
    hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0] is csr.row_ptr:
        return hit[1]
    plan = analyze(csr, tune)
    _PLAN_CACHE[key] = (csr.row_ptr, plan)
    return plan


def clear_plan_cache():
    _PLAN_CACHE.clear()
