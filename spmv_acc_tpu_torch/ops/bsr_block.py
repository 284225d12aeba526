"""Aligned r x r micro-block (BSR) detection and condensation for the swell plan.

Counterpart of ``spmv_acc_tpu/ops/bsr_block.py``, with the same constants and
the same results.  FEM and structural matrices assemble from dense node blocks
(r degrees of freedom per mesh node): the r rows of a node share one column-block
set.  Condensing to the NODE pattern shrinks the plan by r^2, so one index byte
and one x gather of the swell kernel serve r^2 values.  Blocks are aligned (node
i = rows [i*r, (i+1)*r)); absent cells are zero-filled, which is numerically free
(0 * x == 0) but costs value bytes, so detection scores each candidate by a
per-cell cost model against its zero-fill expansion and keeps r = 1 when none
wins.

The cost model and both gates (``_MAX_EXPANSION``, ``_MIN_WINDOW_DEPTH``) were
fitted on the TPU (v5e, the reference's 2026-08-17 A/B on boneS10, Bump_2911,
Cube_Coup_dt6 and RM07R).  They are kept unchanged for parity with the
reference's plans until H100 measurements refit them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["detect_block_size", "bsr_condense"]

# Per-step cost model (ns) fitted on the TPU: scalar step ~850 ns per 16384
# slots; a BSR step adds (r^2-1) value products and (r-1) table+gather sets but
# carries 16384*r^2 cells.
_SCALAR_NS = 850.0
_PROD_NS = 385.0
_TG_NS = 470.0
_MAX_EXPANSION = 2.2     # cap on zero-fill expansion r*r*nnzb/nnz
_MIN_WINDOW_DEPTH = 3.5  # gate on est. slab depth (blocks per node row and window)


def _per_cell_ns(r: int) -> float:
    if r == 1:
        return _SCALAR_NS / 16384.0
    step = _SCALAR_NS + (r * r - 1) * _PROD_NS + (r - 1) * _TG_NS
    return step / (16384.0 * r * r)


def _expansion_sample(rp, ci, m, n, r, sample=4096):
    """(zero-fill expansion r*r*nnzb/nnz, est. slab depth: average blocks per
    (node row, 256-scalar-column window)) over a node-row sample."""
    mb = -(-m // r)
    stride = max(1, mb // sample)
    nodes = np.arange(0, mb, stride, dtype=np.int64)
    r0 = nodes * r
    r1 = np.minimum(r0 + r, m)
    lens = (rp[r1] - rp[r0]).astype(np.int64)
    tot = int(lens.sum())
    if tot == 0:
        return np.inf, 0.0
    starts = rp[r0]
    idx = np.repeat(starts, lens) + (
        np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
    )
    bc = ci[idx] // r
    node_of = np.repeat(np.arange(len(nodes), dtype=np.int64), lens)
    nbb = n // r + 2
    ub = np.unique(node_of * nbb + bc)
    nblocks = len(ub)
    wb = max(1, 256 // r)  # block columns per 256-scalar-column window
    ninst = len(np.unique((ub // nbb) * (nbb // wb + 2) + (ub % nbb) // wb))
    return nblocks * r * r / tot, nblocks / max(1, ninst)


def detect_block_size(rp, ci, shape, cands=(4, 3, 2)) -> int:
    """Best aligned micro-block size for (rp, ci), or 1 for the scalar path."""
    m, n = int(shape[0]), int(shape[1])
    nnz = int(rp[-1])
    if nnz == 0 or m < 4 * max(cands) or nnz < 4096:
        return 1
    rp = np.asarray(rp, dtype=np.int64)
    ci = np.asarray(ci, dtype=np.int64)
    best_r, best_cost = 1, _per_cell_ns(1)
    for r in cands:
        e, est_depth = _expansion_sample(rp, ci, m, n, r)
        if e > _MAX_EXPANSION or est_depth < _MIN_WINDOW_DEPTH:
            continue
        cost = e * _per_cell_ns(r)
        if cost < best_cost:
            best_r, best_cost = r, cost
    return best_r


def bsr_condense(rp, ci, v, shape, r):
    """Condense CSR to the aligned r x r block pattern.

    Returns (rp_b int64 (mb+1,), ci_b int64 (nnzb,), vals2d (nnzb, r*r) of
    v.dtype): vals2d[k, i*r + j] is cell (i, j) of block k, zero where absent.
    Requires canonical CSR (sorted unique columns per row).  Float64 values go
    through the shared native library when it loads; the numpy path gives the
    same arrays.
    """
    from ..io.native import bsr_condense_native

    m, n = int(shape[0]), int(shape[1])
    rp = np.asarray(rp, dtype=np.int64)
    ci = np.asarray(ci, dtype=np.int64)
    v = np.asarray(v)
    nnz = int(rp[-1])
    mb = -(-m // r)
    nbb = -(-n // r)
    nat = bsr_condense_native(rp, ci, v, m, r, mb)
    if nat is not None:
        return nat
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    key = (rows // r) * nbb + ci // r
    uniq, inv = np.unique(key, return_inverse=True)
    vals2d = np.zeros((len(uniq), r * r), dtype=v.dtype)
    vals2d[inv.reshape(-1), (rows % r) * r + (ci % r)] = v[:nnz]
    rp_b = np.zeros(mb + 1, dtype=np.int64)
    np.add.at(rp_b, uniq // nbb + 1, 1)
    np.cumsum(rp_b, out=rp_b)
    return rp_b, uniq % nbb, vals2d
