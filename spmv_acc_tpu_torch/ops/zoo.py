"""The rest of the reference's strategy zoo in plain PyTorch: ``thread_row``,
``wf_row``, ``block_row``, ``light``, ``line_enhance`` and ``acsr``.

Counterpart of ``spmv_acc_tpu/ops/zoo.py``, with its constants and packings.
The reference's strategies differ in how rows map to threads, wavefronts or
blocks; the JAX package kept that degree of freedom as the padded width one row
owns in a dense row pack and the order of the reduction, and so does this port
(all of it was plain XLA there, so it is plain PyTorch here):

  * ``thread_row`` — one row per lane: width-max pack, one reduce over the row;
  * ``wf_row`` / ``block_row`` — rows padded to multiples of 8 / 128 lanes,
    reduced in one of three orders (``SPMV_TPU_WF_REDUCE`` = default / reg /
    lds, the reference's ``WF_REDUCE`` build flag, config.cmake:30-34);
  * ``light`` — LightSpMV's vector-width thresholds on avg nnz/row select a
    static packing width (the atomic row queue is not reproduced);
  * ``line_enhance`` — the nnz streamed in fixed rounds of ``ROUND_NNZ`` with a
    carried row accumulator;
  * ``acsr`` — log-scale row-length bins, one dense reduce per bin.

Rows longer than ``_WIDTH_CAP`` spill their excess into a COO tail summed
exactly, once the dense pack would pass ``_SPILL_MIN_CELLS`` cells.  All
compute ``y = alpha*A@x + beta*y`` through ``axpby_finish``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..formats.containers import drop_held, on_replace_values
from .xla import axpby_finish

__all__ = ["spmv_thread_row", "spmv_wf_row", "spmv_block_row", "spmv_light",
           "spmv_line_enhance", "spmv_acsr", "clear_pack_cache", "ROUND_NNZ"]

# Padded-width cap: without it one dense row makes a pack O(m * n).
_WIDTH_CAP = 512
# spill only when the dense pack would actually be large
_SPILL_MIN_CELLS = 1 << 24
# LightSpMV vector-size thresholds from avg nnz/row (hip-light/light_spmv.cpp:16-42)
_LIGHT_THRESHOLDS = ((2, 1), (4, 2), (8, 4), (16, 8), (32, 16), (64, 32))
# nnz per line_enhance round
ROUND_NNZ = 1 << 16

# Packs by (matrix, kind).  Each entry holds the CSR's three tensors and is used
# only when they are the very objects passed in, so neither a recycled id() nor
# a CSR that shares row_ptr with new values is served a stale pack.
# formats.containers.replace_values drops the CSR's entries.
_PACK_CACHE: dict = {}
on_replace_values(lambda csr: drop_held(_PACK_CACHE, csr))


def clear_pack_cache() -> None:
    _PACK_CACHE.clear()


def _cached(csr, kind, build):
    key = (id(csr.row_ptr), id(csr.col_idx), id(csr.values), csr.shape, kind)
    hit = _PACK_CACHE.get(key)
    if (hit is not None and hit[0] is csr.row_ptr and hit[1] is csr.col_idx
            and hit[2] is csr.values):
        return hit[3]
    out = build()
    _PACK_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, out)
    return out


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _spill(rows, slots, ci, v, over, dev):
    """Split off the cells with ``over`` set as a COO tail (rows, cols, values)."""
    tail = (_t(rows[over].astype(np.int64), dev), _t(ci[over].astype(np.int64), dev),
            _t(v[over], dev))
    keep = ~over
    return (rows[keep], slots[keep], ci[keep], v[keep]), tail


def _row_packed(csr, width_unit: int):
    """Rows padded to a multiple of ``width_unit`` slots: (cols (m, W) int64,
    vals (m, W), tail), padding at column 0 with value 0.  ``tail = (rows,
    cols, values)`` holds the spilled cells of rows longer than the width cap."""

    def build():
        rp, ci, v, (m, n) = csr.to_numpy()
        lens = np.diff(rp)
        maxlen = max(int(lens.max()) if m else 1, 1)
        width = max(width_unit, -(-maxlen // width_unit) * width_unit)
        if width > _WIDTH_CAP and m * width > _SPILL_MIN_CELLS:
            width = max(width_unit, _WIDTH_CAP // width_unit * width_unit)
        rows = np.repeat(np.arange(m), lens)
        slots = np.arange(len(rows)) - np.repeat(rp[:-1], lens)
        (rows, slots, ci, v), tail = _spill(rows, slots, ci, v, slots >= width, csr.device)
        cols = np.zeros((m, width), dtype=np.int64)
        vals = np.zeros((m, width), dtype=v.dtype)
        cols[rows, slots] = ci
        vals[rows, slots] = v
        return _t(cols, csr.device), _t(vals, csr.device), tail

    return _cached(csr, ("pack", width_unit), build)


def _add_tail(ax, tail, x):
    trows, tci, tv = tail
    if trows.numel():
        ax = ax.index_add(0, trows, tv * x[tci])
    return ax


def _reduce_flat(cols, vals, x):
    return (vals * x[cols]).sum(1)


def _reduce_staged(cols, vals, x, w):
    """Strided accumulation per lane, then the cross-lane reduction."""
    m, width = cols.shape
    return (vals * x[cols]).reshape(m, width // w, w).sum(1).sum(1)


def _reduce_tree(cols, vals, x, w):
    """Strided accumulation then a log-step pairwise fold (the ``__shfl_down``
    ladder, SHFL_DOWN_WF_REDUCE, src/acc/common/utils.h:38-59)."""
    m, width = cols.shape
    prod = (vals * x[cols]).reshape(m, width // w, w).sum(1)
    k = w
    while k > 1:
        k //= 2
        prod = prod[:, :k] + prod[:, k: 2 * k]
    return prod[:, 0]


def _reduce_segsum(cols, vals, x, w):
    """Materialised products reduced by row id (the LDS tree,
    wavefront_row_lds.hpp:17-62)."""
    m, width = cols.shape
    rows = torch.arange(m, device=cols.device).repeat_interleave(width)
    ax = torch.zeros(m, dtype=vals.dtype, device=vals.device)
    return ax.index_add_(0, rows, (vals * x[cols]).reshape(-1))


_WF_REDUCERS = {"default": _reduce_staged, "reg": _reduce_tree, "lds": _reduce_segsum}


def _wf_reduce_mode():
    mode = os.environ.get("SPMV_TPU_WF_REDUCE", "default").lower()
    return _WF_REDUCERS.get(mode, _reduce_staged)


def spmv_thread_row(alpha, beta, csr, x, y, plan=None):
    """Row per lane (THREAD_ROW, hip-thread-row/thread_row.inl:17-98)."""
    cols, vals, tail = _row_packed(csr, 1)
    return axpby_finish(alpha, beta, _add_tail(_reduce_flat(cols, vals, x), tail, x), y)


def spmv_wf_row(alpha, beta, csr, x, y, plan=None):
    """Row per 8-lane group (WF_ROW, hip-wf-row/wavefront_row_default.hpp:48-92),
    reduced in the ``SPMV_TPU_WF_REDUCE`` order."""
    cols, vals, tail = _row_packed(csr, 8)
    ax = _add_tail(_wf_reduce_mode()(cols, vals, x, 8), tail, x)
    return axpby_finish(alpha, beta, ax, y)


def spmv_block_row(alpha, beta, csr, x, y, plan=None):
    """Row per 128 lanes (BLOCK_ROW_ORDINARY,
    hip-block-row-ordinary/spmv_hip_acc_imp.cpp:16-75), reduced in the
    ``SPMV_TPU_WF_REDUCE`` order."""
    cols, vals, tail = _row_packed(csr, 128)
    ax = _add_tail(_wf_reduce_mode()(cols, vals, x, 128), tail, x)
    return axpby_finish(alpha, beta, ax, y)


def spmv_light(alpha, beta, csr, x, y, plan=None):
    """LIGHT (LightSpMV, hip-light/spmv_hip_acc_imp.inl:35-77): the vector width
    from avg nnz/row (light_spmv.cpp:16-42) selects a static packing width."""
    avg = csr.nnz / max(csr.rows, 1)
    w = 64
    for thresh, cand in _LIGHT_THRESHOLDS:
        if avg <= thresh:
            w = cand
            break
    cols, vals, tail = _row_packed(csr, w)
    ax = _reduce_flat(cols, vals, x) if w == 1 else _reduce_staged(cols, vals, x, w)
    return axpby_finish(alpha, beta, _add_tail(ax, tail, x), y)


def _acsr_bins(csr):
    """Log-scale row-length bins (ACSR, benchmark/acsr/ACSR.cpp:130-216): a row
    of length l lands in the bin of width 2^ceil(log2 l), capped at
    ``_WIDTH_CAP``; over-cap cells spill into the COO tail.  Returns
    ([(rows, cols, vals, width)], tail)."""

    def build():
        rp, ci, v, (m, n) = csr.to_numpy()
        lens = np.diff(rp)
        widths = np.maximum(1, np.int64(1) << np.maximum(
            0, np.ceil(np.log2(np.maximum(lens, 1))).astype(np.int64)))
        widths = np.minimum(widths, _WIDTH_CAP)
        rows_all = np.repeat(np.arange(m), lens)
        slots = np.arange(len(rows_all)) - np.repeat(rp[:-1], lens)
        (rows_all, slots, ci_, v_), tail = _spill(rows_all, slots, ci, v,
                                                  slots >= widths[rows_all], csr.device)
        bins = []
        for w in np.unique(widths):
            sel_rows = np.flatnonzero(widths == w)
            inbin = widths[rows_all] == w
            rnew = np.searchsorted(sel_rows, rows_all[inbin])
            cols = np.zeros((len(sel_rows), int(w)), dtype=np.int64)
            vals = np.zeros((len(sel_rows), int(w)), dtype=v_.dtype)
            cols[rnew, slots[inbin]] = ci_[inbin]
            vals[rnew, slots[inbin]] = v_[inbin]
            bins.append((_t(sel_rows.astype(np.int64), csr.device), _t(cols, csr.device),
                         _t(vals, csr.device), int(w)))
        return bins, tail

    return _cached(csr, "acsr", build)


def spmv_acsr(alpha, beta, csr, x, y, plan=None):
    """ACSR (benchmark/acsr/ACSR.cpp:130-216): one dense reduce per log-scale
    row-length bin."""
    bins, tail = _acsr_bins(csr)
    ax = torch.zeros(csr.rows, dtype=csr.values.dtype, device=csr.device)
    for rows_b, cols, vals, w in bins:
        part = (_reduce_flat(cols, vals, x) if w <= 2
                else _reduce_staged(cols, vals, x, min(w, 128)))
        ax[rows_b] = part.to(ax.dtype)
    return axpby_finish(alpha, beta, _add_tail(ax, tail, x), y)


def spmv_line_enhance(alpha, beta, csr, x, y, plan):
    """LINE_ENHANCE (hip-line-enhance/line_enhance_spmv_imp.inl:11-95): the nnz
    stream in rounds of ``ROUND_NNZ``, each round's row sums added to a carried
    row accumulator."""
    nnz, m = csr.nnz, csr.rows
    prod = csr.values * x[csr.col_idx.long()]
    rows = plan.row_ids[:nnz]
    ax = torch.zeros(m, dtype=prod.dtype, device=csr.device)
    if nnz <= ROUND_NNZ:
        return axpby_finish(alpha, beta, ax.index_add_(0, rows, prod), y)
    for s in range(0, nnz, ROUND_NNZ):
        part = torch.zeros(m, dtype=prod.dtype, device=csr.device)
        ax = ax + part.index_add_(0, rows[s: s + ROUND_NNZ], prod[s: s + ROUND_NNZ])
    return axpby_finish(alpha, beta, ax, y)
