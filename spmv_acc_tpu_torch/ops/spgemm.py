"""SpGEMM: C = A @ B for CSR matrices.

Counterpart of ``spmv_acc_tpu/ops/spgemm.py``: a numpy host path (Gustavson's
algorithm by row expansion, the golden) and the two-phase split for repeated
products of one pattern.  The symbolic phase computes C's pattern and the
product map on the host; the numeric phase is a gather and a sorted
segment sum on the matrices' device.  The JAX package runs that phase with
plain XLA ops (a gather and ``segment_sum``), not a Pallas kernel, so the port
runs it with plain PyTorch ops on the card as on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.containers import CSR

__all__ = ["spgemm_host", "spgemm_symbolic", "spgemm_numeric", "spgemm"]


def _check_shapes(shape_a, shape_b) -> None:
    if shape_a[1] != shape_b[0]:
        raise ValueError(f"inner dims mismatch: {tuple(shape_a)} @ {tuple(shape_b)}")


def _expand(rp_a, ci_a, rp_b):
    """The product list of A @ B by row expansion: for the p-th nnz (i, k) of A,
    the nnz of B's row k in order.  Returns (out_rows, a_pos, b_pos), int64."""
    m = len(rp_a) - 1
    exp_lens = np.diff(rp_b)[ci_a]  # products per A nnz
    total = int(exp_lens.sum())
    a_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp_a))
    grp_off = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(exp_lens) - exp_lens,
                                                          exp_lens)
    a_pos = np.repeat(np.arange(len(ci_a), dtype=np.int64), exp_lens)
    return np.repeat(a_rows, exp_lens), a_pos, np.repeat(rp_b[ci_a], exp_lens) + grp_off


def _pattern(out_rows, out_cols, m, n):
    """Sort the products by (row, col): (order, output slot of each sorted
    product, C's row_ptr int32, C's col_idx int32)."""
    key = out_rows * n + out_cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.concatenate(([True], key_s[1:] != key_s[:-1])) if len(key_s) else (
        np.zeros(0, bool))
    group = np.cumsum(uniq_mask) - 1
    ukey = key_s[uniq_mask]
    row_ptr = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(np.bincount(ukey // n, minlength=m), out=row_ptr[1:])
    return order, group, row_ptr, (ukey % n).astype(np.int32)


def spgemm_host(rp_a, ci_a, v_a, shape_a, rp_b, ci_b, v_b, shape_b):
    """Host Gustavson SpGEMM by COO expansion: for every a_ik, emit row k of B
    scaled by a_ik, then add up repeated (row, col) products in product order.
    Returns (row_ptr int32, col_idx int32, values, shape) — the JAX package's
    arrays, bit for bit."""
    _check_shapes(shape_a, shape_b)
    m, n = int(shape_a[0]), int(shape_b[1])
    rp_a = np.asarray(rp_a).astype(np.int64)
    ci_a = np.asarray(ci_a).astype(np.int64)
    v_a = np.asarray(v_a)
    rp_b = np.asarray(rp_b).astype(np.int64)
    ci_b = np.asarray(ci_b).astype(np.int64)
    v_b = np.asarray(v_b)
    out_rows, a_pos, b_pos = _expand(rp_a, ci_a, rp_b)
    if len(out_rows) == 0:
        return np.zeros(m + 1, np.int32), np.zeros(0, np.int32), np.zeros(0, v_a.dtype), (m, n)
    order, group, row_ptr, col_idx = _pattern(out_rows, ci_b[b_pos], m, n)
    vals = (v_a[a_pos] * v_b[b_pos])[order]
    return row_ptr, col_idx, np.bincount(group, weights=vals).astype(v_a.dtype, copy=False), (m, n)


def spgemm_symbolic(a: CSR, b: CSR):
    """Symbolic phase, on the host: C's pattern and the product map.

    Returns ``(pattern, a_pos, b_pos, out_pos, c_nnz)``: ``pattern`` is C as a
    CSR with zero values on A's device; ``a_pos``/``b_pos`` (int64, on A's
    device) index each product's factors in A's and B's values; ``out_pos``
    (int64, sorted) is its slot in C's values.  The numeric phase computes
    ``c_values[s] = sum of a_values[a_pos] * b_values[b_pos] over out_pos == s``.
    Raises ValueError when A and B lie on different devices or their inner
    dimensions differ."""
    if a.device != b.device:
        raise ValueError(f"spgemm: A is on {a.device}, B on {b.device}")
    _check_shapes(a.shape, b.shape)
    rp_a, ci_a, v_a, (m, _) = a.to_numpy()
    rp_b, ci_b, _, (_, n) = b.to_numpy()
    out_rows, a_pos, b_pos = _expand(rp_a.astype(np.int64), ci_a.astype(np.int64),
                                     rp_b.astype(np.int64))
    order, group, row_ptr, col_idx = _pattern(out_rows, ci_b[b_pos].astype(np.int64), m, n)
    # the product map permuted by the sort, so out_pos is sorted
    c_nnz = len(col_idx)
    pattern = CSR.from_numpy(row_ptr, col_idx, np.zeros(c_nnz, dtype=v_a.dtype), (m, n),
                             device=a.device)

    def dev(p):
        return torch.from_numpy(np.ascontiguousarray(p, dtype=np.int64)).to(a.device)

    return pattern, dev(a_pos[order]), dev(b_pos[order]), dev(group), c_nnz


def spgemm_numeric(a_values, b_values, a_pos, b_pos, out_pos, c_nnz: int) -> torch.Tensor:
    """Numeric phase, on the values' device: the products
    ``a_values[a_pos] * b_values[b_pos]`` summed over the sorted segments of
    ``out_pos`` into ``c_nnz`` values, with ``torch.segment_reduce``.  Each
    segment is summed in a fixed order, so two calls give the same bits; that
    order need not be the JAX package's ``segment_sum``'s, so results agree with
    it to rounding."""
    prod = a_values[a_pos] * b_values[b_pos]
    if c_nnz == 0:
        return prod.new_zeros(0)
    lengths = torch.bincount(out_pos, minlength=c_nnz)
    return torch.segment_reduce(prod, "sum", lengths=lengths)


def spgemm(a: CSR, b: CSR) -> CSR:
    """C = A @ B on A's device: symbolic on the host, numeric on the device."""
    pattern, a_pos, b_pos, out_pos, c_nnz = spgemm_symbolic(a, b)
    c_values = spgemm_numeric(a.values, b.values, a_pos, b_pos, out_pos, c_nnz)
    return CSR(pattern.row_ptr, pattern.col_idx, c_values, pattern.shape)
