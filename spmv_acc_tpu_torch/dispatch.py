"""Public SpMV API + runtime strategy picker.

Counterpart of the JAX package's ``spmv_acc_tpu/dispatch.py``.  ``spmv(...,
strategy=...)`` runs one strategy of ``STRATEGIES``; ``strategy='adaptive'``
picks one.  Three strategies run hand-written Hopper kernels on a CUDA tensor:
``swell`` (``ops/swell.py``), ``adaptive_plus`` (``ops/adaptive_plus.py``) and
``vector_row`` (``ops/vector_row.py``); the rest are plain PyTorch, as they were
plain XLA in the JAX package (``ops/xla.py``, ``ops/flat.py``, ``ops/zoo.py``).
``ell`` and ``vector_row`` run ``flat`` instead when the dense ELL slab would
pass ``_ELL_MAX_CELLS`` cells: a size rule decided before anything is
allocated, as in the reference.  Nothing catches a kernel's error.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .config import (DEFAULT_TUNE, FLAT_NNZ, IMBALANCE_RATIO, SHORT_ROW_AVG_NNZ,
                     SMALL_NNZ, TuneConfig)
from .formats.containers import CSR, ELL, sparse_operation
from .formats.convert import csr_to_ell, csr_transpose_arrays
from .ops import xla as _xla
from .plan import Plan, get_plan
from .utils.timer import sync

__all__ = ["Handle", "spmv", "pick_strategy", "make_spmv_fn", "sparse_csr_spmv",
           "STRATEGIES", "SWELL_MIN_FILL", "ell_cells", "clear_caches"]


@dataclasses.dataclass
class Handle:
    """Profiling handle (SpMVAccHanele analog, src/acc/api/handle.h:8-13): carries
    analyze/kernel phase times in µs out of a call.  As in the reference,
    ``analyze_time_us`` is ``get_plan`` alone, whatever the strategy name;
    ``kernel_time_us`` is the rest: the picker, the strategy's layout or pack
    build where the call makes one, and the kernel.  The device is synchronised
    before each time is taken."""

    analyze_time_us: float = 0.0
    kernel_time_us: float = 0.0
    destroy_time_us: float = 0.0  # plan eviction; ~0 (GC'd), kept for parity
    strategy_used: str = ""


# Swell fill gate: every matrix whose slab layout keeps at least this share of
# its padded slots busy goes to swell, on any device, unless the layout would
# pass ops.swell.SWELL_MAX_SLOTS.  Every corpus matrix has fill >= 0.1.  The
# value was fitted on the TPU (the JAX package's dispatch.py:53-59) and is kept
# for parity until H100 measurements refit it.
SWELL_MIN_FILL = 0.001

# The reference's eleven-strategy zoo (src/acc/CMakeLists.txt:2-14) plus the JAX
# package's swell/ell/acsr.
_ZOO = {"thread_row", "wf_row", "block_row", "light", "line_enhance", "acsr"}
STRATEGIES = {
    "adaptive", "default", "line", "ell", "flat", "vector_row",
    "adaptive_plus", "swell",
} | _ZOO

# Cells of the dense ELL slab past which ell and vector_row run flat instead
# (the JAX package's dispatch.py:46-51: one 4120-long row in a 200k-row matrix
# made a 3.07 GB slab there).
_ELL_MAX_CELLS = 1 << 27

# Transposes for trans='T' and ELL slabs for ell, vector_row and spmm, keyed like the plan cache:
# the entry holds the keyed tensors, so a recycled id() never serves another
# matrix's transpose.
_T_CACHE: dict = {}
_ELL_CACHE: dict = {}


def _get_ell(csr: CSR, tune: TuneConfig) -> ELL:
    key = (id(csr.row_ptr), id(csr.col_idx), id(csr.values), csr.shape,
           tune.ell_width_multiple)
    hit = _ELL_CACHE.get(key)
    if (hit is not None and hit[0] is csr.row_ptr and hit[1] is csr.col_idx
            and hit[2] is csr.values):
        return hit[3]
    e = csr_to_ell(csr, width_multiple=tune.ell_width_multiple)
    _ELL_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, e)
    return e


def _get_transposed(csr: CSR) -> CSR:
    key = (id(csr.row_ptr), id(csr.col_idx), id(csr.values), csr.shape)
    hit = _T_CACHE.get(key)
    if (hit is not None and hit[0] is csr.row_ptr and hit[1] is csr.col_idx
            and hit[2] is csr.values):
        return hit[3]
    rp, ci, v, shape = csr.to_numpy()
    trp, tci, tv = csr_transpose_arrays(rp, ci, v, shape)
    t = CSR.from_numpy(trp, tci, tv, (shape[1], shape[0]), device=csr.device)
    _T_CACHE[key] = (csr.row_ptr, csr.col_idx, csr.values, t)
    return t


def ell_cells(csr: CSR, tune: TuneConfig) -> int:
    """Padded cells the dense ELL of ``csr`` would allocate: rows x the longest
    row rounded up to ``tune.ell_width_multiple``."""
    wm = tune.ell_width_multiple
    maxlen = get_plan(csr, tune).stats.max_nnz_per_row
    return csr.rows * max(wm, -(-maxlen // wm) * wm)


def clear_caches() -> None:
    """Drop every cached plan, layout, pack, transpose and ELL slab."""
    from .ops.adaptive_plus import clear_tile_cache
    from .ops.swell import clear_swell_cache
    from .ops.zoo import clear_pack_cache
    from .plan import clear_plan_cache

    clear_plan_cache()
    clear_swell_cache()
    clear_tile_cache()
    clear_pack_cache()
    _T_CACHE.clear()
    _ELL_CACHE.clear()


def pick_strategy(plan: Plan, csr: Optional[CSR] = None) -> str:
    """Strategy selection.  Empty matrices go to ``default``; every matrix whose
    swell layout reaches ``SWELL_MIN_FILL`` and stays within
    ``ops.swell.SWELL_MAX_SLOTS`` goes to ``swell`` (its block size r chosen by
    the reference's detector); the rest walk the reference's adaptive decision
    tree (hip-adaptive/adaptive.cpp:16-67) exactly as the JAX package maps it:

      ① half-nnz imbalance ≥ 4×   → 'flat'
      ② avg nnz/row ≤ 4           → 'line'
      ③ nnz ≤ 0xC00000 (12.6M)    → 'ell' when rows are near-uniform else 'flat'
      ④ nnz > 2^23                → 'flat'
      ⑤ else                      → 'flat'
    """
    s = plan.stats
    if s.rows == 0 or s.nnz == 0:
        return "default"
    if csr is not None:
        from .ops.swell import swell_plan_within_cap

        layout = swell_plan_within_cap(csr)
        if layout is not None and layout.fill >= SWELL_MIN_FILL:
            return "swell"
    if s.half_imbalance >= IMBALANCE_RATIO:
        return "flat"
    if s.avg_nnz_per_row <= SHORT_ROW_AVG_NNZ:
        return "line"
    if s.nnz <= SMALL_NNZ:
        if s.row_len_cv < 0.5 and s.max_nnz_per_row <= 4 * s.avg_nnz_per_row:
            return "ell"
        return "flat"
    if s.nnz > FLAT_NNZ:
        return "flat"
    return "flat"


def _run(strategy: str, alpha, beta, csr: CSR, x, y, plan: Plan):
    if csr.cols == 0:  # A@x = 0; padded layouts would gather column 0 of an empty x
        return _xla.axpby_finish(alpha, beta, y.new_zeros(csr.rows, dtype=csr.dtype), y)
    if strategy in ("ell", "vector_row") and ell_cells(csr, plan.tune) > _ELL_MAX_CELLS:
        strategy = "flat"
    if strategy == "default":
        return _xla.spmv_default(alpha, beta, csr, x, y, plan)
    if strategy == "line":
        return _xla.spmv_line(alpha, beta, csr, x, y, plan)
    if strategy == "ell":
        return _xla.spmv_ell(alpha, beta, _get_ell(csr, plan.tune), x, y, csr.rows)
    if strategy == "flat":
        from .ops.flat import spmv_flat

        return spmv_flat(alpha, beta, csr, x, y, plan)
    if strategy == "vector_row":
        from .ops.vector_row import spmv_vector_row

        return spmv_vector_row(alpha, beta, _get_ell(csr, plan.tune), x, y, csr.rows)
    if strategy == "adaptive_plus":
        from .ops.adaptive_plus import spmv_adaptive_plus

        return spmv_adaptive_plus(alpha, beta, csr, x, y, plan)
    if strategy == "swell":
        from .ops.swell import spmv_swell

        return spmv_swell(alpha, beta, csr, x, y, plan)
    if strategy in _ZOO:
        from .ops import zoo

        return getattr(zoo, f"spmv_{strategy}")(alpha, beta, csr, x, y, plan)
    raise ValueError(f"unknown strategy {strategy!r} (one of {sorted(STRATEGIES)})")


def spmv(
    csr: CSR,
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    alpha=1.0,
    beta=0.0,
    trans: str = sparse_operation.SPARSE_OPERATION_NON_TRANSPOSE,
    strategy: str = "adaptive",
    tune: TuneConfig = DEFAULT_TUNE,
    handle: Optional[Handle] = None,
) -> torch.Tensor:
    """``y_out = alpha * op(A) @ x + beta * y`` — the public entry point
    (analog of ``sparse_csr_spmv``, src/acc/api/spmv.h:20-21).

    ``csr``, ``x`` and ``y`` lie on one device, which is where the work runs.
    ``trans='T'`` computes A^T@x via a cached host transpose.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (one of {sorted(STRATEGIES)})")
    if trans == sparse_operation.SPARSE_OPERATION_TRANSPOSE:
        csr = _get_transposed(csr)
    if y is None:
        y = torch.zeros(csr.rows, dtype=csr.values.dtype, device=csr.device)
        beta = 0.0
    if handle is not None:
        sync(csr.device)
    t0 = time.perf_counter()
    plan = get_plan(csr, tune)
    t1 = time.perf_counter()
    chosen = pick_strategy(plan, csr) if strategy == "adaptive" else strategy
    out = _run(chosen, alpha, beta, csr, x, y, plan)
    if handle is not None:
        sync(csr.device)
        t2 = time.perf_counter()
        handle.analyze_time_us = (t1 - t0) * 1e6
        handle.kernel_time_us = (t2 - t1) * 1e6
        handle.strategy_used = chosen
    return out


def make_spmv_fn(
    csr: CSR,
    alpha=1.0,
    beta=1.0,
    strategy: str = "adaptive",
    tune: TuneConfig = DEFAULT_TUNE,
):
    """``step(x, y) -> y_out`` with the plan, the strategy's layout or pack and
    the strategy chosen up front, so a loop (CG, the CLIs' timed runs) pays no
    analysis per call.

    Returns (step, chosen_strategy_name)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (one of {sorted(STRATEGIES)})")
    plan = get_plan(csr, tune)
    chosen = pick_strategy(plan, csr) if strategy == "adaptive" else strategy
    if chosen == "swell":
        from .ops.swell import get_swell_plan, swell_ax

        layout = get_swell_plan(csr)

        def step(x, y):
            return _xla.axpby_finish(alpha, beta, swell_ax(layout, x), y)
    else:
        def step(x, y):
            return _run(chosen, alpha, beta, csr, x, y, plan)

        # build the strategy's layout or pack now, not in the caller's first timed call
        step(torch.zeros(csr.cols, dtype=csr.dtype, device=csr.device),
             torch.zeros(csr.rows, dtype=csr.dtype, device=csr.device))
    return step, chosen


def sparse_csr_spmv(trans, alpha, beta, csr: CSR, x, y, strategy: str = "adaptive"):
    """Signature-compatible shim mirroring the reference's public API
    (src/acc/api/spmv.h:20-21): ``sparse_csr_spmv(trans, alpha, beta, desc, dx, dy)``."""
    return spmv(csr, x, y, alpha=alpha, beta=beta, trans=trans, strategy=strategy)
