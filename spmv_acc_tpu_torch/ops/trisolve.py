"""ILU(0) factorization and sparse triangular solves on PyTorch: the
preconditioner of the CG solver in :mod:`spmv_acc_tpu_torch.models.cg`.

Counterpart of ``spmv_acc_tpu/ops/trisolve.py``, with the same results:

* **Factorization** is host-side (sequential data flow): native C++
  ``native/spmv_native.cpp::ilu0_factor`` (a sorted two-pointer row merge), or
  the Python IKJ loop without the library.
* **Level analysis**: one sequential native pass per factor
  (``trisolve_levels``); the dependency extraction and the chunk schedule are
  vectorised numpy.
* **Exact solve** (:func:`trisolve`): dependencies and rows are sorted by
  level.  The JAX package runs the solve as one XLA ``fori_loop`` over a chunk
  schedule (each iteration scatter-adds at most ``_W`` dependency products
  into partial sums, then finalises at most ``_R`` rows), with no Pallas
  kernel.  On the card the port runs it as F-3 (``csrc/trisolve.cu``, entry
  ``tri_levels``): one launch per solve in which each row, in level order,
  waits only on its own dependencies, each through that row's slot (its
  value beside the epoch that wrote it: the plan's ready flags, made at its
  first launch by :func:`_flags`), sums them in plan order and publishes
  its own; no barrier between levels.  The launch holds the rows in flight
  that the plan's shape asks for (:func:`_walk_shape`): one block, whose
  rows meet in the SM's L1, or a cooperative grid, whose rows meet in L2.
  :func:`trisolve_plain` keeps the chunk schedule as a Python loop of PyTorch
  ops (its offsets and counts on the host, so it slices without the JAX
  package's static-shape padding: no ``_W`` / ``_R`` pad and no sink slot);
  it runs on the CPU and is the reference the kernel is held to.
* **Sweep solve** (:func:`trisolve_sweeps`): S Jacobi sweeps
  y <- (b - N y) / D from y = b / D.  Rows at level < t are exact after t
  sweeps.  On the card one cooperative launch of F-3's ``tri_sweeps`` (two
  buffers swapped at each ``grid.sync()``); :func:`trisolve_sweeps_plain`, one
  gather and one ``index_add_`` a sweep, on the CPU.
* **Swell backing** (:class:`SweepSwell`): on factors with at least
  ``ILU_SWELL_MIN`` off-diagonal nnz, each sweep's N @ y runs on the swell
  kernel (``ops/swell.py``) over the strict L and U parts, with the sweep's
  subtract and diagonal scale in the kernel's store (``swell_sweep``, one
  launch a sweep) where the factor's layout has no COO tail.
* **Gauss-Seidel** (:func:`gauss_seidel_split`): F-3 plans of D + L and
  D + U of a matrix itself, and its strict parts, for the symmetric
  Gauss-Seidel smoother of ``models/mg.py``.
* **Refactor** (:meth:`ILU0.refactor`): the numeric factor of new values on
  the pattern a handle was made from, written into the handle's own tensors
  (both plans' values and diagonal, the sweep layouts' value cells,
  ``inv_diag``), so a kept solver's captured graphs read it.  On the card
  one launch of F-4 (``csrc/trisolve.cu``, entry ``ilu0_refactor``):
  ``ilu0_host``'s IKJ factor bit for bit, a warp a row on ready flags as
  F-3's walk, waiting on a lower row only where it needs it, the updates
  from the symbolic factor :func:`_ikj_updates` lists once; on the CPU
  ``ilu0_host``.

Both kernels sum a row's products in plan order from 0 and round each
multiply, add, subtract and divide as the plain version does (no contracted
FMA), so on the same inputs they give the plain version's bits on the CPU,
and two launches give the same bits.  On the card the plain versions'
``index_add_`` adds with float atomics in no fixed order.

The two factor layouts are built one after the other: the JAX package builds
them on two threads against an unlocked plan cache (``trisolve.py:403-413``);
the port does not share that hazard.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..formats.containers import CSR
from ..utils import profiling

__all__ = ["ilu0_host", "TriSolvePlan", "analyze_trisolve", "trisolve", "trisolve_plain",
           "trisolve_sweeps", "trisolve_sweeps_plain", "SweepSwell", "sweep_apply_swell",
           "ILU0", "ilu0", "gauss_seidel_split", "ILU_SWELL_MIN", "ILU_AUTO_SWEEPS", "LAUNCHES"]

# chunk sizes of the exact schedule (dependencies / rows per iteration)
_W = 4096
_R = 4096
# the exact schedule is built only for factors with at most this many levels;
# beyond it the schedule degenerates toward one iteration per level
_EXACT_MAX_LEVELS = 4096
# off-diagonal nnz (L + U) from which ilu0's sweep solves run on the swell
# kernel; the JAX package's SPMV_TPU_ILU_SWELL_MIN default
ILU_SWELL_MIN = 100_000
# Jacobi sweeps per solve when ilu0(sweeps=None) finds no exact schedule
ILU_AUTO_SWEEPS = 6
# tri_levels' rows in flight: this many times the plan's widest level, so
# that a row's loads that do not wait on y run levels ahead of the chain
_AHEAD = 4
# the most threads of tri_levels' one-block walk (csrc/trisolve.cu kThreads);
# a plan that wants more rows in flight takes the cooperative grid
_BLOCK_MAX = 256
# tri_levels' forms by name (its C entry's codes)
_FORMS = {"block": 0, "grid": 1}

# F-3 and F-4 launches in this process by (dtype, entry): ("f64" | "f32",
# "levels_block" | "levels_grid" | "sweeps"), and ("f64", "factor") for F-4.
# Only the launch sites add to it (and a captured graph's replays,
# utils/graphs.py); set to 0 with ``.clear()`` to count a run.
LAUNCHES: collections.Counter = collections.Counter()
_DTYPES = {torch.float64: "f64", torch.float32: "f32"}


def ilu0_host(row_ptr, col_idx, values, shape):
    """In-pattern incomplete LU (no fill-in), float64.  Returns the combined LU
    values on the same CSR pattern: strictly-lower entries hold L (unit diagonal
    implied), diagonal and upper hold U.  Native C++ first; the Python IKJ loop
    without the library.  Rows must hold sorted columns and a diagonal entry."""
    rp = np.asarray(row_ptr).astype(np.int64)
    ci = np.asarray(col_idx).astype(np.int64)
    m = shape[0]
    from ..io.native import ilu0_factor_native

    lu = ilu0_factor_native(rp, ci, values, m)
    if lu is not None:
        return lu
    lu = np.array(values, dtype=np.float64, copy=True)
    diag_pos = np.full(m, -1, dtype=np.int64)
    col_map: List[dict] = [dict() for _ in range(m)]
    for i in range(m):
        for p in range(rp[i], rp[i + 1]):
            col_map[i][int(ci[p])] = p
            if ci[p] == i:
                diag_pos[i] = p
    if (diag_pos < 0).any():
        missing = int(np.flatnonzero(diag_pos < 0)[0])
        raise ValueError(f"ILU(0) requires a full diagonal; row {missing} has none")
    for i in range(m):
        for p in range(rp[i], rp[i + 1]):
            k = int(ci[p])
            if k >= i:
                break
            lik = lu[p] / lu[diag_pos[k]]
            lu[p] = lik
            krow = col_map[k]
            for q in range(p + 1, rp[i + 1]):
                j = int(ci[q])
                pos = krow.get(j)
                if pos is not None and j > k:
                    lu[q] -= lik * lu[pos]
    return lu


def _levels(rp, ci, m, lower):
    """Dependency level per row and the level count (native pass; numpy loop
    without the library)."""
    from ..io.native import trisolve_levels_native

    res = trisolve_levels_native(rp, ci, m, lower)
    if res is not None:
        return res
    level = np.zeros(m, dtype=np.int32)
    rows_iter = range(m) if lower else range(m - 1, -1, -1)
    for i in rows_iter:
        lvl = 0
        for p in range(rp[i], rp[i + 1]):
            j = int(ci[p])
            if (lower and j < i) or (not lower and j > i):
                lvl = max(lvl, level[j] + 1)
        level[i] = lvl
    return level, int(level.max()) + 1 if m else 1


@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Level schedule of one triangular factor.

    Dependencies (off-diagonal triplets) are sorted by the level of their row
    (stable, so CSR order within a level) and live on the plan's device; a
    row's dependencies are contiguous there, at ``dep_start[row]`` for
    ``dep_len[row]`` (0 and 0 for a row without one), which F-3 reads.
    Level L holds rows ``rows_sorted[level_ptr[L] : level_ptr[L + 1]]``;
    ``widest_level`` is the most rows of one level.

    The host chunk schedule, which :func:`trisolve_plain` walks: iteration t
    scatter-adds dependencies ``[dep_off[t], dep_off[t] + dep_cnt[t])`` and
    then finalises rows ``rows_sorted[row_off[t] : row_off[t] + row_cnt[t]]``;
    within one iteration the dependencies land before the rows read them, so
    the last dependency chunk of a level may share an iteration with its
    first row chunk.  ``rows_sorted``, ``level_ptr`` and the schedule are None
    past ``_EXACT_MAX_LEVELS`` levels.

    F-3's ready flags live in ``_walk``, made by the plan's first
    ``tri_levels`` launch (:func:`_flags`): a plan solved only on the CPU or
    by sweeps carries none."""

    m: int
    lower: bool
    num_levels: int
    level_of_row: np.ndarray        # host (m,) int32
    dep_rows: torch.Tensor          # (ndep,) int64
    dep_cols: torch.Tensor          # (ndep,) int64
    dep_vals: torch.Tensor          # (ndep,) value dtype
    diag: torch.Tensor              # (m,) diagonal (ones for a unit diagonal)
    dep_start: torch.Tensor         # (m,) int64, a row's first dependency
    dep_len: torch.Tensor           # (m,) int64, its dependencies
    widest_level: int
    num_iters: int
    rows_sorted: Optional[torch.Tensor]  # (m,) int64, rows by level
    level_ptr: Optional[torch.Tensor]    # (num_levels + 1,) int64 into rows_sorted
    dep_off: Optional[np.ndarray]   # host (num_iters,) int64
    dep_cnt: Optional[np.ndarray]
    row_off: Optional[np.ndarray]
    row_cnt: Optional[np.ndarray]
    # dtype -> (dep_vals, diag) in that dtype, each cast made once
    _cast: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    # tri_levels' ready flags (_flags) and the stream of its last launch (_order)
    _walk: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_deps(self) -> int:
        return int(self.dep_rows.shape[0])

    def values(self, dtype: torch.dtype):
        """``(dep_vals, diag)`` in ``dtype``: the plan's own tensors, or a copy
        cast once and kept."""
        if dtype == self.dep_vals.dtype and dtype == self.diag.dtype:
            return self.dep_vals, self.diag
        got = self._cast.get(dtype)
        if got is None:
            got = self._cast[dtype] = (self.dep_vals.to(dtype), self.diag.to(dtype))
        return got


def analyze_trisolve(row_ptr, col_idx, values, shape, lower: bool, unit_diag: bool,
                     device="cpu") -> TriSolvePlan:
    """Level analysis and the chunk schedule of the lower (``lower``) or upper
    triangle of a CSR matrix; the diagonal is taken from the matrix unless
    ``unit_diag``.  Host numpy on top of the native level pass; the plan's
    tensors are moved to ``device``."""
    rp = np.asarray(row_ptr).astype(np.int64)
    ci = np.asarray(col_idx).astype(np.int64)
    v = np.asarray(values)
    m = shape[0]
    rows_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    off_mask = (ci < rows_of) if lower else (ci > rows_of)
    dep_r, dep_c, dep_v = rows_of[off_mask], ci[off_mask], v[off_mask]
    diag = np.ones(m, dtype=v.dtype)
    if not unit_diag:
        dmask = ci == rows_of
        diag[rows_of[dmask]] = v[dmask]
    level, num_levels = _levels(rp, ci, m, lower)

    order_d = np.argsort(level[dep_r], kind="stable")
    dep_r, dep_c, dep_v = dep_r[order_d], dep_c[order_d], dep_v[order_d]
    # the stable sort keeps a row's dependencies together: each row's first
    # position is where the sorted rows change
    first = np.flatnonzero(np.diff(dep_r, prepend=-1))
    dep_start = np.zeros(m, dtype=np.int64)
    dep_start[dep_r[first]] = first
    dep_len = np.bincount(dep_r, minlength=m).astype(np.int64)
    rl = np.bincount(level, minlength=num_levels).astype(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    common = dict(m=m, lower=lower, num_levels=num_levels, level_of_row=level,
                  dep_rows=t(dep_r), dep_cols=t(dep_c), dep_vals=t(dep_v), diag=t(diag),
                  dep_start=t(dep_start), dep_len=t(dep_len),
                  widest_level=int(rl.max()) if m else 0)
    if num_levels > _EXACT_MAX_LEVELS:
        return TriSolvePlan(**common, num_iters=0, rows_sorted=None, level_ptr=None,
                            dep_off=None, dep_cnt=None, row_off=None, row_cnt=None)

    order_r = np.argsort(level, kind="stable")
    dl = np.bincount(level[dep_r], minlength=num_levels).astype(np.int64)
    dstart = np.concatenate([[0], np.cumsum(dl)])
    rstart = np.concatenate([[0], np.cumsum(rl)])

    d_off, d_cnt, r_off, r_cnt = [], [], [], []
    for lvl in range(num_levels):
        nd = int(-(-dl[lvl] // _W))  # dependency chunks
        nr = int(-(-rl[lvl] // _R))  # row chunks (>= 1: every level owns rows)
        rows_at = max(nd - 1, 0)     # rows may start on the last dependency chunk
        for it in range(max(nd, rows_at + nr)):
            if it < nd:
                d_off.append(dstart[lvl] + it * _W)
                d_cnt.append(int(min(_W, dl[lvl] - it * _W)))
            else:
                d_off.append(0)
                d_cnt.append(0)
            rt = it - rows_at
            if 0 <= rt < nr:
                r_off.append(rstart[lvl] + rt * _R)
                r_cnt.append(int(min(_R, rl[lvl] - rt * _R)))
            else:
                r_off.append(0)
                r_cnt.append(0)
    return TriSolvePlan(**common, num_iters=len(d_off), rows_sorted=t(order_r),
                        level_ptr=t(rstart.astype(np.int64)),
                        dep_off=np.asarray(d_off, dtype=np.int64),
                        dep_cnt=np.asarray(d_cnt, dtype=np.int64),
                        row_off=np.asarray(r_off, dtype=np.int64),
                        row_cnt=np.asarray(r_cnt, dtype=np.int64))


def trisolve_plain(plan: TriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """T y = b exactly on ``b``'s device as PyTorch ops, by the chunk
    schedule; a factor without one (more than ``_EXACT_MAX_LEVELS`` levels)
    runs ``num_levels`` Jacobi sweeps, which are exact too.  The CPU path of
    :func:`trisolve` and the reference its kernel is held to."""
    if plan.rows_sorted is None:
        return trisolve_sweeps_plain(plan, b, plan.num_levels)
    dep_vals, diag = plan.values(b.dtype)
    y = torch.zeros_like(b)
    sums = torch.zeros_like(b)
    for t in range(plan.num_iters):
        dcnt = int(plan.dep_cnt[t])
        if dcnt:
            d = slice(int(plan.dep_off[t]), int(plan.dep_off[t]) + dcnt)
            sums.index_add_(0, plan.dep_rows[d], dep_vals[d] * y[plan.dep_cols[d]])
        rcnt = int(plan.row_cnt[t])
        if rcnt:
            rows = plan.rows_sorted[int(plan.row_off[t]): int(plan.row_off[t]) + rcnt]
            y[rows] = (b[rows] - sums[rows]) / diag[rows]
    return y


def trisolve_sweeps_plain(plan: TriSolvePlan, b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` Jacobi iterations y <- (b - N y) / D from y = b / D as
    PyTorch ops, each one gather and one ``index_add_`` (the JAX package's
    ``segment_sum``).  The CPU path of :func:`trisolve_sweeps` and the
    reference its kernel is held to."""
    dep_vals, diag = plan.values(b.dtype)
    y = b / diag
    for _ in range(sweeps):
        sums = torch.zeros_like(b).index_add_(0, plan.dep_rows, dep_vals * y[plan.dep_cols])
        y = (b - sums) / diag
    return y


def _check(name: str, plan: TriSolvePlan, b) -> str:
    """``b`` one float64/float32 vector of ``plan.m`` on the plan's device
    (contiguous on the card); returns the device type."""
    if not isinstance(b, torch.Tensor):
        raise TypeError(f"{name}: b must be a torch.Tensor, got {type(b).__name__}")
    if b.dtype not in _DTYPES:
        raise ValueError(f"{name} runs float64 and float32, not {b.dtype}")
    if b.dim() != 1 or b.shape[0] != plan.m:
        raise ValueError(f"{name}: b has shape {tuple(b.shape)}, the factor ({plan.m},)")
    if b.device != plan.diag.device:
        raise ValueError(f"{name}: b is on {b.device}, the plan on {plan.diag.device}")
    if b.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"{name} has no kernel for device {b.device}")
    if b.device.type == "cuda" and not b.is_contiguous():
        raise ValueError(f"{name}: b must be contiguous")
    return b.device.type


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(entry: str, key: str, b: torch.Tensor, *args, plan=None) -> None:
    """One launch of ``entry`` on b's current stream, ordered after the
    plan's last launch where ``plan`` is given (:func:`_order`)."""
    from ._build import TRISOLVE_SRC, load_lib

    lib = load_lib(TRISOLVE_SRC)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device)
        if plan is not None:
            _order(plan, stream)
        rc = getattr(lib, entry)(int(b.dtype == torch.float64), *args,
                                 ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[(_DTYPES[b.dtype], key)] += 1


def _sweeps_kernel(plan: TriSolvePlan, b: torch.Tensor, sweeps: int) -> torch.Tensor:
    dep_vals, diag = plan.values(b.dtype)
    y = torch.empty_like(b)
    scratch = torch.empty_like(b)
    _launch("tri_sweeps", "sweeps", b, plan.m, sweeps, _ptr(plan.dep_start), _ptr(plan.dep_len),
            _ptr(plan.dep_cols), _ptr(dep_vals), _ptr(diag), _ptr(b), _ptr(y), _ptr(scratch))
    return y


def _walk_shape(plan: TriSolvePlan):
    """``(form, in_flight)`` of ``tri_levels`` on ``plan``: ``_AHEAD`` times
    the widest level's rows in flight, in one block ("block") where that
    fits ``_BLOCK_MAX`` threads, else in a cooperative grid ("grid")."""
    in_flight = _AHEAD * plan.widest_level
    return ("grid" if in_flight > _BLOCK_MAX else "block"), in_flight


def _flags(plan: TriSolvePlan):
    """``(slots, epoch)``, ``tri_levels``' ready flags on ``plan``: two int64
    words a row (a row's value beside the epoch that wrote it) and one int32
    epoch, made zeroed on the plan's device at its first launch and kept on
    it."""
    got = plan._walk.get("flags")
    if got is None:
        dev = plan.diag.device
        got = plan._walk["flags"] = (torch.zeros(2 * plan.m, dtype=torch.int64, device=dev),
                                     torch.zeros(1, dtype=torch.int32, device=dev))
    return got


def _order(plan: TriSolvePlan, stream) -> None:
    """Two launches on one plan must not overlap: both would publish with the
    same epoch, and a row could take the other's value.  So a launch on
    ``stream``, another stream than the plan's last, waits for that stream
    first (``stream``'s device is the current one).  A capture orders
    nothing: its graph's replays run where they are replayed, after whatever
    ran before them there."""
    last = plan._walk.get("stream")
    if last != stream and not torch.cuda.is_current_stream_capturing():
        if last is not None:
            stream.wait_stream(last)
        plan._walk["stream"] = stream


def trisolve(plan: TriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """Solve T y = b exactly.  For a CUDA ``b``, one launch of F-3
    (``csrc/trisolve.cu``): ``tri_levels``, each row waiting only on its own
    dependencies through the plan's ready flags, in one block or a
    cooperative grid by :func:`_walk_shape`; or, past ``_EXACT_MAX_LEVELS``
    levels, ``tri_sweeps`` with ``num_levels`` sweeps.  For a CPU ``b``,
    :func:`trisolve_plain`.

    The flags make a plan's exact solves one at a time: a solve on another
    stream than the plan's last waits for that stream (:func:`_order`).  A
    captured graph that solves on the plan must not be replayed while
    another solve of the plan runs."""
    if _check("trisolve", plan, b) == "cpu":
        return trisolve_plain(plan, b)
    if plan.m == 0:
        return torch.empty_like(b)
    if plan.rows_sorted is None:
        return _sweeps_kernel(plan, b, plan.num_levels)
    dep_vals, diag = plan.values(b.dtype)
    y = torch.empty_like(b)
    form, in_flight = _walk_shape(plan)
    slots, epoch = _flags(plan)
    _launch("tri_levels", f"levels_{form}", b, _FORMS[form], in_flight, plan.m,
            _ptr(plan.rows_sorted), _ptr(plan.dep_start), _ptr(plan.dep_len),
            _ptr(plan.dep_cols), _ptr(dep_vals), _ptr(diag), _ptr(b), _ptr(y), _ptr(slots),
            _ptr(epoch), plan=plan)
    return y


def trisolve_sweeps(plan: TriSolvePlan, b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Approximate triangular solve: ``sweeps`` Jacobi iterations
    y <- (b - N y) / D from y = b / D; ``sweeps >= num_levels`` is exact.  For
    a CUDA ``b``, one cooperative launch of F-3's ``tri_sweeps``; for a CPU
    ``b``, :func:`trisolve_sweeps_plain`."""
    device = _check("trisolve_sweeps", plan, b)
    if isinstance(sweeps, bool) or not isinstance(sweeps, (int, np.integer)) or sweeps < 0:
        raise ValueError(f"trisolve_sweeps: sweeps must be an int >= 0, got {sweeps!r}")
    if device == "cpu":
        return trisolve_sweeps_plain(plan, b, int(sweeps))
    if plan.m == 0:
        return torch.empty_like(b)
    return _sweeps_kernel(plan, b, int(sweeps))


@dataclasses.dataclass(frozen=True)
class SweepSwell:
    """Swell-kernel backing of the sweep solves: the swell layouts of the strict
    L and U parts and 1 / diag(U).  Built by :func:`ilu0` for factors with at
    least ``ILU_SWELL_MIN`` off-diagonal nnz."""

    layout_l: object  # ops.swell.DeviceSwellLayout
    layout_u: object
    inv_diag: torch.Tensor  # (m,)


def sweep_apply_swell(swell: SweepSwell, sweeps: int, r: torch.Tensor) -> torch.Tensor:
    """M^{-1} r by ``sweeps`` Jacobi sweeps per factor, N @ y on the swell
    kernel: the semantics of :func:`trisolve_sweeps` (unit-lower L from z = r,
    then U from u = z / D).  Each sweep is one :func:`_sweep`; u = z / D
    between the factors stays a separate multiply."""
    inv = swell.inv_diag.to(r.dtype)
    z = r
    for _ in range(sweeps):
        z = _sweep(swell.layout_l, z, r, None)
    u = z * inv
    for _ in range(sweeps):
        u = _sweep(swell.layout_u, u, z, inv)
    return u


def _sweep(layout, v: torch.Tensor, c: torch.Tensor, d: Optional[torch.Tensor]) -> torch.Tensor:
    """One sweep, ``(c - N v) * d`` (``c - N v`` without ``d``): the swell
    kernel's sweep store (``swell_sweep``: one launch, the same bits) where the
    factor's layout has no COO tail and holds c's dtype; else ``swell_ax`` and
    the separate subtract and multiply.  Counted when the host runs it (in
    a captured block, at capture) as ``ilu.sweeps.fused`` or
    ``ilu.sweeps.unfused``, ILU(0)'s sweeps and ``models/mg.py``'s products
    alike."""
    from .swell import swell_ax, swell_sweep

    if layout.tail_v.numel() == 0 and layout.dtype == c.dtype:
        profiling.count("ilu.sweeps.fused")
        return swell_sweep(layout, v, c, d)
    profiling.count("ilu.sweeps.unfused")
    y = c - swell_ax(layout, v.to(layout.dtype)).to(c.dtype)
    return y if d is None else y * d


@dataclasses.dataclass(frozen=True)
class ILU0:
    """Factorization handle: M^{-1} r by two triangular solves.

    ``sweeps`` > 0 makes both solves Jacobi-sweep approximations; 0 means the
    exact solves.  On the card each factor solve is one F-3 launch;
    ``swell`` (set by :func:`ilu0` on large factors) runs each sweep's N @ y
    on the swell kernel instead.  ``pattern`` is the ``(row_ptr, col_idx,
    shape)`` of the CSR :func:`ilu0` factored, which :meth:`refactor` takes
    new values on."""

    l_plan: TriSolvePlan
    u_plan: TriSolvePlan
    sweeps: int = 0
    swell: Optional[SweepSwell] = None
    pattern: Optional[tuple] = dataclasses.field(default=None, compare=False)
    # refactor's state (_Numeric under "state"), made at its first call
    _numeric: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        if self.swell is not None and self.sweeps > 0:
            return sweep_apply_swell(self.swell, self.sweeps, r)
        if self.sweeps > 0:
            z = trisolve_sweeps(self.l_plan, r, self.sweeps)
            return trisolve_sweeps(self.u_plan, z, self.sweeps)
        z = trisolve(self.l_plan, r)     # L z = r (unit lower)
        return trisolve(self.u_plan, z)  # U y = z

    def refactor(self, csr: CSR) -> None:
        """Factor ``csr``'s current values into this handle: the numeric
        ILU(0) of a matrix on the pattern the handle was made from (else
        ValueError), bit for bit what :func:`ilu0` of those values holds,
        written in place into every value tensor the handle holds (the plans'
        ``dep_vals`` and ``diag`` and their casts, the sweep layouts' value
        cells, ``inv_diag``).  So a solver kept with this handle, its
        captured graphs too, preconditions with the new factor.  On the card
        one launch of F-4 on the current stream, no host read; on the CPU
        ``ilu0_host``.  The positions it writes from, and on the card F-4's
        arguments and library, are made at the first call (span
        ``ilu0.refactor.setup``, with the layouts' ``swell.value_map``).  A
        captured refactor rewrites the tensors the handle held when it was
        captured (a cast to another dtype made later is not among them).

        Span ``ilu0.refactor``; counters ``ilu.refactors``,
        ``ilu.refactor.host`` (factors on the host), ``ilu.refactor.rows``
        and ``ilu.refactor.nnz`` (the pattern's, summed over refactors)."""
        with profiling.span("ilu0.refactor"):
            _refactor(self, csr)


@dataclasses.dataclass
class _Numeric:
    """:meth:`ILU0.refactor`'s state on a handle.  ``lu`` holds a 0 and then
    the factor in CSR order (float64); ``l_pos``, ``u_pos`` and ``diag_pos``
    (int32) say where in ``lu`` each value of ``l_plan.dep_vals``,
    ``u_plan.dep_vals`` and ``u_plan.diag`` lies, ``maps`` the sweep layouts'
    value maps into ``lu`` (None without them).  On the card ``kernel``
    holds F-4's arguments: the rows in the L-solve's level order, the
    pattern (int32), each row's diagonal position, the symbolic factor
    (:func:`_ikj_updates`), the ready flags and epoch, the rows in flight;
    ``_walk`` the stream of its last launch (:func:`_order`).  On the CPU
    ``host`` holds the pattern's host arrays."""

    lu: torch.Tensor
    l_pos: torch.Tensor
    u_pos: torch.Tensor
    diag_pos: torch.Tensor
    maps: Optional[tuple]
    kernel: Optional[tuple]
    host: Optional[tuple]
    _walk: dict = dataclasses.field(default_factory=dict)


def _same_pattern(ilu: ILU0, csr: CSR) -> None:
    """Raise unless ``csr`` is on the handle's device and has its pattern."""
    if ilu.pattern is None:
        raise ValueError("refactor: this ILU0 was not made by ilu0, so it has no pattern")
    rp, ci, shape = ilu.pattern
    if csr.device != ilu.u_plan.diag.device:
        raise ValueError(f"refactor: the CSR is on {csr.device}, the factor on "
                         f"{ilu.u_plan.diag.device}")
    if (csr.row_ptr is rp and csr.col_idx is ci) or (
            tuple(csr.shape) == tuple(shape) and csr.row_ptr.shape == rp.shape
            and csr.col_idx.shape == ci.shape
            and torch.equal(csr.row_ptr.long(), rp.long())
            and torch.equal(csr.col_idx.long(), ci.long())):
        return
    raise ValueError("refactor: the CSR's pattern is not the one this factor was made from")


# candidate updates a chunk of _ikj_updates examines at once (bounds its memory)
_IKJ_CHUNK = 1 << 24


def _ikj_updates(row_ptr: torch.Tensor, col_idx: torch.Tensor, diag: torch.Tensor, n: int):
    """The symbolic ILU(0) factor of a CSR pattern (sorted columns, no
    repeats, a diagonal a row at ``diag``), as torch ops on the pattern's
    device: each strict-lower entry q (row i, column k) updates lu[t] -=
    l * lu[s] for every later entry t of row i whose column row k holds after
    its diagonal, at s (``ilu0_host``'s merge).  Returns ``(ptr, t, s)``: q's
    pairs at ``ptr[q] .. ptr[q + 1]`` (int64, over all nnz + 1 positions;
    none but a strict-lower entry's), ``t`` ascending within one (int32)."""
    rp, ci, dg = row_ptr.long(), col_idx.long(), diag.long()
    m, nnz, dev = rp.numel() - 1, ci.numel(), ci.device
    rows = torch.repeat_interleave(torch.arange(m, device=dev), rp.diff())
    keys = rows * n + ci  # ascending: rows in order, columns sorted in each
    lower = torch.nonzero(ci < rows).squeeze(1)
    first = dg[ci[lower]] + 1  # row k's entries after its diagonal
    count = rp[ci[lower] + 1] - first
    ends = torch.cumsum(count, 0)
    per_q = torch.zeros(nnz, dtype=torch.int64, device=dev)
    ts = [torch.zeros(0, dtype=torch.int32, device=dev)]
    ss = list(ts)
    a = 0
    while a < lower.numel():
        done = int(ends[a - 1]) if a else 0
        b = max(a + 1, int(torch.searchsorted(ends, done + _IKJ_CHUNK, right=True)))
        c = count[a:b]
        which = torch.repeat_interleave(torch.arange(a, b, device=dev), c)
        start = torch.cumsum(c, 0) - c
        s = first[which] + torch.arange(int(c.sum()), device=dev) - start.repeat_interleave(c)
        want = rows[lower[which]] * n + ci[s]
        t = torch.searchsorted(keys, want).clamp_(max=nnz - 1)
        hit = keys[t] == want
        per_q += torch.bincount(lower[which][hit], minlength=nnz)
        ts.append(t[hit].to(torch.int32))
        ss.append(s[hit].to(torch.int32))
        a = b
    ptr = torch.zeros(nnz + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_q, 0, out=ptr[1:])
    return ptr, torch.cat(ts), torch.cat(ss)


def _numeric(ilu: ILU0, csr: CSR) -> _Numeric:
    """The handle's refactor state, made at its first call from ``csr``'s
    pattern (host numpy; on the card the symbolic factor by torch ops there),
    in the span ``ilu0.refactor.setup``."""
    st = ilu._numeric.get("state")
    if st is not None:
        return st
    from .swell import value_map

    with profiling.span("ilu0.refactor.setup"):
        rp = csr.row_ptr.cpu().numpy().astype(np.int64)
        ci = csr.col_idx.cpu().numpy().astype(np.int64)
        m, dev = csr.rows, csr.device
        rows_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))

        def t(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        def dep_pos(plan, mask):
            # analyze_trisolve's order: by level of the row, stable
            pos = np.flatnonzero(mask)
            return pos[np.argsort(plan.level_of_row[rows_of[pos]], kind="stable")]

        def layout_map(layout, mask):
            # the strict part's value map (ilu0's _strict_part_csr pattern), into lu
            pos = np.flatnonzero(mask)
            srp = np.concatenate([[0], np.cumsum(np.bincount(rows_of[pos], minlength=m))])
            vmap = value_map(layout, srp, ci[pos], csr.shape)
            if vmap is None:
                raise ValueError("refactor: a (row, column) of the pattern repeats")
            into_lu = t(np.concatenate([[0], pos + 1]))
            return tuple(into_lu[v.long()] for v in vmap)

        lower, upper, on_diag = ci < rows_of, ci > rows_of, ci == rows_of
        diag = np.zeros(m, dtype=np.int64)
        diag[rows_of[on_diag]] = np.flatnonzero(on_diag)
        maps = None
        if ilu.swell is not None:
            maps = (layout_map(ilu.swell.layout_l, lower), layout_map(ilu.swell.layout_u, upper))
        kernel = host = None
        if dev.type == "cuda":
            from ._build import TRISOLVE_SRC, load_lib

            load_lib(TRISOLVE_SRC)  # F-4's library: built here, at the first call
            plan = ilu.l_plan
            rows = plan.rows_sorted if plan.rows_sorted is not None else torch.arange(
                m, device=dev)  # past the level cap: natural order, also a dependency order
            rp32 = ilu.pattern[0].to(torch.int32).contiguous()
            ci32 = ilu.pattern[1].to(torch.int32).contiguous()
            dpos = t(diag)
            kernel = (rows, rp32, ci32, dpos, *_ikj_updates(rp32, ci32, dpos, csr.cols),
                      torch.zeros(m, dtype=torch.int32, device=dev),
                      torch.zeros(1, dtype=torch.int32, device=dev),
                      _AHEAD * max(plan.widest_level, 1))
        else:
            host = (rp, ci)
        st = ilu._numeric["state"] = _Numeric(
            lu=torch.zeros(csr.nnz + 1, dtype=torch.float64, device=dev),
            l_pos=t(dep_pos(ilu.l_plan, lower) + 1), u_pos=t(dep_pos(ilu.u_plan, upper) + 1),
            diag_pos=t(diag + 1), maps=maps, kernel=kernel, host=host)
    return st


def _factor_kernel(st: _Numeric, values: torch.Tensor) -> None:
    """F-4 on ``values`` (the CSR's, on the card) into ``st.lu``: one launch
    on the current stream, after the state's last launch (:func:`_order`)."""
    from ._build import TRISOLVE_SRC, load_lib

    rows, rp, ci, diag, up, ut, us, flags, epoch, in_flight = st.kernel
    a = values.to(torch.float64).contiguous()
    lib = load_lib(TRISOLVE_SRC)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device)
        _order(st, stream)
        rc = lib.ilu0_refactor(in_flight, int(rows.shape[0]), _ptr(rows), _ptr(rp), _ptr(ci),
                               _ptr(diag), _ptr(up), _ptr(ut), _ptr(us), _ptr(a),
                               _ptr(st.lu[1:]), _ptr(flags), _ptr(epoch),
                               ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"ilu0_refactor kernel launch failed: CUDA error {rc}")
    LAUNCHES[("f64", "factor")] += 1


def _refactor(ilu: ILU0, csr: CSR) -> None:
    from .swell import revalue

    _same_pattern(ilu, csr)
    st = _numeric(ilu, csr)
    profiling.count("ilu.refactors")
    profiling.count("ilu.refactor.rows", csr.rows)
    profiling.count("ilu.refactor.nnz", csr.nnz)
    if csr.rows == 0:
        return
    if st.kernel is not None:
        _factor_kernel(st, csr.values)
    else:
        profiling.count("ilu.refactor.host")
        rp, ci = st.host
        st.lu[1:].copy_(torch.from_numpy(ilu0_host(rp, ci, csr.values.cpu().numpy(), csr.shape)))
    lu = st.lu
    torch.index_select(lu, 0, st.l_pos, out=ilu.l_plan.dep_vals)
    torch.index_select(lu, 0, st.u_pos, out=ilu.u_plan.dep_vals)
    torch.index_select(lu, 0, st.diag_pos, out=ilu.u_plan.diag)
    for plan in (ilu.l_plan, ilu.u_plan):
        for dep_vals, diag in plan._cast.values():
            dep_vals.copy_(plan.dep_vals)
            diag.copy_(plan.diag)
    if ilu.swell is not None:
        revalue(ilu.swell.layout_l, lu, st.maps[0])
        revalue(ilu.swell.layout_u, lu, st.maps[1])
        ilu.swell.inv_diag.copy_(1.0 / ilu.u_plan.diag)


def _strict_part_csr(rp, ci, lu, shape, lower: bool, device) -> CSR:
    """CSR container of the strict triangular part of the combined LU values."""
    m = shape[0]
    rows_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    mask = (ci < rows_of) if lower else (ci > rows_of)
    counts = np.bincount(rows_of[mask], minlength=m)
    nrp = np.concatenate([[0], np.cumsum(counts)])
    return CSR.from_numpy(nrp, ci[mask], lu[mask], (m, shape[1]), device=device)


def gauss_seidel_split(csr: CSR):
    """Gauss-Seidel's parts of ``csr`` itself, on its device: ``(plan_dl,
    plan_du, lower, upper)``, the F-3 plans of D + L and D + U (D the
    diagonal, L and U the strict lower and upper parts) and L and U as CSRs.
    A forward sweep in natural row order solves (D + L) x = r - U x, a
    backward one (D + U) x = r - L x.  Rows must hold sorted columns and a
    nonzero diagonal entry."""
    rp, ci, v, shape = csr.to_numpy()
    rp = np.asarray(rp).astype(np.int64)
    ci = np.asarray(ci).astype(np.int64)
    m = shape[0]
    if shape[0] != shape[1]:
        raise ValueError(f"Gauss-Seidel needs a square matrix, got {shape[0]}x{shape[1]}")
    rows_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    on_diag = ci == rows_of
    has = np.zeros(m, dtype=bool)
    has[rows_of[on_diag & (v != 0)]] = True
    if not has.all():
        raise ValueError(f"Gauss-Seidel needs a nonzero diagonal; row "
                         f"{int(np.flatnonzero(~has)[0])} has none")
    dev = csr.device
    return (analyze_trisolve(rp, ci, v, shape, lower=True, unit_diag=False, device=dev),
            analyze_trisolve(rp, ci, v, shape, lower=False, unit_diag=False, device=dev),
            _strict_part_csr(rp, ci, v, shape, True, dev),
            _strict_part_csr(rp, ci, v, shape, False, dev))


def ilu0(csr: CSR, sweeps: Optional[int] = None) -> ILU0:
    """Factor A ≈ L U in-pattern and return the preconditioner handle, its
    tensors on ``csr``'s device.

    ``sweeps=None`` picks exact solves when both factors have an exact schedule
    of at most 512 iterations, else ``ILU_AUTO_SWEEPS`` (6) Jacobi sweeps per
    solve.  Sweep solves on factors with at least ``ILU_SWELL_MIN``
    off-diagonal nnz run on the swell kernel (:class:`SweepSwell`).

    The span ``ilu0``: its self time is the host factor, the two level
    analyses and the handle; the factors' swell plans are ``swell.plan``
    spans inside it."""
    with profiling.span("ilu0"):
        return _ilu0(csr, sweeps)


def _ilu0(csr: CSR, sweeps: Optional[int]) -> ILU0:
    from .swell import get_swell_plan

    rp, ci, v, shape = csr.to_numpy()
    rp = np.asarray(rp).astype(np.int64)
    ci = np.asarray(ci).astype(np.int64)
    dev = csr.device
    lu = ilu0_host(rp, ci, v, shape)
    l_plan = analyze_trisolve(rp, ci, lu, shape, lower=True, unit_diag=True, device=dev)
    u_plan = analyze_trisolve(rp, ci, lu, shape, lower=False, unit_diag=False, device=dev)
    if sweeps is None:
        exact_ok = (l_plan.rows_sorted is not None and u_plan.rows_sorted is not None
                    and max(l_plan.num_iters, u_plan.num_iters) <= 512)
        sweeps = 0 if exact_ok else ILU_AUTO_SWEEPS
    swell = None
    if sweeps > 0 and l_plan.num_deps + u_plan.num_deps >= ILU_SWELL_MIN:
        # one after the other: the port's plan cache is not shared across threads
        layout_l = get_swell_plan(_strict_part_csr(rp, ci, lu, shape, True, dev))
        layout_u = get_swell_plan(_strict_part_csr(rp, ci, lu, shape, False, dev))
        swell = SweepSwell(layout_l, layout_u, 1.0 / u_plan.diag)
    return ILU0(l_plan, u_plan, sweeps=sweeps, swell=swell,
                pattern=(csr.row_ptr, csr.col_idx, csr.shape))
