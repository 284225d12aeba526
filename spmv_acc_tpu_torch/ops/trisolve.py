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
  ``tri_levels``): one launch per solve that walks the levels in order, each
  row summing its dependencies in plan order, levels separated by
  ``__syncthreads()`` in one block where the widest level fits one block
  (``_BLOCK_MAX`` rows), else by ``grid.sync()`` in a cooperative launch.
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
  kernel (``ops/swell.py``) over the strict L and U parts.

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

__all__ = ["ilu0_host", "TriSolvePlan", "analyze_trisolve", "trisolve", "trisolve_plain",
           "trisolve_sweeps", "trisolve_sweeps_plain", "SweepSwell", "sweep_apply_swell",
           "ILU0", "ilu0", "ILU_SWELL_MIN", "ILU_AUTO_SWEEPS", "LAUNCHES"]

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
# the widest level (rows) the one-block form of tri_levels takes
# (csrc/trisolve.cu kBlockMax); wider schedules take the cooperative grid
_BLOCK_MAX = 1024

# F-3 launches in this process by (dtype, entry): ("f64" | "f32", "levels_block" |
# "levels_grid" | "sweeps").  Only the launch sites add to it (and a captured
# graph's replays, utils/graphs.py); set to 0 with ``.clear()`` to count a run.
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
    past ``_EXACT_MAX_LEVELS`` levels."""

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


def _launch(entry: str, key: str, b: torch.Tensor, *args) -> None:
    from ._build import TRISOLVE_SRC, load_lib

    lib = load_lib(TRISOLVE_SRC)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = getattr(lib, entry)(int(b.dtype == torch.float64), *args, ctypes.c_void_p(stream))
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


def trisolve(plan: TriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """Solve T y = b exactly.  For a CUDA ``b``, one launch of F-3
    (``csrc/trisolve.cu``): ``tri_levels`` over the level schedule (one block
    where the widest level fits ``_BLOCK_MAX`` rows, else a cooperative
    grid), or past ``_EXACT_MAX_LEVELS`` levels ``tri_sweeps`` with
    ``num_levels`` sweeps.  For a CPU ``b``, :func:`trisolve_plain`."""
    if _check("trisolve", plan, b) == "cpu":
        return trisolve_plain(plan, b)
    if plan.m == 0:
        return torch.empty_like(b)
    if plan.rows_sorted is None:
        return _sweeps_kernel(plan, b, plan.num_levels)
    dep_vals, diag = plan.values(b.dtype)
    y = torch.empty_like(b)
    grid = plan.widest_level > _BLOCK_MAX
    _launch("tri_levels", "levels_grid" if grid else "levels_block", b, int(grid),
            plan.widest_level, plan.num_levels, _ptr(plan.level_ptr), _ptr(plan.rows_sorted),
            _ptr(plan.dep_start), _ptr(plan.dep_len), _ptr(plan.dep_cols), _ptr(dep_vals),
            _ptr(diag), _ptr(b), _ptr(y))
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
    then U from u = z / D)."""
    from .swell import swell_ax

    dtype = r.dtype
    inv = swell.inv_diag.to(dtype)

    def nl(v):
        return swell_ax(swell.layout_l, v.to(swell.layout_l.dtype)).to(dtype)

    def nu(v):
        return swell_ax(swell.layout_u, v.to(swell.layout_u.dtype)).to(dtype)

    z = r
    for _ in range(sweeps):
        z = r - nl(z)
    u = z * inv
    for _ in range(sweeps):
        u = (z - nu(u)) * inv
    return u


@dataclasses.dataclass(frozen=True)
class ILU0:
    """Factorization handle: M^{-1} r by two triangular solves.

    ``sweeps`` > 0 makes both solves Jacobi-sweep approximations; 0 means the
    exact solves.  On the card each factor solve is one F-3 launch;
    ``swell`` (set by :func:`ilu0` on large factors) runs each sweep's N @ y
    on the swell kernel instead."""

    l_plan: TriSolvePlan
    u_plan: TriSolvePlan
    sweeps: int = 0
    swell: Optional[SweepSwell] = None

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        if self.swell is not None and self.sweeps > 0:
            return sweep_apply_swell(self.swell, self.sweeps, r)
        if self.sweeps > 0:
            z = trisolve_sweeps(self.l_plan, r, self.sweeps)
            return trisolve_sweeps(self.u_plan, z, self.sweeps)
        z = trisolve(self.l_plan, r)     # L z = r (unit lower)
        return trisolve(self.u_plan, z)  # U y = z


def _strict_part_csr(rp, ci, lu, shape, lower: bool, device) -> CSR:
    """CSR container of the strict triangular part of the combined LU values."""
    m = shape[0]
    rows_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    mask = (ci < rows_of) if lower else (ci > rows_of)
    counts = np.bincount(rows_of[mask], minlength=m)
    nrp = np.concatenate([[0], np.cumsum(counts)])
    return CSR.from_numpy(nrp, ci[mask], lu[mask], (m, shape[1]), device=device)


def ilu0(csr: CSR, sweeps: Optional[int] = None) -> ILU0:
    """Factor A ≈ L U in-pattern and return the preconditioner handle, its
    tensors on ``csr``'s device.

    ``sweeps=None`` picks exact solves when both factors have an exact schedule
    of at most 512 iterations, else ``ILU_AUTO_SWEEPS`` (6) Jacobi sweeps per
    solve.  Sweep solves on factors with at least ``ILU_SWELL_MIN``
    off-diagonal nnz run on the swell kernel (:class:`SweepSwell`)."""
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
    return ILU0(l_plan, u_plan, sweeps=sweeps, swell=swell)
