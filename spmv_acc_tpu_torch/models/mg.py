"""HPCG's preconditioner: the geometric multigrid V-cycle with symmetric
Gauss-Seidel smoothing (HPCG 3.1's ``ComputeMG_ref``, ``ComputeSYMGS_ref``,
``ComputeRestriction_ref`` and ``ComputeProlongation_ref``), as a callable
that ``models.cg.cg_solve`` takes for ``precond``.

MG(A, r) -> x, from x = 0 on every level:

* on a level with a coarser one: one SymGS step, r_c = (r - A x)[f2c],
  x_c = MG(A_c, r_c), x[f2c] += x_c, then one SymGS step (HPCG's
  ``InitializeMGData`` fixes one pre- and one post-smoothing step);
* on the coarsest level: one SymGS step.

SymGS is Gauss-Seidel in natural row order, a forward then a backward
sweep, each x_i = (r_i - sum_{j != i} a_ij x_j) / a_ii with the newest x.
As solves: (D + L) x = r - U x, then (D + U) x = r - L x (D the diagonal,
L and U the strict lower and upper parts).  Each solve is exact and level
scheduled: F-3 (``ops.trisolve.trisolve``; on the card ``tri_levels``, in
which each row waits only on its own dependencies' ready flags, with no
barrier between levels) on plans of D + L and D + U of the level's own
operator (``ops.trisolve.gauss_seidel_split``), so the order is the natural
order's, with no colouring.  Each ``r - N x`` is one launch of the swell
kernel's sweep store (``ops.swell.swell_sweep`` without d) on N's swell
layout, as is the restriction's residual on A's; a layout with a COO tail,
or another dtype than r's, takes ``swell_ax`` and a separate subtract
(``ops.trisolve._sweep``), and CPU tensors run the plain versions.  The
first forward sweep of a level starts from x = 0 and skips U x: r - U 0 is
r, bit for bit.  Restriction is an ``index_select`` of the residual at f2c,
prolongation an ``index_add_`` at f2c; f2c is injective, so each row takes
one add and the card's atomics give the same bits every time.

Nothing in M(r) reads the host, so a captured CUDA graph can hold it.

Spans and counters (``utils.profiling``): ``mg.setup`` around
:func:`mg_preconditioner` (every level's two F-3 plans, its strict parts and
their swell plans, the ``swell.plan`` spans inside it); ``mg.apply`` around
each M(r) called from the host; ``mg.vcycles`` (one a V-cycle) and
``mg.tri_solves`` (one a triangular solve) counted when the host runs the
code, so in a captured block once, at capture; the products count as
``ops.trisolve._sweep``'s ``ilu.sweeps.*``, which ILU(0)'s sweeps share.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..formats.containers import CSR
from ..ops.trisolve import TriSolvePlan, _sweep, gauss_seidel_split, trisolve
from ..utils import profiling

__all__ = ["MGLevel", "MGPreconditioner", "mg_preconditioner"]


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One level of the hierarchy, on its operator's device."""

    plan_dl: TriSolvePlan  # D + L, the forward sweep's solve
    plan_du: TriSolvePlan  # D + U, the backward sweep's solve
    lower: object          # ops.swell.DeviceSwellLayout of L
    upper: object          # that of U
    a: Optional[object]    # that of A, for the restriction's residual (None: coarsest)
    f2c: Optional[torch.Tensor]  # (rows of the next level,) int64: their rows here


class MGPreconditioner:
    """M(r): one V-cycle from x = 0 (module docstring) over ``levels``,
    finest first."""

    def __init__(self, levels: List[MGLevel]):
        self.levels = levels

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        with profiling.span("mg.apply"):
            profiling.count("mg.vcycles")
            return self._cycle(0, r)

    def _cycle(self, depth: int, r: torch.Tensor) -> torch.Tensor:
        lv = self.levels[depth]
        x = self._symgs(lv, r, None)
        if lv.f2c is None:
            return x
        xc = self._cycle(depth + 1, _sweep(lv.a, x, r, None).index_select(0, lv.f2c))
        x.index_add_(0, lv.f2c, xc)
        return self._symgs(lv, r, x)

    @staticmethod
    def _symgs(lv: MGLevel, r: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        """One SymGS step on x (None: x = 0): a new x."""
        c = r if x is None else _sweep(lv.upper, x, r, None)
        profiling.count("mg.tri_solves")
        x = trisolve(lv.plan_dl, c)
        c = _sweep(lv.lower, x, r, None)
        profiling.count("mg.tri_solves")
        return trisolve(lv.plan_du, c)


def _injection(f2c, fine: CSR, coarse: CSR, level: int) -> torch.Tensor:
    """``f2c`` as an int64 tensor on the fine operator's device, checked:
    one row of the fine level for each coarse row, each within it, no two
    the same."""
    idx = torch.as_tensor(f2c).cpu()
    if idx.dtype.is_floating_point or idx.dim() != 1 or idx.shape[0] != coarse.rows:
        raise ValueError(f"f2c[{level}] must be ({coarse.rows},) integers, one fine row a "
                         f"row of level {level + 1}; got {tuple(idx.shape)} {idx.dtype}")
    host = idx.numpy().astype(np.int64)
    if host.size and (host.min() < 0 or host.max() >= fine.rows):
        raise ValueError(f"f2c[{level}] holds rows outside level {level}'s {fine.rows}")
    if np.unique(host).size != host.size:
        raise ValueError(f"f2c[{level}] is not injective: a fine row takes two coarse rows")
    return torch.from_numpy(host).to(fine.device)


def mg_preconditioner(levels: Sequence[CSR], f2c: Sequence) -> MGPreconditioner:
    """HPCG's multigrid preconditioner over ``levels`` (square CSRs, finest
    first, on one device), ``f2c[l]`` mapping each row of level l + 1 to its
    row on level l (HPCG's injection: coarse point (i, j, k) to fine point
    (2i, 2j, 2k)).  One SymGS step before and one after each coarse
    correction, one on the coarsest level.  Returns M, called as ``M(r)``:
    one V-cycle from x = 0 (module docstring); ``cg_solve(csr, b,
    precond=M)`` takes it as it is.

    Builds, under the span ``mg.setup``, every level's F-3 plans of D + L
    and D + U, its strict parts and their swell layouts, and the swell
    layout of every operator but the coarsest (shared with a ``cg_solve``
    on the same CSR object)."""
    with profiling.span("mg.setup"):
        return _build(list(levels), list(f2c))


def _build(levels: List[CSR], f2c: list) -> MGPreconditioner:
    from ..ops.swell import get_swell_plan

    if not levels:
        raise ValueError("mg_preconditioner needs at least one level")
    if len(f2c) != len(levels) - 1:
        raise ValueError(f"{len(levels)} levels take {len(levels) - 1} maps f2c, got {len(f2c)}")
    device = levels[0].device
    for i, a in enumerate(levels):
        if a.rows != a.cols:
            raise ValueError(f"level {i} is {a.rows}x{a.cols}, not square")
        if a.device != device:
            raise ValueError(f"level {i} is on {a.device}, level 0 on {device}")
    built = []
    for i, a in enumerate(levels):
        plan_dl, plan_du, lower, upper = gauss_seidel_split(a)
        coarser = i + 1 < len(levels)
        built.append(MGLevel(
            plan_dl=plan_dl, plan_du=plan_du, lower=get_swell_plan(lower),
            upper=get_swell_plan(upper), a=get_swell_plan(a) if coarser else None,
            f2c=_injection(f2c[i], a, levels[i + 1], i) if coarser else None))
    return MGPreconditioner(built)
