"""Successive linear systems on one pattern, as implicit time steps and
Newton iterations make them: each request new matrix values, the ILU(0)
factor redone on the card, then a conjugate-gradient solve.

A request i draws a coefficient field c (one value a grid point, c = 1 +
0.5 u with u uniform on [-1, 1), from its own stream: ``inputs.mix(seed, i,
COEFF_SALT)``, never b's), assembles the operator's values in CSR order on
the device with torch ops from index arrays made in set-up (``Assembly``:
the generator module's ``build`` of that field, bit for bit), hands them to
the program with ``replace_values(csr, values)``, refactors the kept handle
with ``ilu.refactor(csr)``, and calls ``models.cg.cg_solve(csr, b, tol,
max_iters, strategy, ilu)`` for a b drawn from (seed, request), x0 = 0; the
call returns when the solve has, its iteration count read on the host.
Set-up makes the c = 1 matrix (HPCG's) and ``ilu0(csr, sweeps)``; of the
mix's two warm-up requests the first makes the refactor's state and the
kept solver (A's swell layout, the captured blocks), the second the value
map through which ``replace_values`` refreshes that layout (made at its
first refresh), so nothing is built inside the window.

The kind refuses, when it is loaded, a program without
``spmv_acc_tpu_torch.replace_values`` or ``ILU0.refactor``: such a checkout
cannot run this mix, and says so before the matrix is made.

Traffic keys: ``precond`` (``ilu0``: the byte model's), ``sweeps``, ``tol``,
``max_iters``, ``strategy``, ``check_every`` (one solution in that many is
kept for the check), ``x_checked`` (how many of the kept solves, drawn from
the seed across the whole window and always the last, the reference solves
again), ``trace_requests``, ``limits`` (``residual_over_tol``, ``x_gap``).
``end_to_end``, ``resolved`` and ``unit_bytes`` are ``kinds/cg.py``'s.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from perfbench import inputs, reference, run

try:
    from spmv_acc_tpu_torch import replace_values  # noqa: F401
    from spmv_acc_tpu_torch.ops.trisolve import ILU0

    ILU0.refactor
except (ImportError, AttributeError) as e:
    raise ImportError("cg_refactor needs the program's replace_values and ILU0.refactor, "
                      "which this checkout lacks") from e

UNIT = "cg_iter"
COEFF_SALT = 0xC0EFF  # the coefficient field's stream; b's is salt 0

_cg = run.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cg.py"),
               "perfbench_kind_cg_refactor_base")
end_to_end = _cg.end_to_end
resolved = _cg.resolved
unit_bytes = _cg.unit_bytes


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def field(cell, seed: int, i: int) -> torch.Tensor:
    """Request i's coefficient field: c = 1 + 0.5 u, u uniform on [-1, 1),
    float64 on the cell's device."""
    nx, ny, nz = cell.cfg["nx"], cell.cfg["ny"], cell.cfg["nz"]
    gen = torch.Generator(device=cell.device)
    gen.manual_seed(inputs.mix(seed, i, salt=COEFF_SALT))
    u = torch.rand(nx * ny * nz, generator=gen, dtype=torch.float64, device=cell.device) * 2 - 1
    return 1.0 + 0.5 * u


class Assembly:
    """The operator's values in CSR order for a field c, on the device, from
    index arrays made once from the cell's pattern: a_pq = -(c_p + c_q) / 2
    off the diagonal; a_pp the sum of its row's (c_p + c_q) / 2 in column
    order, plus (26 - n_p) c_p, n_p the row's off-diagonal count (the
    generator's formula and order, so its ``build`` of c bit for bit)."""

    def __init__(self, arrays, device):
        rp, ci, _, (m, _) = arrays
        rp = np.asarray(rp, dtype=np.int64)
        ci = np.asarray(ci, dtype=np.int64)
        count = np.diff(rp)
        rows = np.repeat(np.arange(m, dtype=np.int64), count)
        off = ci != rows
        n = np.bincount(rows[off], minlength=m)
        before = np.concatenate([[0], np.cumsum(off)])[rp[:-1]]
        rank = np.cumsum(off) - 1 - np.repeat(before, count)  # among the row's off-diagonals
        width = int(n.max()) if m else 0
        # each entry's slot in a (width + 1, m) table; the diagonal's in the last row
        slot = np.where(off, rank, width) * m + rows

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.rows, self.cols = t(rows.astype(np.int32)), t(ci.astype(np.int32))
        self.slot = t(slot)
        self.diag = t(np.flatnonzero(~off))
        self.rest = t((26.0 - n).astype(np.float64))
        self.table = torch.zeros(width + 1, m, dtype=torch.float64, device=device)

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        half = (c.index_select(0, self.rows) + c.index_select(0, self.cols)) * 0.5
        self.table.view(-1).index_copy_(0, self.slot, half)
        d = self.table[0]
        for k in range(1, self.table.shape[0] - 1):
            d = d + self.table[k]
        values = -half
        values[self.diag] = d + self.rest * c
        return values


class Program:
    """The port's ``replace_values``, ``ILU0.refactor`` and ``cg_solve`` on
    the cell's pattern."""

    def __init__(self, cell):
        from spmv_acc_tpu_torch import CSR, replace_values
        from spmv_acc_tpu_torch.models.cg import cg_solve
        from spmv_acc_tpu_torch.ops.trisolve import ilu0

        rp, ci, v, shape = cell.arrays
        self.cell = cell
        self.replace = replace_values
        self.solve = cg_solve
        self.csr = CSR.from_numpy(rp, ci, v, shape, device=cell.device)
        self.precond = ilu0(self.csr, sweeps=cell.traffic["sweeps"])
        self.assemble = Assembly(cell.arrays, cell.device)

    def request(self, seed: int, i: int):
        t, cell = self.cell.traffic, self.cell
        self.replace(self.csr, self.assemble(field(cell, seed, i)))
        self.precond.refactor(self.csr)
        b = cell.draw.vector(seed, i, self.csr.rows)
        res = self.solve(self.csr, b, tol=t["tol"], max_iters=t["max_iters"],
                         strategy=t["strategy"], precond=self.precond)
        return res.iters, {"x": res.x, "iters": res.iters}

    def sync(self):
        _sync(self.cell.device)

    def close(self):
        self.csr = self.precond = self.assemble = None


def reference_system(cell, seed: int, i: int, dtype):
    """Request i's operator and its ILU(0), worked out by the reference on
    the grid from the request's own field, in ``dtype``."""
    c = field(cell, seed, i)
    op = cell.matrix.Operator(cell.cfg, None, cell.device, dtype, c=c)
    m = cell.matrix.ILU0Sweeps(cell.cfg, cell.matrix.ilu0_coeffs(cell.cfg, c.cpu()),
                               cell.traffic["sweeps"], cell.device, dtype)
    return op, m


class Control:
    """The reference's PCG on each request's own system put in the program's
    place, in float32."""

    def __init__(self, cell):
        self.cell = cell

    def request(self, seed: int, i: int):
        t = self.cell.traffic
        op, m = reference_system(self.cell, seed, i, torch.float32)
        b = self.cell.draw.vector(seed, i, op.shape[0])
        x, it = reference.pcg(op, m, b, t["tol"], t["max_iters"])
        return it, {"x": x.double(), "iters": it}

    def sync(self):
        _sync(self.cell.device)

    def close(self):
        pass


def check(cell, seed: int, win):
    """Each kept solution's relative residual ||b - A_i x|| / ||b|| by request
    i's own operator (its field drawn again), over the tolerance, so a solve
    against stale values fails it; and for ``x_checked`` kept solves
    (``resolved``), the gap max|x - x_ref| / max|x_ref| to the reference PCG
    under request i's own ILU(0) (the same algorithm and stop rule), so a
    stale factor (the set-up's or an earlier request's) fails it, wherever in
    the window it starts.  The iteration counts' largest gap is printed
    beside them, not compared.  Returns (numbers with limits, answers failed,
    answers checked)."""
    t, lim = cell.traffic, cell.traffic["limits"]
    kept = sorted(win.kept.items())
    again = set(resolved(seed, [i for i, _ in kept], t["x_checked"])) if kept else set()
    worst_res = worst_gap = 0.0
    iters_gap = 0
    bad = set()
    for i, ans in kept:
        c = field(cell, seed, i)
        op = cell.matrix.Operator(cell.cfg, None, cell.device, torch.float64, c=c)
        b = cell.draw.vector(seed, i, op.shape[0])
        res = reference.relative_residual(op, ans["x"].to(b.device), b) / t["tol"]
        res = res if res == res else float("inf")  # NaN fails
        if res > lim["residual_over_tol"]:
            bad.add(i)
        worst_res = max(worst_res, res)
        if i not in again:
            continue
        op, m = reference_system(cell, seed, i, torch.float64)
        xr, it = reference.pcg(op, m, b, t["tol"], t["max_iters"])
        gap = float((ans["x"].to(xr.device) - xr).abs().max() / xr.abs().max())
        gap = gap if gap == gap else float("inf")
        if gap > lim["x_gap"]:
            bad.add(i)
        worst_gap = max(worst_gap, gap)
        iters_gap = max(iters_gap, abs(ans["iters"] - it))
    print(f"iterations: largest gap to the reference's {iters_gap} (not compared)",
          file=sys.stderr)
    return ([("residual_over_tol", worst_res, lim["residual_over_tol"]),
             ("x_gap", worst_gap, lim["x_gap"])], len(bad), len(kept))
