"""Repeated conjugate-gradient solves against one matrix, as a caller makes them.

A request is one ``models.cg.cg_solve(csr, b, tol, max_iters, strategy,
precond)`` with a right-hand side b drawn from (seed, request), x0 = 0; the
call returns when the solve has, its iteration count read on the host.  The
preconditioner is made once in set-up: ``jacobi`` (``jacobi_preconditioner``)
or ``ilu0`` (``ops.trisolve.ilu0(csr, sweeps)``).

Traffic keys: ``precond``, ``sweeps`` (ilu0), ``tol``, ``max_iters``,
``strategy``, ``check_every`` (one solution in that many is kept for the
check), ``x_checked`` (how many of the kept solves, drawn from the seed
across the whole window and always the last, the reference solves again),
``trace_requests``, ``limits`` (``residual_over_tol``, ``x_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs, peaks, reference

UNIT = "cg_iter"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's ``cg_solve`` on the cell's matrix."""

    def __init__(self, cell):
        from spmv_acc_tpu_torch import CSR
        from spmv_acc_tpu_torch.models.cg import cg_solve, jacobi_preconditioner
        from spmv_acc_tpu_torch.ops.trisolve import ilu0

        rp, ci, v, shape = cell.arrays
        t = cell.traffic
        self.cell = cell
        self.solve = cg_solve
        self.csr = CSR.from_numpy(rp, ci, v, shape, device=cell.device)
        self.precond = {"jacobi": lambda: jacobi_preconditioner(self.csr),
                        "ilu0": lambda: ilu0(self.csr, sweeps=t["sweeps"])}[t["precond"]]()

    def request(self, seed: int, i: int):
        t = self.cell.traffic
        b = self.cell.draw.vector(seed, i, self.csr.rows)
        res = self.solve(self.csr, b, tol=t["tol"], max_iters=t["max_iters"],
                         strategy=t["strategy"], precond=self.precond)
        return res.iters, {"x": res.x, "iters": res.iters}

    def sync(self):
        _sync(self.cell.device)

    def close(self):
        self.csr = self.precond = None


def reference_precond(cell, op, dtype):
    """The traffic's preconditioner, worked out by the reference from the
    configuration: Jacobi from the operator's diagonal, ILU(0) from the
    matrix module's own factor (``ilu0_coeffs``)."""
    t = cell.traffic
    if t["precond"] == "jacobi":
        inv = (1.0 / op.diagonal()).to(device=cell.device, dtype=dtype)
        return lambda r: r * inv
    return cell.matrix.ILU0Sweeps(cell.cfg, cell.matrix.ilu0_coeffs(cell.cfg), t["sweeps"],
                                  cell.device, dtype)


class Control:
    """The reference's PCG put in the program's place, in float32."""

    def __init__(self, cell):
        self.cell = cell
        self.op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float32)
        self.precond = reference_precond(cell, self.op, torch.float32)

    def request(self, seed: int, i: int):
        t = self.cell.traffic
        b = self.cell.draw.vector(seed, i, self.op.shape[0])
        x, it = reference.pcg(self.op, self.precond, b, t["tol"], t["max_iters"])
        return it, {"x": x.double(), "iters": it}

    def sync(self):
        _sync(self.cell.device)

    def close(self):
        self.op = self.precond = None


def unit_bytes(cell) -> int:
    """One iteration's bytes, from m and the nnz of A and of its factors:
    A's SpMV by the reference's model, the eight vector passes of CG's update
    (x, r, p read and written, Ap and the Jacobi scale read), and under ILU(0)
    each factor's CSR read once (strict L; U with the diagonal) and the
    apply's r read and z written."""
    rp, ci, _, (m, _) = cell.arrays
    nnz = int(rp[-1])
    total = peaks.spmv_bytes(m, nnz) + 8 * 8 * m
    if cell.traffic["precond"] == "ilu0":
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(np.asarray(rp, dtype=np.int64)))
        nnz_l = int(np.count_nonzero(np.asarray(ci) < rows))
        total += peaks.csr_bytes(m, nnz_l) + peaks.csr_bytes(m, nnz - nnz_l) + 2 * 8 * m
    return total


def end_to_end(win) -> dict:
    return {"solve_ms": win.wall * 1e3 / len(win.latencies)}


def resolved(seed: int, indices: list, n: int) -> list:
    """Which of the kept requests ``indices`` (in order) the reference solves
    again: the last, and one drawn from the seed in each of ``n - 1`` equal
    stretches of the rest, so that the whole window is covered."""
    if len(indices) <= n:
        return list(indices)
    rest = indices[:-1]
    rng = np.random.default_rng(inputs.mix(seed, len(indices), salt=0x51CE))
    bounds = np.linspace(0, len(rest), n, dtype=np.int64)
    return [rest[int(rng.integers(lo, hi))] for lo, hi in zip(bounds[:-1], bounds[1:])] + [
        indices[-1]]


def check(cell, seed: int, win):
    """Each kept solution's relative residual ||b - A x|| / ||b|| by the
    reference's operator, over the tolerance; and for ``x_checked`` kept
    solves (``resolved``), the gap max|x - x_ref| / max|x_ref| to the
    reference PCG's solution of the same b (the same algorithm and stop rule,
    so a different preconditioner or iteration shows, wherever in the window
    it starts).  The iteration counts' largest gap is printed beside them,
    not compared: the float32 control takes the same counts.  Returns
    (numbers with limits, answers failed, answers checked)."""
    import sys

    t, lim = cell.traffic, cell.traffic["limits"]
    op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float64)
    kept = sorted(win.kept.items())
    worst_res = worst_gap = 0.0
    iters_gap = 0
    bad = set()
    for i, ans in kept:
        b = cell.draw.vector(seed, i, op.shape[0])
        res = reference.relative_residual(op, ans["x"].to(b.device), b) / t["tol"]
        res = res if res == res else float("inf")  # NaN fails
        if res > lim["residual_over_tol"]:
            bad.add(i)
        worst_res = max(worst_res, res)
    if kept:
        precond = reference_precond(cell, op, torch.float64)
        again = set(resolved(seed, [i for i, _ in kept], t["x_checked"]))
        for i, ans in kept:
            if i not in again:
                continue
            b = cell.draw.vector(seed, i, op.shape[0])
            xr, it = reference.pcg(op, precond, b, t["tol"], t["max_iters"])
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
