"""HPCG's timed solve: sets of conjugate-gradient iterations preconditioned by
HPCG's multigrid V-cycle, as every HPCG rank runs them.

A request is one ``models.cg.cg_solve(csr, b, tol, max_iters, strategy,
precond=M)`` with a right-hand side b drawn from (seed, request), x0 = 0; at
tol 0 it runs exactly ``max_iters`` iterations (HPCG's set of 50), and the
call returns when the solve has, its iteration count read on the host.  M is
made once in set-up by ``mg_preconditioner`` from the configuration's
``mg_levels`` grids, which the generator module makes (``build`` of each of
``coarse_cfgs(cfg)``, the finest the cell's own matrix) with its ``f2c``
maps.

The kind refuses, when it is loaded, a program without
``spmv_acc_tpu_torch.models.mg``: such a checkout cannot run this mix, and
says so before the matrix is made.

Traffic keys: ``tol``, ``max_iters``, ``strategy``, ``check_every`` (one
solution in that many is kept for the check), ``x_checked`` (how many of the
kept solves, drawn from the seed across the whole window and always the
last, the reference solves again), ``trace_requests``, ``limits``
(``relative_residual``, ``x_gap``).  ``end_to_end`` and ``resolved`` are
``kinds/cg.py``'s.
"""

from __future__ import annotations

import os
import sys

import torch

from perfbench import peaks, reference, run

try:
    import spmv_acc_tpu_torch.models.mg  # noqa: F401
except ImportError as e:
    raise ImportError("cg_mg needs the program's multigrid preconditioner "
                      "(spmv_acc_tpu_torch.models.mg), which this checkout lacks") from e

UNIT = "cg_iter"

_cg = run.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cg.py"),
               "perfbench_kind_cg_mg_base")
end_to_end = _cg.end_to_end
resolved = _cg.resolved


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's ``cg_solve`` with its ``mg_preconditioner`` on the cell's grids."""

    def __init__(self, cell):
        from spmv_acc_tpu_torch import CSR, mg_preconditioner
        from spmv_acc_tpu_torch.models.cg import cg_solve

        rp, ci, v, shape = cell.arrays
        cfg, gen = cell.cfg, cell.matrix
        cfgs = gen.coarse_cfgs(cfg)
        self.cell = cell
        self.solve = cg_solve
        self.csr = CSR.from_numpy(rp, ci, v, shape, device=cell.device)
        levels = [self.csr] + [CSR.from_numpy(*gen.build(c), device=cell.device)
                               for c in cfgs[1:]]
        self.precond = mg_preconditioner(levels, [torch.from_numpy(gen.f2c(c)) for c in cfgs[:-1]])

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


def reference_precond(cell, dtype):
    """The reference's V-cycle, worked out on the grids (``MGSymGS``)."""
    return cell.matrix.MGSymGS(cell.cfg, cell.cfg["mg_levels"], cell.device, dtype)


class Control:
    """The reference's MG-preconditioned CG put in the program's place, in float32."""

    def __init__(self, cell):
        self.cell = cell
        self.op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float32)
        self.precond = reference_precond(cell, torch.float32)

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
    """One iteration's needed bytes, from the level grids (m rows and the
    27-point stencil's nnz on each, s = (nnz - m) / 2 in each strict part):
    CG's SpMV by the reference's model, the eight vector passes of its
    update and M's r read and z written, as ``kinds/cg.py`` counts them;
    then the V-cycle.  Each triangular solve reads its s dependencies in CSR,
    the diagonal and b, and writes y; each strict-part product r - N x reads
    N by the SpMV model and r; the restriction's residual r - A x reads A by
    the SpMV model and r; the restriction gathers the coarse rows (the
    residual read, f2c read, r_c written) and the prolongation adds them
    back (x_c and f2c read, x read and written).  A level with a coarser one
    takes four solves, three products (the first forward sweep skips U x)
    and the residual; the coarsest two solves and one product."""
    gen = cell.matrix
    cfgs = gen.coarse_cfgs(cell.cfg)
    rows = [c["nx"] * c["ny"] * c["nz"] for c in cfgs]
    m = rows[0]
    total = peaks.spmv_bytes(m, gen.nnz(cfgs[0])) + 8 * 8 * m + 2 * 8 * m
    for k, c in enumerate(cfgs):
        mk, nnz = rows[k], gen.nnz(c)
        s = (nnz - mk) // 2
        solve = peaks.csr_bytes(mk, s) + 3 * 8 * mk
        product = peaks.spmv_bytes(mk, s) + 8 * mk
        if k + 1 == len(cfgs):
            total += 2 * solve + product
        else:
            mc = rows[k + 1]
            total += (4 * solve + 3 * product + peaks.spmv_bytes(mk, nnz) + 8 * mk
                      + 3 * 8 * mc + 4 * 8 * mc)
    return total


def check(cell, seed: int, win):
    """Each kept solution's relative residual ||b - A x|| / ||b|| by the
    reference's operator; and for ``x_checked`` kept solves (``resolved``),
    the gap max|x - x_ref| / max|x_ref| to the reference's own
    ``max_iters`` MG-preconditioned CG iterations from the same b (the
    V-cycle worked out on the grids), so a different preconditioner,
    ordering or iteration count shows, wherever in the window it starts.
    Returns (numbers with limits, answers failed, answers checked)."""
    t, lim = cell.traffic, cell.traffic["limits"]
    op = cell.matrix.Operator(cell.cfg, cell.arrays, cell.device, torch.float64)
    kept = sorted(win.kept.items())
    worst_res = worst_gap = 0.0
    iters = set()
    bad = set()
    for i, ans in kept:
        b = cell.draw.vector(seed, i, op.shape[0])
        res = reference.relative_residual(op, ans["x"].to(b.device), b)
        res = res if res == res else float("inf")  # NaN fails
        if res > lim["relative_residual"] or ans["iters"] != t["max_iters"]:
            bad.add(i)
        worst_res = max(worst_res, res)
        iters.add(ans["iters"])
    if kept:
        precond = reference_precond(cell, torch.float64)
        again = set(resolved(seed, [i for i, _ in kept], t["x_checked"]))
        for i, ans in kept:
            if i not in again:
                continue
            b = cell.draw.vector(seed, i, op.shape[0])
            xr, _ = reference.pcg(op, precond, b, t["tol"], t["max_iters"])
            gap = float((ans["x"].to(xr.device) - xr).abs().max() / xr.abs().max())
            gap = gap if gap == gap else float("inf")
            if gap > lim["x_gap"]:
                bad.add(i)
            worst_gap = max(worst_gap, gap)
    print(f"iterations a set: {sorted(iters)} (each must be {t['max_iters']})", file=sys.stderr)
    return ([("relative_residual", worst_res, lim["relative_residual"]),
             ("x_gap", worst_gap, lim["x_gap"])], len(bad), len(kept))
