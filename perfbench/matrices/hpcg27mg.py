"""HPCG's multigrid preconditioner on HPCG's operator, worked out on the grid.

HPCG 3.1 preconditions its CG by ``ComputeMG_ref``: a V-cycle over
``numberOfMgLevels`` grids, each coarse grid half the previous one in every
dimension (``GenerateCoarseProblem``), its operator HPCG's own 27-point
stencil at that size (not a Galerkin product).  MG(A, r) -> x from x = 0:
on a level with a coarser one, SymGS, r_c[i] = (r - A x)[f2c[i]],
x_c = MG(A_c, r_c), x[f2c[i]] += x_c[i], SymGS; on the coarsest level,
SymGS alone.  ``f2c[i]`` is the fine row of coarse point (2 ix, 2 iy, 2 iz).
SymGS (``ComputeSYMGS_ref``) is Gauss-Seidel in natural row order, forward
then backward, each x_i = (r_i - sum_{j != i} a_ij x_j) / a_ii with the
newest x: with a_ii = 26 and a_ij = -1, x_i = (r_i + the sum of its
neighbours' x) / 26.

This module is the plain reference, in plain ``torch``: it works on the
grids and not on the CSR arrays the program is given, as ``hpcg27.Operator``
and ``hpcg27.ilu0_coeffs`` do.  Each level's x lives on a zero-padded grid;
a sweep visits the hyperplanes ix + 2 iy + 4 iz = const in ascending order
(descending for the backward sweep), and updates each plane's points at
once from their 26 neighbours.  No two points of a plane are neighbours,
and a neighbour of a lower plane comes before a point in natural order, so
this is the natural order's Gauss-Seidel.  So a fault in the program's
CSR, plans or level analysis shows against it.  Its float32 form is the
cell's control.  TF32 is off for every product here.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.matrices.hpcg27 import CENTRE, OFFSETS, Operator, build, grid  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEIGHBOURS = [o for k, o in enumerate(OFFSETS) if k != CENTRE]  # the 26, in column order


def coarse_cfgs(cfg: dict) -> list:
    """Each level's grid, finest first: ``cfg["mg_levels"]`` of them (HPCG's
    ``numberOfMgLevels``), each half the last in every dimension."""
    nx, ny, nz = grid(cfg)
    levels = cfg["mg_levels"]
    if min(nx, ny, nz) % (1 << (levels - 1)):
        raise ValueError(f"{nx}x{ny}x{nz} does not halve {levels - 1} times")
    return [{"nx": nx >> k, "ny": ny >> k, "nz": nz >> k} for k in range(levels)]


def nnz(cfg: dict) -> int:
    """Nonzeros of the operator on the configuration's grid."""
    nx, ny, nz = grid(cfg)
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def f2c(cfg_fine: dict) -> np.ndarray:
    """HPCG's ``f2cOperator`` from the fine grid to the next coarser one:
    coarse row izc nxc nyc + iyc nxc + ixc takes fine row
    2 izc nxf nyf + 2 iyc nxf + 2 ixc (int64)."""
    nxf, nyf, nzf = grid(cfg_fine)
    izc, iyc, ixc = np.meshgrid(np.arange(nzf // 2), np.arange(nyf // 2), np.arange(nxf // 2),
                                indexing="ij")
    return (2 * izc * nxf * nyf + 2 * iyc * nxf + 2 * ixc).reshape(-1).astype(np.int64)


class _Grid:
    """One level: its points in hyperplane order, as flat indices into the
    padded grid and into the level's vectors, their 26 neighbours' padded
    indices (26 a point, flat), and where each hyperplane starts."""

    def __init__(self, cfg: dict, device):
        nx, ny, nz = grid(cfg)
        self.padded = (nz + 2) * (ny + 2) * (nx + 2)
        z, y, x = (a.reshape(-1) for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                                       indexing="ij"))
        level = x + 2 * y + 4 * z
        order = np.argsort(level, kind="stable")
        pad = (x + 1) + (nx + 2) * ((y + 1) + (ny + 2) * (z + 1))
        step = [dx + (nx + 2) * (dy + (ny + 2) * dz) for dz, dy, dx in NEIGHBOURS]
        self.bounds = np.searchsorted(level[order], np.arange(level.max() + 2)).tolist()
        self.rows = torch.from_numpy(order).to(device)
        self.pad = torch.from_numpy(pad[order]).to(device)
        self.nbrs = torch.from_numpy(
            (pad[order][:, None] + np.asarray(step)[None, :]).reshape(-1)).to(device)
        self.interior = torch.from_numpy(pad).to(device)


class MGSymGS:
    """M^{-1} r: one V-cycle of HPCG's multigrid from x = 0 over ``levels``
    grids (the first ``levels`` of ``coarse_cfgs(cfg)``), one SymGS before
    and after each coarse correction, as HPCG's ``InitializeMGData`` fixes
    them, in ``dtype`` on ``device``."""

    def __init__(self, cfg: dict, levels: int, device, dtype=torch.float64):
        cfgs = coarse_cfgs(dict(cfg, mg_levels=levels))
        self.dtype = dtype
        self.grids = [_Grid(c, device) for c in cfgs]
        self.ops = [Operator(c, None, device, dtype) for c in cfgs]
        self.f2c = [torch.from_numpy(f2c(c)).to(device) for c in cfgs[:-1]]

    def _sweep(self, g: _Grid, r_sorted: torch.Tensor, xp: torch.Tensor, planes) -> None:
        for p in planes:
            lo, hi = g.bounds[p], g.bounds[p + 1]
            s = xp.index_select(0, g.nbrs[lo * 26:hi * 26]).view(hi - lo, 26).sum(dim=1)
            xp.index_copy_(0, g.pad[lo:hi], (r_sorted[lo:hi] + s) / 26.0)

    def _symgs(self, g: _Grid, r: torch.Tensor, xp: torch.Tensor) -> None:
        r_sorted = r[g.rows]
        n = len(g.bounds) - 1
        self._sweep(g, r_sorted, xp, range(n))
        self._sweep(g, r_sorted, xp, range(n - 1, -1, -1))

    def _cycle(self, k: int, r: torch.Tensor) -> torch.Tensor:
        g = self.grids[k]
        xp = torch.zeros(g.padded, dtype=self.dtype, device=r.device)
        self._symgs(g, r, xp)
        if k + 1 < len(self.grids):
            x = xp[g.interior]
            xc = self._cycle(k + 1, (r - self.ops[k](x))[self.f2c[k]])
            xp[g.interior[self.f2c[k]]] += xc
            self._symgs(g, r, xp)
        return xp[g.interior]

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r.to(self.dtype))
