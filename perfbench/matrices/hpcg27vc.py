"""HPCG's 27-point pattern with a coefficient at every grid point: the
operator of a sequence of linear systems on one pattern (PETSc's "Solving
Successive Linear Systems": each system new values, the same nonzeros).

For a coefficient field c (one value a point, rows in natural order, x
fastest): a_pq = -(c_p + c_q) / 2 towards each neighbour q of p inside the
grid, and a_pp = sum_q (c_p + c_q) / 2 + (26 - n_p) c_p, n_p the count of
p's neighbours inside the grid.  A weighted graph Laplacian plus a
nonnegative diagonal that is positive on the boundary rows: symmetric, an
M-matrix and SPD, so ILU(0) exists with positive pivots.  With c = 1 it is
HPCG's operator (26 and -1) exactly, ``hpcg27``'s.

``coefficients`` gives the 27 coefficient grids of a field (plain torch, on
c's device); ``build`` gathers them into the CSR arrays a program is given,
on ``hpcg27.build``'s pattern; ``ilu0_coeffs`` factors them in pattern,
hyperplane by hyperplane, as ``hpcg27.ilu0_coeffs`` factors HPCG's.
``Operator`` applies the operator from its formula on the zero-padded grid
by box sums, without the coefficient grids or the CSR, so a fault in either
shows against it.  ``ILU0Sweeps`` is ``hpcg27``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.matrices import hpcg27
from perfbench.matrices.hpcg27 import CENTRE, OFFSETS, ILU0Sweeps, grid  # noqa: F401


def _field(cfg: dict, c) -> torch.Tensor:
    """c as a float64 tensor (ones for None)."""
    nx, ny, nz = grid(cfg)
    if c is None:
        return torch.ones(nx * ny * nz, dtype=torch.float64)
    return torch.as_tensor(c, dtype=torch.float64)


def _box(p: torch.Tensor) -> torch.Tensor:
    """The 3 x 3 x 3 box sums of a padded grid, on the interior."""
    s = p[:, :, :-2] + p[:, :, 1:-1] + p[:, :, 2:]
    s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
    return s[:-2] + s[1:-1] + s[2:]


def coefficients(cfg: dict, c: torch.Tensor) -> torch.Tensor:
    """The operator of the field ``c`` (m values) as 27 coefficient grids
    (27, nz, ny, nx) in c's dtype on its device: offset k's grid holds
    a_{p, p + o_k}, 0 where that neighbour lies outside the grid, the centre
    a_pp, its sum taken over the offsets in order."""
    nx, ny, nz = grid(cfg)
    shape = (nz, ny, nx)
    g = c.reshape(shape)
    cp = hpcg27._pad(g, shape)
    inside = hpcg27._pad(torch.ones_like(g), shape)
    out = torch.empty((27,) + shape, dtype=c.dtype, device=c.device)
    diag = torch.zeros_like(g)
    n = torch.zeros_like(g)
    for k, o in enumerate(OFFSETS):
        if k == CENTRE:
            continue
        ins = hpcg27._shifted(inside, o, shape)
        half = (g + hpcg27._shifted(cp, o, shape)) * 0.5
        out[k] = torch.where(ins > 0, -half, 0.0)
        diag = diag + torch.where(ins > 0, half, 0.0)
        n = n + ins
    out[CENTRE] = diag + (26.0 - n) * g
    return out


def entry_index(cfg: dict) -> np.ndarray:
    """For each entry of ``hpcg27.build``'s CSR, in CSR order, its place in
    ``coefficients(...).reshape(-1)``: k m + p for offset k of row p."""
    nx, ny, _ = grid(cfg)
    rp, ci, _, (m, _) = hpcg27.build(cfg)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp.astype(np.int64)))
    cols = ci.astype(np.int64)
    dz = cols // (nx * ny) - rows // (nx * ny)
    dy = (cols // nx) % ny - (rows // nx) % ny
    dx = cols % nx - rows % nx
    return ((dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)) * m + rows


def build(cfg: dict, c=None):
    """(row_ptr, col_idx, values, shape) of the operator of the field ``c``
    (None: c = 1, HPCG's operator) on HPCG's pattern."""
    rp, ci, _, shape = hpcg27.build(cfg)
    vals = coefficients(cfg, _field(cfg, c).cpu()).reshape(-1).numpy()[entry_index(cfg)]
    return rp, ci, vals, shape


class Operator:
    """y = A x of the field ``c`` (None: c = 1) on the grid, in ``dtype`` on
    ``device``: diag * x - (c * (box(x) - x) + box(c x) - c x) / 2, with
    diag = (n c + box(c) - c) / 2 + (26 - n) c and n = box(1) - 1 on the
    zero-padded grid."""

    def __init__(self, cfg: dict, arrays, device, dtype=torch.float64, c=None):
        nx, ny, nz = grid(cfg)
        self.grid = (nz, ny, nx)
        self.shape = (nx * ny * nz, nx * ny * nz)
        self.dtype = dtype
        g = _field(cfg, c).to(device=device, dtype=dtype).reshape(self.grid)
        n = _box(hpcg27._pad(torch.ones_like(g), self.grid)) - 1.0
        self.c = g
        self.diag = (n * g + (_box(hpcg27._pad(g, self.grid)) - g)) * 0.5 + (26.0 - n) * g

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        g = x.to(self.dtype).view(self.grid)
        cx = self.c * g
        near = self.c * (_box(hpcg27._pad(g, self.grid)) - g) + (
            _box(hpcg27._pad(cx, self.grid)) - cx)
        return (self.diag * g - near * 0.5).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        return self.diag.reshape(-1)


def ilu0_coeffs(cfg: dict, c=None) -> np.ndarray:
    """ILU(0) of the operator of the field ``c`` (None: c = 1) as 27
    coefficient grids (float64, (27, nz, ny, nx)): offsets before ``CENTRE``
    hold L (unit diagonal implied), the centre and after it U.
    ``hpcg27.ilu0_coeffs``' hyperplane factor with the grids filled from
    ``coefficients``: row i's update for its k-th lower neighbour, in
    ascending column order, l_ik = a_ik / u_kk, then a_ij -= l_ik u_kj for
    every later j of row i that row k reaches; a row depends only on rows of
    a lower x + 2 y + 4 z, so each such hyperplane is one vector step."""
    nx, ny, nz = grid(cfg)
    px, py = nx + 2, ny + 2
    npad = px * py * (nz + 2)
    flat = [dx + px * (dy + py * dz) for dz, dy, dx in OFFSETS]
    full = np.zeros((27, nz + 2, py, px))
    full[CENTRE] = 1.0  # padding rows: 1, so a division there is safe
    full[:, 1:-1, 1:-1, 1:-1] = coefficients(cfg, _field(cfg, c).cpu()).numpy()
    cc = full.reshape(27, npad)
    interior = np.zeros((nz + 2, py, px), dtype=bool)
    interior[1:-1, 1:-1, 1:-1] = True
    idx = np.flatnonzero(interior.reshape(-1))
    z, y, x = (a.reshape(-1) for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                                   indexing="ij"))
    level = x + 2 * y + 4 * z
    order = np.argsort(level, kind="stable")
    points = idx[order]
    bounds = np.searchsorted(level[order], np.arange(level.max() + 2))
    # for lower offset k: the later offsets j that row i + o_k reaches, and their offset from it
    reach = []
    for k in range(CENTRE):
        pairs = []
        for j in range(k + 1, 27):
            d = tuple(a - b for a, b in zip(OFFSETS[j], OFFSETS[k]))
            if max(abs(t) for t in d) <= 1:
                pairs.append((j, OFFSETS.index(d)))
        reach.append(pairs)
    for lv in range(len(bounds) - 1):
        p = points[bounds[lv]:bounds[lv + 1]]
        for k in range(CENTRE):
            kk = p + flat[k]
            lik = cc[k, p] / cc[CENTRE, kk]
            cc[k, p] = lik
            for j, d in reach[k]:
                cc[j, p] -= lik * cc[d, kk]
    return cc.reshape(27, nz + 2, py, px)[:, 1:-1, 1:-1, 1:-1].copy()
