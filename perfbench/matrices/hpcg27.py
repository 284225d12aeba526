"""HPCG's operator: the 27-point stencil of ``GenerateProblem`` (HPCG 3.1),
26 on the diagonal and -1 towards each neighbour inside the grid, rows in
natural order (x fastest, then y, then z).

``build`` makes the CSR arrays the program is given, vectorised over the
grid.  The reference works on the grid itself and not on those arrays:
``Operator`` applies the stencil as 27 x - (the 3 x 3 x 3 box sum of x) on a
zero-padded grid, and ``ilu0_coeffs`` factors the stencil in pattern,
hyperplane by hyperplane, so a fault in the CSR generator shows against it.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

# the 27 offsets (dz, dy, dx) in ascending column order; 13 is the centre
OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))
CENTRE = OFFSETS.index((0, 0, 0))


def grid(cfg: dict):
    return cfg["nx"], cfg["ny"], cfg["nz"]


def build(cfg: dict):
    """(row_ptr, col_idx, values, shape) of the operator on the configuration's grid."""
    nx, ny, nz = grid(cfg)
    m = nx * ny * nz
    z, y, x = (a.reshape(-1) for a in np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                                   indexing="ij"))
    row = np.arange(m, dtype=np.int64)
    cols = np.empty((m, 27), dtype=np.int64)
    valid = np.empty((m, 27), dtype=bool)
    for k, (dz, dy, dx) in enumerate(OFFSETS):
        valid[:, k] = ((0 <= x + dx) & (x + dx < nx) & (0 <= y + dy) & (y + dy < ny)
                       & (0 <= z + dz) & (z + dz < nz))
        cols[:, k] = row + dx + nx * (dy + ny * dz)
    ci = cols[valid]
    rp = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=rp[1:])
    vals = np.where(ci == np.repeat(row, valid.sum(axis=1)), 26.0, -1.0)
    return rp.astype(np.int32), ci.astype(np.int32), vals, (m, m)


def _shifted(vp: torch.Tensor, o, shape):
    nz, ny, nx = shape
    dz, dy, dx = o
    return vp[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]


def _pad(v: torch.Tensor, shape) -> torch.Tensor:
    return torch.nn.functional.pad(v.view(shape), (1, 1, 1, 1, 1, 1))


class Operator:
    """y = A x on the grid, in ``dtype`` on ``device``."""

    def __init__(self, cfg: dict, arrays, device, dtype=torch.float64):
        nx, ny, nz = grid(cfg)
        self.grid = (nz, ny, nx)
        self.shape = (nx * ny * nz, nx * ny * nz)
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        g = x.to(self.dtype).view(self.grid)
        p = _pad(g, self.grid)
        s = p[:, :, :-2] + p[:, :, 1:-1] + p[:, :, 2:]
        s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
        s = s[:-2] + s[1:-1] + s[2:]
        return (27.0 * g - s).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        return torch.full((self.shape[0],), 26.0, dtype=self.dtype)


def ilu0_coeffs(cfg: dict) -> np.ndarray:
    """ILU(0) of the operator as 27 coefficient grids (float64, shape
    (27, nz, ny, nx)): offsets before ``CENTRE`` hold L (unit diagonal
    implied), the centre and after it U.  Row i's update for its k-th lower
    neighbour, in ascending column order: l_ik = a_ik / u_kk, then
    a_ij -= l_ik u_kj for every later j of row i that row k reaches.  A row
    depends only on rows of a lower x + 2 y + 4 z, so each such hyperplane is
    one vector step."""
    nx, ny, nz = grid(cfg)
    px, py = nx + 2, ny + 2
    npad = px * py * (nz + 2)
    flat = [dx + px * (dy + py * dz) for dz, dy, dx in OFFSETS]
    c = np.zeros((27, npad))
    interior = np.zeros((nz + 2, py, px), dtype=bool)
    interior[1:-1, 1:-1, 1:-1] = True
    inner = interior.reshape(-1)
    c[CENTRE] = np.where(inner, 26.0, 1.0)  # padding rows: 1, so a division there is safe
    idx = np.flatnonzero(inner)
    for k, f in enumerate(flat):
        if k != CENTRE:
            c[k, idx] = np.where(inner[idx + f], -1.0, 0.0)
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
            lik = c[k, p] / c[CENTRE, kk]
            c[k, p] = lik
            for j, d in reach[k]:
                c[j, p] -= lik * c[d, kk]
    return c.reshape(27, nz + 2, py, px)[:, 1:-1, 1:-1, 1:-1].copy()


class ILU0Sweeps:
    """M^{-1} r of ILU(0) by ``sweeps`` Jacobi sweeps on each factor:
    z = r, z <- r - L z; u = z / D, u <- (z - U u) / D (L and U strict)."""

    def __init__(self, cfg: dict, coeffs: np.ndarray, sweeps: int, device,
                 dtype=torch.float64):
        nx, ny, nz = grid(cfg)
        self.grid = (nz, ny, nx)
        self.sweeps = sweeps
        self.dtype = dtype
        c = torch.from_numpy(coeffs).to(device=device, dtype=dtype)
        self.lower = [(OFFSETS[k], c[k]) for k in range(CENTRE)]
        self.upper = [(OFFSETS[k], c[k]) for k in range(CENTRE + 1, 27)]
        self.inv_diag = 1.0 / c[CENTRE]

    def _apply(self, part, v):
        vp = _pad(v, self.grid)
        out = torch.zeros_like(v)
        for o, coef in part:
            out += coef * _shifted(vp, o, self.grid)
        return out

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        r = r.to(self.dtype).view(self.grid)
        z = r
        for _ in range(self.sweeps):
            z = r - self._apply(self.lower, z)
        u = z * self.inv_diag
        for _ in range(self.sweeps):
            u = (z - self._apply(self.upper, u)) * self.inv_diag
        return u.reshape(-1)
