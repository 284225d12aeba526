"""The FEM/structural stand-in at a SuiteSparse matrix's published shape.

A frozen copy of the port's ``formats/generate.py`` ``fem_like_csr`` and
``coo_to_csr_arrays`` (numpy only), so the benchmark's matrix stays the same
whatever a later change does to the program's generators.  With the
configuration's ``seed`` and ``block`` it gives, bit for bit, the stand-in
that ``example_like(name, seed)`` gives (a CPU test holds the two together).

The reference operator is ``torch``'s sparse CSR product on the same arrays:
plain PyTorch, nothing of the program.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def coo_to_csr_arrays(rows, cols, values, shape):
    """Sort (row, col), sum repeats, build row_ptr by counting: int32 indices."""
    m, _ = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values)
    order = np.lexsort((cols, rows))
    rows, cols, values = rows[order], cols[order], values[order]
    if len(rows) > 1:
        dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if dup.any():
            keep = np.concatenate(([True], ~dup))
            group = np.cumsum(keep) - 1
            values = np.bincount(group, weights=values, minlength=group[-1] + 1).astype(
                values.dtype, copy=False)
            rows, cols = rows[keep], cols[keep]
    counts = np.bincount(rows, minlength=m)
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr.astype(np.int32), cols.astype(np.int32), values


def fem_like_arrays(m: int, n: int, nnz: int, block: int = 3, spread_frac: float = 0.02,
                    seed: int = 0):
    """(row_ptr, col_idx, values) of the FEM stand-in: node blocks of ``block``
    rows coupled through a 3D grid stencil in node space, each coupling a dense
    block x block sub-block, trimmed to exactly ``nnz``; values uniform in
    [-1, 1), float64."""
    rng = np.random.default_rng(seed)
    nodes_m = max(1, m // block)
    nodes_n = max(1, n // block)
    per_row = max(1, int(round(nnz / max(m, 1))))
    K = max(1, -(-per_row // block) + 1)
    nx = max(2, int(round(nodes_n ** (1.0 / 3.0))))
    nxny = nx * nx
    centers = [0, -nx, nx, -nxny, nxny, -2 * nx, 2 * nx, -2 * nxny, 2 * nxny]
    offsets = []
    w = 0
    while len(offsets) < K:
        for c in centers:
            if len(offsets) >= K:
                break
            for d in ([0] if w == 0 else [-w, w]):
                o = c + d
                if o not in offsets:
                    offsets.append(o)
                    if len(offsets) >= K:
                        break
        w += 1
    offs = np.array(offsets[:K], dtype=np.int64)[None, :]
    nbr = np.clip(np.arange(nodes_m, dtype=np.int64)[:, None] * nodes_n // nodes_m + offs, 0,
                  nodes_n - 1)
    rn = np.repeat(np.arange(nodes_m, dtype=np.int64), K)
    cn = nbr.reshape(-1)
    pair = np.unique(rn * nodes_n + cn)
    rn = pair // nodes_n
    cn = pair % nodes_n
    bi = np.arange(block, dtype=np.int64)
    shape3 = (len(rn), block, block)
    rows = np.broadcast_to(rn[:, None, None] * block + bi[None, :, None], shape3).reshape(-1)
    cols = np.broadcast_to(cn[:, None, None] * block + bi[None, None, :], shape3).reshape(-1)
    keep = (rows < m) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    if len(rows) > nnz:
        sel = rng.choice(len(rows), nnz, replace=False)
        rows, cols = rows[sel], cols[sel]
    halo = 2 * block
    while len(rows) < nnz:
        need = nnz - len(rows)
        rr = rng.integers(0, m, 2 * need + 64)
        cc = np.clip(rr * n // max(m, 1) + rng.integers(-halo, halo + 1, 2 * need + 64), 0, n - 1)
        rows = np.concatenate([rows, rr])
        cols = np.concatenate([cols, cc])
        _, idx = np.unique(rows * n + cols, return_index=True)
        idx = np.sort(idx)[:nnz]
        rows, cols = rows[idx], cols[idx]
        halo *= 2
    vals = rng.random(len(rows)) * 2.0 - 1.0
    return coo_to_csr_arrays(rows, cols, vals, (m, n))


def build(cfg: dict):
    """The configuration's matrix as host arrays: (row_ptr, col_idx, values, shape)."""
    m, n, nnz = cfg["rows"], cfg["cols"], cfg["nnz"]
    rp, ci, v = fem_like_arrays(m, n, nnz, block=cfg["block"], spread_frac=cfg["spread_frac"],
                                seed=cfg["data_seed"])
    return rp, ci, v, (m, n)


class Operator:
    """y = A x by ``torch``'s sparse CSR product, in ``dtype`` on ``device``."""

    def __init__(self, cfg: dict, arrays, device, dtype=torch.float64):
        rp, ci, v, shape = arrays
        self.shape = shape
        self.dtype = dtype
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.a = torch.sparse_csr_tensor(
                torch.from_numpy(np.asarray(rp, dtype=np.int64)),
                torch.from_numpy(np.asarray(ci, dtype=np.int64)),
                torch.from_numpy(np.asarray(v)).to(dtype), size=shape,
                check_invariants=False).to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (self.a @ x.to(self.dtype).unsqueeze(1)).squeeze(1)
