"""Conjugate-gradient solver driven by the SpMV kernels.

Counterpart of ``spmv_acc_tpu/models/cg.py``'s single-device ``cg_solve``:
textbook preconditioned CG with the same stopping test, the residual
``dot(r, r) > tol^2 * max(dot(b, b), 1e-300)`` checked before every
iteration, and the same iteration count.  The JAX package runs the loop as a
``lax.while_loop`` on the device; here it is a Python loop of PyTorch ops whose
condition reads one scalar per iteration on the host.  Dot products are
``torch.dot`` (the JAX package's ``_vdot`` works around a TPU cost of f64 dots).
``dist_cg_solve`` is the mesh-distributed variant over the ranks of a process
group (``parallel/``): each rank holds a row block of A and the same block of
every vector, dot products are a local ``torch.dot`` and an ``all_reduce``, and
the matvec takes the 1-hop halo exchange or the all-gather of x.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..formats.containers import CSR

__all__ = ["CGResult", "cg_solve", "dist_cg_solve", "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual_norm: torch.Tensor  # 0-d, sqrt(dot(r, r)) of the last residual


def jacobi_preconditioner(csr: CSR) -> Callable:
    """M^{-1} r = r / diag(A), on ``csr``'s device (rows without a stored
    diagonal count 1)."""
    rp, ci, v, (m, _) = csr.to_numpy()
    diag = np.ones(m, dtype=v.dtype)
    rows = np.repeat(np.arange(m), np.diff(rp))
    on_diag = rows == ci
    diag[rows[on_diag]] = v[on_diag]
    inv = torch.from_numpy(1.0 / diag).to(csr.device)
    return lambda r: inv * r


def _cg_loop(matvec: Callable, precond: Optional[Callable], b, x0, tol, max_iters: int,
             dot: Callable = torch.dot) -> CGResult:
    """Preconditioned CG on any ``matvec`` and ``dot``: stops when
    ``dot(r, r) <= tol^2 * max(dot(b, b), 1e-300)`` or after ``max_iters``."""
    M = precond if precond is not None else (lambda r: r)
    x = x0
    r = b - matvec(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    tol2 = tol_t * tol_t * torch.clamp(dot(b, b), min=1e-300)
    it = 0
    while it < max_iters and bool(dot(r, r) > tol2):
        ap = matvec(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return CGResult(x=x, iters=it, residual_norm=torch.sqrt(dot(r, r)))


def cg_solve(csr: CSR, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
             max_iters: int = 1000, strategy: str = "adaptive",
             precond: Optional[Callable] = None) -> CGResult:
    """Solve A x = b (A symmetric positive definite) with the strategy zoo's
    SpMV, on ``csr``'s device.  ``strategy="swell"``, or ``"adaptive"`` when the
    picker chooses swell, runs every matvec on the swell layout (the swell
    kernel on a card); ``precond`` is a callable or an :class:`~..ops.trisolve.ILU0`."""
    from ..dispatch import pick_strategy, spmv
    from ..ops.trisolve import ILU0
    from ..plan import get_plan

    if x0 is None:
        x0 = torch.zeros_like(b)
    if isinstance(precond, ILU0):
        precond = precond.solve
    chosen = pick_strategy(get_plan(csr), csr) if strategy == "adaptive" else strategy
    if chosen == "swell":
        from ..ops.swell import get_swell_plan, swell_ax

        layout = get_swell_plan(csr)

        def matvec(v):
            return swell_ax(layout, v.to(layout.dtype)).to(b.dtype)
    else:
        def matvec(v):
            return spmv(csr, v, strategy=chosen)

    return _cg_loop(matvec, precond, b, x0, tol, max_iters)


def dist_cg_solve(part, b, mesh, tol: float = 1e-8, max_iters: int = 200) -> CGResult:
    """Mesh-distributed CG on a row-partitioned SPD matrix, called by every
    rank of the 1-D ``mesh``.

    A is square-partitioned so that each shard's y rows line up with its x
    rows (``partition_rows(csr, D, balance=False)``).  ``b`` is the padded
    ``(D*local_rows,)`` right-hand side (``pad_vector``); each rank takes its
    block, and the result's ``x`` is this rank's ``(local_rows,)`` block of
    the padded solution, on its device (all blocks: ``launch.gather_padded``;
    global rows: ``unpad_vector``).  Dot products are a local ``torch.dot``
    and an ``all_reduce``; the matvec is ``dist_spmv_halo_fn`` on
    ``col_idx_padded`` when every shard's columns (in padded coordinates) fit
    its own block and its two neighbours', else ``dist_spmv_fn``.

    Every rank takes the same number of iterations, or the next collective
    would wait forever: the stop test reads the all-reduced ``dot(r, r)``,
    which is the same value on every rank."""
    from ..parallel.dist_spmv import (all_reduced_dot, dist_spmv_fn, dist_spmv_halo_fn,
                                      halo_feasible, mesh_device, shard_partitioned)

    part = shard_partitioned(part, mesh)
    d, lr, D = part.shard, part.local_rows, part.num_shards
    build = dist_spmv_halo_fn if halo_feasible(part, mesh, padded=True) else dist_spmv_fn
    run, _ = build(mesh, part, padded=True)

    def matvec(v):
        return run(part.values, part.col_idx_padded, part.row_ids, v)

    b = torch.as_tensor(b)
    if tuple(b.shape) != (D * lr,):
        raise ValueError(f"b must be the padded ({D * lr},) right-hand side, got {tuple(b.shape)}")
    b_local = b[d * lr: (d + 1) * lr].to(mesh_device(mesh)).contiguous()
    return _cg_loop(matvec, None, b_local, torch.zeros_like(b_local), tol, max_iters,
                    all_reduced_dot(mesh))
