"""Conjugate-gradient solver driven by the SpMV kernels.

Counterpart of ``spmv_acc_tpu/models/cg.py``'s single-device ``cg_solve``:
textbook preconditioned CG with the same stopping test, the residual
``dot(r, r) > tol^2 * max(dot(b, b), 1e-300)`` checked before every
iteration, and the same iteration count.  The JAX package runs the loop as a
``lax.while_loop`` on the device, and XLA fuses the body's vector work
around the matvec into a few kernels.  Here every iteration is the matvec
and F-2 (``ops/cg_update.py``, the kernel of ``csrc/cg_update.cu`` on a
card).  On one device F-2 is its fused form: one cooperative launch,
``cg_step``, where M is the identity or Jacobi (:class:`Jacobi`: the kernel
forms z = inv * r in registers), and ``cg_dot_xr`` (p·Ap, x and r in place,
r·r), M's apply and ``cg_dot_p`` (r·z, p, then rz, rr and the count) for any
other preconditioner.  The carry is ``(x, r, p, rz, rr, it)``: the stop test
reads the ``rr`` that F-2 summed (the JAX ``cond`` sums ``dot(r, r)`` of the
same r again), and z, a function of r, is not carried.

``cg_solve`` runs its first ``CG_EAGER_ITERS`` iterations as the plain loop
(``_cg_loop``'s, the stop test read on the host before each), and what is
left in blocks of ``CG_BLOCK`` masked iterations: each F-2 launch reads
``active = rr > tol2 and it < max_iters`` on the device and writes nothing where it
is false, and F-2 adds the iteration to the device count, so a block's
launches do not depend on any value.  On the card a block is a captured CUDA
graph (``utils.graphs.Loop``) and the host reads one flag after each block;
on the CPU the same block runs eagerly.  A short solve thus pays no capture,
and a long one pays it once.  Once the solve has converged a masked
iteration changes nothing, so the iterations and x are the plain loop's, bit
for bit.
``dist_cg_solve`` is the mesh-distributed variant over the ranks of a process
group (``parallel/``): each rank holds a row block of A and the same block of
every vector, and F-2 runs as three phases, ``cg_dot`` (p·Ap), ``cg_xr`` (x
and r, then r·z and r·r) and ``cg_p`` (p, rz, rr, the count), its sums each
rank's block and one ``all_reduce`` each time they are needed (``p·Ap`` after
``cg_dot``; ``[r·z, r·r]`` together before ``cg_p``, as XLA's all-reduce
combiner merges the JAX loop's psums), and
the matvec takes the 1-hop halo exchange or the all-gather of x.  It runs the
same ``CGBlocks`` (the JAX package jits its ``while_loop`` with the
collectives inside): on the card each block is a captured graph that holds
its NCCL collectives, and the flag the host reads after a block is the
all-reduced stop test, the same on every rank, so every rank replays the
same graphs in the same order.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..formats.containers import CSR
from ..ops import cg_update
from ..ops.cg_update import Work

__all__ = ["CGResult", "CG_BLOCK", "CG_EAGER_ITERS", "CGBlocks", "Jacobi", "cg_solve",
           "dist_cg_solve", "dist_cg_blocks", "jacobi_preconditioner"]

# Masked CG iterations in one block: the host reads one flag a block.  A solve
# runs whole blocks, so up to CG_BLOCK - 1 masked iterations after convergence
# are wasted work, and each block's replay and flag read cost the host once.
# On the H100 (scripts/torch_probe_graphs.py tune, PERF.md) 8 was within 4 %
# of the best solve time on 512^2 aniso (1347 and 417 iterations) and cost
# 2.3 ms more than 4 on Ga41As41H72-SPD's 4-iteration ILU solve.
CG_BLOCK = 8

# Plain iterations before the first captured block.  Beyond its warm-up (the
# block's iterations, run for real) a block's capture cost 5-35 ms on the H100
# (2.4-3.5 s over the exact ILU apply; 65-90 ms more for a process's first
# capture; scripts/torch_probe_graphs.py solve, PERF.md): the time of 11-240
# plain iterations on the bench's solver systems, af23560 and dw4096.  A
# solve shorter than this pays no capture (Ga41As41H72-SPD's 10 and 4
# iterations run at the plain loop's time); a longer one pays it once.
CG_EAGER_ITERS = 64


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual_norm: torch.Tensor  # 0-d, sqrt(dot(r, r)) of the last residual


class Jacobi:
    """The preconditioner ``M^{-1} r = inv * r`` (``inv`` a vector; None: the
    identity), called as ``M(r)``.  The CG step recognises it and hands
    ``inv`` to F-2's kernels, which form z in registers; any other callable
    is applied as it is."""

    def __init__(self, inv: Optional[torch.Tensor]):
        self.inv = inv

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return r if self.inv is None else self.inv * r


def jacobi_preconditioner(csr: CSR) -> Jacobi:
    """M^{-1} r = r / diag(A), on ``csr``'s device (rows without a stored
    diagonal count 1)."""
    rp, ci, v, (m, _) = csr.to_numpy()
    diag = np.ones(m, dtype=v.dtype)
    rows = np.repeat(np.arange(m), np.diff(rp))
    on_diag = rows == ci
    diag[rows[on_diag]] = v[on_diag]
    return Jacobi(torch.from_numpy(1.0 / diag).to(csr.device))


def _cg_start(matvec: Callable, M: Callable, b, x0, tol, reduce=None):
    """The initial carry (x, r, p, rz, rr, it) and tol2, as ``_cg_loop`` forms
    them (p a copy of z, so that F-2 may update it in place); each dot
    is this rank's ``torch.dot`` completed by ``reduce`` (None: one device)."""
    def dot(a, c):
        s = torch.dot(a, c)
        return s if reduce is None else reduce(s)

    r = b - matvec(x0)
    z = M(r)
    tol_t = torch.as_tensor(tol, dtype=b.dtype, device=b.device)
    tol2 = tol_t * tol_t * torch.clamp(dot(b, b), min=1e-300)
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    return (x0.clone(), r, z.clone(), dot(r, z), dot(r, r), it), tol2


def _step(matvec: Callable, M: Callable, reduce, tol2, max_iters, work: Work, carry):
    """One CG iteration on ``carry`` in place: the matvec and F-2, masked by
    ``tol2`` and ``max_iters`` (None: unmasked).  On one device (``reduce``
    None) F-2's fused form: ``cg_step`` where M is the identity or Jacobi,
    else ``cg_dot_xr``, M and ``cg_dot_p``; over a mesh its three phases,
    ``reduce`` completing their sums in place over the ranks between them."""
    x, r, p, rz, rr, it = carry
    ap = matvec(p)
    if reduce is None:
        if isinstance(M, Jacobi):
            cg_update.cg_step(carry, ap, work, inv=M.inv, tol2=tol2, max_iters=max_iters)
        else:
            cg_update.cg_dot_xr(carry, ap, work, tol2=tol2, max_iters=max_iters)
            cg_update.cg_dot_p(carry, M(r), work, tol2=tol2, max_iters=max_iters)
        return carry
    cg_update.cg_dot(p, ap, work, cg_update.PAP)
    reduce(work.sums[:1])
    if isinstance(M, Jacobi):
        cg_update.cg_xr(carry, ap, work, inv=M.inv, tol2=tol2, max_iters=max_iters)
        z = None
    else:
        cg_update.cg_xr(carry, ap, work, with_rz=False, tol2=tol2, max_iters=max_iters)
        z = M(r)
        cg_update.cg_dot(r, z, work, cg_update.RZ)
    reduce(work.sums[1:])
    cg_update.cg_p(carry, work, inv=M.inv if z is None else None, z=z, tol2=tol2,
                   max_iters=max_iters)
    return carry


def _plain_steps(matvec: Callable, M: Callable, reduce, tol2, carry, limit: int):
    """Up to ``limit`` CG iterations on ``carry`` (in place), each after the
    stop test ``rr > tol2`` read on the host: (the carry, the iterations run)."""
    work, rr = Work(carry[0]), carry[4]
    done = 0
    while done < limit and bool(rr > tol2):
        _step(matvec, M, reduce, None, None, work, carry)
        done += 1
    return carry, done


def _cg_loop(matvec: Callable, precond: Optional[Callable], b, x0, tol, max_iters: int,
             reduce: Optional[Callable] = None) -> CGResult:
    """Preconditioned CG on any ``matvec``, its sums completed by ``reduce``
    (None: one device; ``parallel.dist_spmv.all_reduced_sum``: over a mesh):
    stops when ``dot(r, r) <= tol^2 * max(dot(b, b), 1e-300)`` or after
    ``max_iters``."""
    M = precond if precond is not None else Jacobi(None)
    carry, tol2 = _cg_start(matvec, M, b, x0, tol, reduce)
    (x, _, _, _, rr, _), done = _plain_steps(matvec, M, reduce, tol2, carry, max_iters)
    return CGResult(x=x, iters=done, residual_norm=torch.sqrt(rr))


def _more(carry, tol2, max_iters):
    """The stop test, on the device: rr > tol2 and it < max_iters."""
    return (carry[4] > tol2) & (carry[5] < max_iters)


def _masked_step(matvec, M, reduce, tol2, max_iters, carry, work: Optional[Work] = None):
    """One CG iteration where the stop test holds; the carry unchanged where
    not.  Updates ``carry`` in place and returns it; ``work`` is the scratch
    of F-2 (a new one when None)."""
    return _step(matvec, M, reduce, tol2, max_iters,
                 Work(carry[0]) if work is None else work, carry)


class CGBlocks:
    """Preconditioned CG on any ``matvec`` and preconditioner callable:
    ``eager_iters`` plain iterations, then blocks of ``block`` masked ones
    (module docstring), captured CUDA graphs for CUDA tensors, eager for CPU
    ones.  The last block before ``max_iters`` is cut to the iterations left,
    so a solve at tol 0 runs exactly ``max_iters``.  The graphs are captured
    at the first solve that reaches a block and kept for later solves with the
    same shapes (``tol`` and ``max_iters`` live in device buffers).  Where
    ``reduce`` sums over a mesh (``dist_cg_blocks``), every rank of its group
    solves with the same arguments (``utils.graphs.Loop``)."""

    def __init__(self, matvec: Callable, precond: Optional[Callable], b: torch.Tensor,
                 block: int = CG_BLOCK, reduce: Optional[Callable] = None,
                 eager_iters: int = CG_EAGER_ITERS):
        self.matvec = matvec
        self.M = precond if precond is not None else Jacobi(None)
        self.reduce = reduce
        self.block = block
        self.eager_iters = eager_iters
        self.tol2 = torch.zeros((), dtype=b.dtype, device=b.device)
        self.max_iters = torch.zeros((), dtype=torch.int64, device=b.device)
        self.loop = None

    def solve(self, b: torch.Tensor, x0: torch.Tensor, tol, max_iters: int) -> CGResult:
        from ..utils.graphs import Loop

        carry, tol2 = _cg_start(self.matvec, self.M, b, x0, tol, self.reduce)
        limit = min(self.eager_iters, max_iters)
        carry, done = _plain_steps(self.matvec, self.M, self.reduce, tol2, carry, limit)
        if done < limit:  # converged
            x, _, _, _, rr, it = carry
            return CGResult(x=x, iters=int(it), residual_norm=torch.sqrt(rr))
        self.tol2.copy_(tol2)
        self.max_iters.fill_(max_iters)
        if self.loop is not None:
            self.loop.load(carry)
        # done: iterations run, masked ones included: never past max_iters
        while done < max_iters and bool(_more(carry, self.tol2, self.max_iters)):
            if self.loop is None:
                # the step holds no reference to self: the loop's graphs go with it
                step = functools.partial(_masked_step, self.matvec, self.M, self.reduce, self.tol2,
                                         self.max_iters, work=Work(b))
                self.loop = Loop(step, carry, unroll=self.block)
            k = min(self.block, max_iters - done)
            self.loop.advance(k)
            done += k
            carry = self.loop.carry
        x, _, _, _, rr, it = carry
        return CGResult(x=x.clone(), iters=int(it), residual_norm=torch.sqrt(rr))


def cg_solve(csr: CSR, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
             max_iters: int = 1000, strategy: str = "adaptive",
             precond: Optional[Callable] = None) -> CGResult:
    """Solve A x = b (A symmetric positive definite) with the strategy zoo's
    SpMV, on ``csr``'s device.  ``strategy="swell"``, or ``"adaptive"`` when the
    picker chooses swell, runs every matvec on the swell layout (the swell
    kernel on a card); ``precond`` is a callable or an :class:`~..ops.trisolve.ILU0`.
    Runs :class:`CGBlocks`: the plain loop for ``CG_EAGER_ITERS`` iterations,
    then captured CUDA graphs on a card."""
    from ..dispatch import pick_strategy, spmv
    from ..ops.trisolve import ILU0
    from ..plan import get_plan

    if x0 is None:
        x0 = torch.zeros_like(b)
    if isinstance(precond, ILU0):
        precond = precond.solve
    plan = get_plan(csr)
    chosen = pick_strategy(plan, csr) if strategy == "adaptive" else strategy
    if chosen == "swell":
        from ..ops.swell import get_swell_plan, swell_ax

        layout = get_swell_plan(csr)

        def matvec(v):
            return swell_ax(layout, v.to(layout.dtype)).to(b.dtype)
    else:
        def matvec(v):
            return spmv(csr, v, strategy=chosen)
    return CGBlocks(matvec, precond, b, block=CG_BLOCK,
                    eager_iters=CG_EAGER_ITERS).solve(b, x0, tol, max_iters)


def dist_cg_solve(part, b, mesh, tol: float = 1e-8, max_iters: int = 200) -> CGResult:
    """Mesh-distributed CG on a row-partitioned SPD matrix, called by every
    rank of the 1-D ``mesh``.

    A is square-partitioned so that each shard's y rows line up with its x
    rows (``partition_rows(csr, D, balance=False)``).  ``b`` is the padded
    ``(D*local_rows,)`` right-hand side (``pad_vector``); each rank takes its
    block, and the result's ``x`` is this rank's ``(local_rows,)`` block of
    the padded solution, on its device (all blocks: ``launch.gather_padded``;
    global rows: ``unpad_vector``).  Dot products are this rank's sums and an
    ``all_reduce``; the matvec is ``dist_spmv_halo_fn`` on
    ``col_idx_padded`` when every shard's columns (in padded coordinates) fit
    its own block and its two neighbours', else ``dist_spmv_fn``.

    Runs :class:`CGBlocks` as ``cg_solve`` does: ``CG_EAGER_ITERS`` plain
    iterations, then blocks of ``CG_BLOCK`` masked ones, on the card captured
    graphs with the collectives inside.  Every rank takes the same number of
    iterations, or the next collective would wait forever: the stop test
    reads the all-reduced ``r·r``, which is the same value on every
    rank."""
    from ..parallel.dist_spmv import (dist_spmv_fn, dist_spmv_halo_fn, halo_feasible,
                                      mesh_device, shard_partitioned)

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
    return dist_cg_blocks(matvec, b_local, mesh).solve(b_local, torch.zeros_like(b_local), tol,
                                                       max_iters)


def dist_cg_blocks(matvec: Callable, b_local: torch.Tensor, mesh) -> CGBlocks:
    """The :class:`CGBlocks` of a distributed solve on this rank's block:
    unpreconditioned, F-2's sums all-reduced over ``mesh``, ``CG_EAGER_ITERS``
    plain iterations, collectives in the captured blocks."""
    from ..parallel.dist_spmv import all_reduced_sum

    return CGBlocks(matvec, None, b_local, block=CG_BLOCK, reduce=all_reduced_sum(mesh),
                    eager_iters=CG_EAGER_ITERS)
