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

A solve (:class:`CGBlocks`) runs in blocks of ``CG_BLOCK`` masked
iterations: each F-2 launch reads ``active = rr > tol2 and it < max_iters``
on the device and writes nothing where it is false, and F-2 adds the
iteration to the device count, so a block's launches do not depend on any
value.  On the card a block is a captured CUDA graph (``utils.graphs.Loop``)
and the host reads one flag after each block; on the CPU the same block runs
eagerly.  A solver that has no block graph yet first runs up to
``CG_EAGER_ITERS`` iterations as the plain loop (``_cg_loop``'s, the stop
test read on the host before each) and captures only if the solve goes on;
one that holds its graph runs in blocks from the first iteration.
``cg_solve``, ``dist_cg_solve`` and ``parallel.dist_swell``'s
``dist_swell_cg_solve`` keep their last ``CG_SOLVERS`` solvers in one cache,
each through ``kept_solver``: against one operator and right-hand side's
shape, only the first solve that runs past the plain start captures, and a
short solve never does.  ``clear_dist_solver_cache`` drops the distributed
solvers, and with them their graphs that hold NCCL collectives, before a
group is destroyed.  Once the solve has converged a masked iteration changes
nothing, so the iterations and x are the plain loop's, bit for bit,
wherever the blocks start.
``dist_cg_solve`` is the mesh-distributed variant over the ranks of a process
group (``parallel/``): each rank holds a row block of A and the same block of
every vector, and F-2 runs as three phases, ``cg_dot`` (p·Ap), ``cg_xr`` (x
and r, then r·z and r·r) and ``cg_p`` (p, rz, rr, the count), its sums each
rank's block and one ``all_reduce`` each time they are needed (``p·Ap`` after
``cg_dot``; ``[r·z, r·r]`` together before ``cg_p``, as XLA's all-reduce
combiner merges the JAX loop's psums), and the matvec takes the 1-hop halo
exchange of the spans each shard reads or the all-gather of x.  It runs the
same ``CGBlocks`` (the JAX package jits its ``while_loop`` with the
collectives inside): on the card each block is a captured graph that holds
its NCCL collectives, and the flag the host reads after a block is the
all-reduced stop test, the same on every rank, so every rank replays the
same graphs in the same order.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..formats.containers import CSR, on_replace_values
from ..ops import cg_update
from ..ops.cg_update import Work
from ..utils import profiling

__all__ = ["CGResult", "CG_BLOCK", "CG_EAGER_ITERS", "CG_SOLVERS", "CGBlocks", "Jacobi",
           "cg_solve", "clear_solver_cache", "clear_dist_solver_cache", "dist_solvers_kept",
           "dist_cg_solve", "dist_cg_blocks", "jacobi_preconditioner"]

# Masked CG iterations in one block: the host reads one flag a block.  A solve
# runs whole blocks, so up to CG_BLOCK - 1 masked iterations after convergence
# are wasted work, and each block's replay and flag read cost the host once.
# On the H100 (scripts/torch_probe_graphs.py tune, PERF.md) 8 was within 4 %
# of the best solve time on 512^2 aniso (1347 and 417 iterations) and cost
# 2.3 ms more than 4 on Ga41As41H72-SPD's 4-iteration ILU solve.
CG_BLOCK = 8

# Plain iterations before a solver's first captured block.  Beyond its
# warm-up (the block's iterations, run for real) a block's capture cost 5-35
# ms on the H100 (2.4-3.5 s over the exact ILU apply; 65-90 ms more for a
# process's first capture; scripts/torch_probe_graphs.py solve, PERF.md): the
# time of 11-240 plain iterations on the bench's solver systems, af23560 and
# dw4096.  It guards only a solver's first solve past it, or an operator
# whose solves never pass it (Ga41As41H72-SPD's 10 and 4 iterations run at
# the plain loop's time, with no capture): a kept solver that holds its
# graph runs in blocks from the first iteration.
CG_EAGER_ITERS = 64

# Solvers kept across calls, least recently used first out.  Each holds its
# block graphs and their memory pool (21 and 63 MB on hpcg104 under Jacobi
# and ILU(0), PERF.md), so that a caller solving against one matrix and
# preconditioner captures once, not once a solve.
CG_SOLVERS = 4


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
    blocks of ``block`` masked iterations (module docstring), captured CUDA
    graphs for CUDA tensors, eager for CPU ones.  The last block before
    ``max_iters`` is cut to the iterations left, so a solve at tol 0 runs
    exactly ``max_iters``.  The graphs are captured at the first solve that
    runs past ``eager_iters`` plain iterations and kept for later solves with
    the same shapes (``tol`` and ``max_iters`` live in device buffers), which
    then run in blocks from their first iteration.  Where
    ``reduce`` sums over a mesh (``dist_cg_blocks``), every rank of its group
    solves with the same arguments (``utils.graphs.Loop``).  ``on_matvecs``,
    where given, is called with ``n`` each time ``n`` more matvecs have run:
    the start's one, the plain iterations, and each block's iterations, a
    replayed block's too, which runs no Python.  ``current``, where given,
    says whether ``matvec`` reads the new values that
    ``formats.containers.replace_values`` wrote into its matrix; a kept
    solver without it holds the old ones and is dropped there."""

    def __init__(self, matvec: Callable, precond: Optional[Callable], b: torch.Tensor,
                 block: int = CG_BLOCK, reduce: Optional[Callable] = None,
                 eager_iters: int = CG_EAGER_ITERS,
                 on_matvecs: Optional[Callable[[int], None]] = None,
                 current: Optional[Callable[[], bool]] = None):
        self.matvec = matvec
        self.current = current or (lambda: False)
        self.M = precond if precond is not None else Jacobi(None)
        self.reduce = reduce
        self.block = block
        self.eager_iters = eager_iters
        self.on_matvecs = on_matvecs or (lambda n: None)
        self.tol2 = torch.zeros((), dtype=b.dtype, device=b.device)
        self.max_iters = torch.zeros((), dtype=torch.int64, device=b.device)
        self.loop = None

    def solve(self, b: torch.Tensor, x0: torch.Tensor, tol, max_iters: int) -> CGResult:
        """Spans: ``cg.solve`` around the call, ``cg.eager`` around the plain
        iterations and their host reads (none once the graphs exist),
        ``cg.blocks`` around the masked blocks (their captures,
        ``graphs.capture``, inside it)."""
        with profiling.span("cg.solve"):
            return self._solve(b, x0, tol, max_iters)

    def _solve(self, b, x0, tol, max_iters: int) -> CGResult:
        from ..utils.graphs import Loop

        carry, tol2 = _cg_start(self.matvec, self.M, b, x0, tol, self.reduce)
        self.on_matvecs(1)
        done = 0  # iterations run, masked ones included: never past max_iters
        if self.loop is None:  # no graph yet: the plain start
            limit = min(self.eager_iters, max_iters)
            with profiling.span("cg.eager"):
                carry, done = _plain_steps(self.matvec, self.M, self.reduce, tol2, carry, limit)
            self.on_matvecs(done)
            if done < limit:  # converged
                x, _, _, _, rr, it = carry
                return CGResult(x=x, iters=int(it), residual_norm=torch.sqrt(rr))
        else:
            self.loop.load(carry)
        self.tol2.copy_(tol2)
        self.max_iters.fill_(max_iters)
        with profiling.span("cg.blocks"):
            while done < max_iters and bool(_more(carry, self.tol2, self.max_iters)):
                if self.loop is None:
                    # the step holds no reference to self: the loop's graphs go with it
                    step = functools.partial(_masked_step, self.matvec, self.M, self.reduce,
                                             self.tol2, self.max_iters, work=Work(b))
                    self.loop = Loop(step, carry, unroll=self.block)
                k = min(self.block, max_iters - done)
                self.loop.advance(k)
                self.on_matvecs(k)
                done += k
                carry = self.loop.carry
        x, _, _, _, rr, it = carry
        return CGResult(x=x.clone(), iters=int(it), residual_norm=torch.sqrt(rr))


_SOLVERS: collections.OrderedDict = collections.OrderedDict()  # key -> (held, solver)
_SOLVERS_LOCK = threading.Lock()


def clear_solver_cache() -> None:
    """Drop every kept solver, and with them their graphs."""
    with _SOLVERS_LOCK:
        _SOLVERS.clear()


def clear_dist_solver_cache() -> None:
    """Drop every distributed solver kept (``kept_solver`` with a mesh), and
    with them their graphs that hold NCCL collectives: before the group they
    were captured in is destroyed (``parallel.multihost.shutdown_distributed``)."""
    with _SOLVERS_LOCK:
        for key in [k for k in _SOLVERS if k[0]]:
            del _SOLVERS[key]


def dist_solvers_kept() -> int:
    """How many distributed solvers are kept."""
    with _SOLVERS_LOCK:
        return sum(bool(k[0]) for k in _SOLVERS)


def _drop_solvers(csr: CSR) -> int:
    """``formats.containers.replace_values``' hook: drop the solvers kept on
    ``csr``'s arrays, of one device or of a mesh, but those whose matvec read
    the new values in place (:attr:`CGBlocks.current`).  Returns how many
    went."""
    with _SOLVERS_LOCK:
        gone = [key for key, (held, solver) in _SOLVERS.items()
                if held[0] is csr.row_ptr and held[1] is csr.col_idx and held[2] is csr.values
                and not (isinstance(solver, CGBlocks) and solver.current())]
        for key in gone:
            del _SOLVERS[key]
    return len(gone)


on_replace_values(_drop_solvers, solvers=True)


@contextlib.contextmanager
def kept_solver(held: tuple, spec: tuple, build: Callable, mesh=None):
    """The solver kept under the ids of ``held`` (held by the entry, so no id
    is reused), ``spec``, ``CG_BLOCK`` and ``CG_EAGER_ITERS``, else
    ``build()``'s: out of the cache while the ``with`` block runs, kept after
    it, least recently used out past ``CG_SOLVERS``.  With ``mesh``, keyed
    and held with its group, the ranks agree on hit or miss (``all_agree``:
    ids are each rank's own).  Counts ``dist.solvers.hit`` / ``.built`` (with
    ``mesh``) or ``cg.solvers.hit`` / ``.built``."""
    if mesh is not None:
        held = held + (mesh.get_group(),)
    key = (mesh is not None,) + tuple(id(h) for h in held) + spec + (CG_BLOCK, CG_EAGER_ITERS)
    with _SOLVERS_LOCK:
        entry = _SOLVERS.pop(key, None)
    hit = entry is not None
    if mesh is not None:
        from ..parallel.dist_spmv import all_agree

        hit = all_agree(hit, mesh)
    profiling.count(f"{'cg' if mesh is None else 'dist'}.solvers.{'hit' if hit else 'built'}")
    solver = entry[1] if hit else build()
    yield solver
    with _SOLVERS_LOCK:
        _SOLVERS[key] = (held, solver)
        _SOLVERS.move_to_end(key)
        while len(_SOLVERS) > CG_SOLVERS:
            _SOLVERS.popitem(last=False)


def _new_solver(csr: CSR, chosen: str, precond, b: torch.Tensor) -> CGBlocks:
    """A :class:`CGBlocks` on ``csr``'s matvec by the strategy ``chosen`` (on
    the swell layout for swell) and ``precond`` (an ILU0 as its ``solve``)."""
    from ..dispatch import spmv
    from ..ops.trisolve import ILU0

    current = None
    if chosen == "swell":
        from ..ops.swell import get_swell_plan, in_plan_cache, swell_ax

        layout, dtype = get_swell_plan(csr), b.dtype

        def matvec(v):
            return swell_ax(layout, v.to(layout.dtype)).to(dtype)

        def current():  # replace_values refreshes a cached layout in place
            return in_plan_cache(layout)
    else:
        def matvec(v):
            return spmv(csr, v, strategy=chosen)
    return CGBlocks(matvec, precond.solve if isinstance(precond, ILU0) else precond, b,
                    block=CG_BLOCK, eager_iters=CG_EAGER_ITERS, current=current)


def cg_solve(csr: CSR, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
             max_iters: int = 1000, strategy: str = "adaptive",
             precond: Optional[Callable] = None) -> CGResult:
    """Solve A x = b (A symmetric positive definite) with the strategy zoo's
    SpMV, on ``csr``'s device.  ``strategy="swell"``, or ``"adaptive"`` when the
    picker chooses swell, runs every matvec on the swell layout (the swell
    kernel on a card); ``precond`` is a callable or an :class:`~..ops.trisolve.ILU0`.

    Runs a :class:`CGBlocks` kept across calls (``CG_SOLVERS`` of them) by
    ``csr``'s arrays, the ``precond`` object, the chosen strategy, ``b``'s
    dtype, shape and device, ``CG_BLOCK`` and ``CG_EAGER_ITERS``: a new
    solver runs the plain loop for ``CG_EAGER_ITERS`` iterations, then
    captured CUDA graphs on a card; a kept one that holds its graphs runs
    them from the first iteration.  The counters ``cg.solvers.hit`` and
    ``cg.solvers.built`` (``utils.profiling``) count the two."""
    from ..dispatch import pick_strategy
    from ..plan import get_plan

    if x0 is None:
        x0 = torch.zeros_like(b)
    chosen = pick_strategy(get_plan(csr), csr) if strategy == "adaptive" else strategy
    with kept_solver((csr.row_ptr, csr.col_idx, csr.values, precond),
                     (chosen, b.dtype, tuple(b.shape), b.device),
                     lambda: _new_solver(csr, chosen, precond, b)) as solver:
        return solver.solve(b, x0, tol, max_iters)


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
    reads the all-reduced ``r·r``, which is the same value on every rank.
    The solver is kept (``kept_solver``) by ``part``'s arrays, the mesh and
    ``b``'s dtype, shape and device: a later solve on the operator builds
    nothing and runs its captured blocks from the first iteration."""
    from ..parallel.dist_spmv import (dist_spmv_fn, dist_spmv_halo_fn, halo_feasible,
                                      mesh_device, mesh_rank, shard_partitioned)

    D, lr = part.num_shards, part.local_rows
    b = torch.as_tensor(b)
    if tuple(b.shape) != (D * lr,):
        raise ValueError(f"b must be the padded ({D * lr},) right-hand side, got {tuple(b.shape)}")
    d = mesh_rank(mesh)
    b_local = b[d * lr: (d + 1) * lr].to(mesh_device(mesh)).contiguous()

    def build():
        shard = shard_partitioned(part, mesh)
        halo = halo_feasible(shard, mesh, padded=True)
        run, _ = (dist_spmv_halo_fn if halo else dist_spmv_fn)(mesh, shard, padded=True)
        return dist_cg_blocks(functools.partial(run, shard.values, shard.col_idx_padded,
                                                shard.row_ids), b_local, mesh)

    with kept_solver((part.values, part.col_idx_padded, part.row_ids),
                     ("dist_cg", b.dtype, tuple(b.shape), b.device), build, mesh) as solver:
        return solver.solve(b_local, torch.zeros_like(b_local), tol, max_iters)


def dist_cg_blocks(matvec: Callable, b_local: torch.Tensor, mesh,
                   on_matvecs: Optional[Callable[[int], None]] = None) -> CGBlocks:
    """The :class:`CGBlocks` of a distributed solve on this rank's block:
    unpreconditioned, F-2's sums all-reduced over ``mesh``, ``CG_EAGER_ITERS``
    plain iterations, collectives in the captured blocks."""
    from ..parallel.dist_spmv import all_reduced_sum

    return CGBlocks(matvec, None, b_local, block=CG_BLOCK, reduce=all_reduced_sum(mesh),
                    eager_iters=CG_EAGER_ITERS, on_matvecs=on_matvecs)
