"""Starting the ranks of a process group, and the targets the tests start.

The JAX package runs one process over a mesh of devices; the port runs one
process per device.  :func:`spawn` starts ``world_size`` processes with
``torch.multiprocessing`` (the ``spawn`` method), joins them to one group
through a rendezvous file in a fresh temporary directory (a fixed TCP port
would collide between test workers), runs ``fn(*args)`` on every rank and
returns each rank's result.  ``device="cuda"`` gives rank d the card d and the
NCCL backend, ``"cpu"`` the gloo backend.  :func:`gather_padded` puts the
ranks' blocks of a sharded vector back together.

A target must be importable without the caller's module: a function defined
in a test module would make every rank import that module (and JAX with it),
so the targets the tests start live here (:func:`rank_cases`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .dist_spmv import gather_mesh

__all__ = ["spawn", "gather_padded", "rank_cases"]

_TIMEOUT_S = 900.0  # a rank that never reports (a deadlocked collective) fails the spawn


def _rank_main(payload: str, rank: int, world_size: int, device: str, init: str,
               results) -> None:
    from .multihost import init_distributed, shutdown_distributed

    if device == "cpu":  # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        init_distributed(coordinator_address=init, num_processes=world_size, process_id=rank,
                         local_device_ids=[rank] if device == "cuda" else None, device=device)
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)  # written by spawn, in this run's directory
        results.put((rank, None, fn(*args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        shutdown_distributed()


def spawn(fn, world_size: int, device: str, *args) -> list:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank a
    process of its own in one joined group: ``device="cuda"`` gives rank d the
    card d under NCCL, ``"cpu"`` runs gloo ranks on the CPU; there is no
    default, so a caller chooses the CPU explicitly.  Raises with the rank's
    traceback when a rank fails, and after ``_TIMEOUT_S`` seconds; stops
    every rank it started before it returns."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} CUDA cards, "
                           f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="spmv_rdzv_") as td:
        init = "file://" + os.path.join(td, "rendezvous")
        # the function and its arguments go through a file: a large argument
        # in the process's own arguments fills the start pipe, and each start
        # then waits for the previous rank to finish its imports
        payload = os.path.join(td, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(payload, rank, world_size, device, init, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + _TIMEOUT_S
        try:
            while len(out) < world_size:
                try:
                    rank, err, res = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and i not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} before it reported")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks ran past {_TIMEOUT_S} s")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{err}")
                out[rank] = res
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]


def gather_padded(y_local: torch.Tensor, mesh) -> torch.Tensor:
    """The padded global vector (every rank's block, in shard order) that
    ``unpad_y`` / ``unpad_vector`` take, on this rank's device.  Every rank of
    ``mesh`` calls it."""
    return gather_mesh(y_local, mesh)


def _csr(arrays):
    from ..formats.containers import CSR

    rp, ci, v, shape = arrays
    return CSR.from_numpy(rp, ci, v, shape)


@contextlib.contextmanager
def _eager_iters(n):
    """``models.cg.CG_EAGER_ITERS`` set to ``n`` inside (None: left alone)."""
    from ..models import cg

    saved = cg.CG_EAGER_ITERS
    if n is not None:
        cg.CG_EAGER_ITERS = n
    try:
        yield
    finally:
        cg.CG_EAGER_ITERS = saved


@contextlib.contextmanager
def _counted_all_reduces(on):
    """With ``on``, ``torch.distributed.all_reduce`` counted inside, by the
    number of elements of the floating-point tensors it sums: yields the
    counts (a dict), else None and nothing is replaced."""
    if not on:
        yield None
        return
    real, counts = dist.all_reduce, {}

    def counted(t, *args, **kwargs):
        if t.is_floating_point():
            counts[t.numel()] = counts.get(t.numel(), 0) + 1
        return real(t, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield counts
    finally:
        dist.all_reduce = real


def _scaling_loop(csr, steps: int):
    from ..utils.graphs import Loop
    from .dist_spmv import make_mesh
    from .dist_swell import build_dist_swell, dist_swell_spmv_fn, pad_global
    from .scaling_bench import _renormalised

    mesh = make_mesh(dist.get_world_size())
    dsp = build_dist_swell(csr, mesh.size(), mesh=mesh)
    step = _renormalised(dist_swell_spmv_fn(dsp, mesh), mesh.get_group())
    L, d = dsp.rows_local, dist.get_rank()
    x = pad_global(dsp, torch.ones(csr.cols, dtype=csr.values.dtype))[d * L: (d + 1) * L]
    looped = Loop(step, x.contiguous(), unroll=4).run(x, steps)
    chained = x.contiguous()
    for _ in range(steps):
        chained = step(chained)
    return tuple(gather_padded(v, mesh)[: csr.rows].cpu().numpy() for v in (looped, chained))


def _masked_step_without_host_reads(csr, b) -> list:
    from ..models.cg import Jacobi, _cg_start, _masked_step
    from .dist_spmv import all_reduced_sum, dist_spmv_fn, dist_spmv_halo_fn, make_mesh
    from .dist_spmv import shard_partitioned
    from .dist_swell import build_dist_swell, dist_swell_spmv_fn, pad_global
    from .partition import pad_vector, partition_rows

    mesh = make_mesh(dist.get_world_size())
    d, reduce = dist.get_rank(), all_reduced_sum(mesh)
    part = shard_partitioned(partition_rows(csr, mesh.size(), balance=False), mesh)
    lr = part.local_rows
    matvecs = {}
    for name, build in (("gather", dist_spmv_fn), ("halo", dist_spmv_halo_fn)):
        run, _ = build(mesh, part, padded=True)
        matvecs[name] = (functools.partial(run, part.values, part.col_idx_padded, part.row_ids),
                         pad_vector(part, b)[d * lr: (d + 1) * lr])
    dsp = build_dist_swell(csr, mesh.size(), mesh=mesh)
    L = dsp.rows_local
    matvecs["swell"] = (dist_swell_spmv_fn(dsp, mesh), pad_global(dsp, torch.from_numpy(b))[
        d * L: (d + 1) * L].contiguous())

    def refuse(*_):
        raise RuntimeError("a host read inside a masked CG step")

    clean = []
    for name, (matvec, b_local) in matvecs.items():
        b_local = torch.as_tensor(b_local).contiguous()
        inv = torch.linspace(0.5, 2.0, b_local.numel(), dtype=b_local.dtype)
        # M = I (the distributed solvers'), Jacobi and a general M, each with the
        # all-reduced sums (F-2's phases) and with this rank's own (its fused form)
        for M in (Jacobi(None), Jacobi(inv.to(b_local.device)), lambda r: r):
            for red in (reduce, None):
                carry, tol2 = _cg_start(matvec, M, b_local, torch.zeros_like(b_local), 1e-12,
                                        red)
                max_iters = torch.tensor(10)
                saved = torch.Tensor.item, torch.Tensor.__bool__
                torch.Tensor.item = torch.Tensor.__bool__ = refuse
                try:
                    _masked_step(matvec, M, red, tol2, max_iters, carry)
                finally:
                    torch.Tensor.item, torch.Tensor.__bool__ = saved
        clean.append(name)
    return clean


def rank_cases(cases: list) -> list:
    """Run ``cases`` on this rank of a joined group (the test target; every
    rank runs the same list).  Each case is a dict with a ``kind`` and numpy
    inputs; each result is numpy (or a dict of plain values):

    - ``spmv``: ``csr`` (rp, ci, v, shape), ``x``, ``balance``, ``halo``:
      ``unpad_y`` of ``dist_spmv``;
    - ``hier``: ``csr``, ``x``, ``shape`` (dcn, ici): ``unpad_y`` of
      ``dist_spmv_hier`` on ``hybrid_mesh(*shape)``;
    - ``cg``: ``csr``, ``b`` (global), ``tol``, ``max_iters``: (x in global
      rows, iterations) of ``dist_cg_solve``; with ``eager_iters``,
      ``models.cg.CG_EAGER_ITERS`` is set to it around the call (``swell_cg``
      too), so that the masked blocks run; with ``count_reduces`` (both
      kinds) a third item, the solve's ``all_reduce`` calls on float
      tensors by their number of elements;
    - ``swell``: ``csr``, ``x``, ``halo``, ``env`` (variables set around the
      build): (y[:m], halo_ok, tail nnz) of ``dist_swell_spmv_fn``;
    - ``swell_cg``: ``csr``, ``b``, ``tol``, ``max_iters``: (x[:m], iterations)
      of ``dist_swell_cg_solve``;
    - ``scaling_loop``: ``csr``, ``steps``: the weak-scaling step
      (``scaling_bench._renormalised`` around ``dist_swell_spmv_fn``) run
      ``steps`` times from ones by a ``utils.graphs.Loop`` and by a Python
      loop: (both results in global rows);
    - ``masked_step``: ``csr`` (square), ``b``: one masked CG iteration
      (``models.cg._masked_step``, M = I, Jacobi and a general M) with the
      all-reduced sums (F-2's phases) and with this rank's own (its fused
      form), over the all-gather and the halo ``dist_spmv`` matvec and
      ``dist_swell``'s,
      with ``torch.Tensor.item`` and ``__bool__`` raising: the names of the
      matvecs whose step ran without a host read;
    - ``context``: ``init_distributed()``'s fields, the halo_feasible of
      ``csr``, and whether JAX is imported in this process."""
    from .dist_spmv import dist_spmv, halo_feasible, make_mesh, shard_partitioned, unpad_y
    from .dist_swell import build_dist_swell, dist_swell_cg_solve, dist_swell_spmv_fn, pad_global
    from .multihost import dist_spmv_hier, hybrid_mesh, init_distributed
    from .partition import pad_vector, partition_rows, unpad_vector
    from ..models.cg import dist_cg_solve

    world = dist.get_world_size()
    out = []
    for case in cases:
        kind = case["kind"]
        csr = _csr(case["csr"]) if "csr" in case else None
        if kind == "spmv":
            mesh = make_mesh(world)
            part = partition_rows(csr, world, balance=case.get("balance", True))
            y = dist_spmv(part, case["x"], mesh, halo=case.get("halo"))
            out.append(unpad_y(part, gather_padded(y, mesh)).cpu().numpy())
        elif kind == "hier":
            mesh = hybrid_mesh(*case["shape"])
            part = partition_rows(csr, world)
            y = dist_spmv_hier(part, case["x"], mesh)
            out.append(unpad_y(part, gather_padded(y, mesh)).cpu().numpy())
        elif kind == "cg":
            mesh = make_mesh(world)
            part = partition_rows(csr, world, balance=False)
            with _eager_iters(case.get("eager_iters")), \
                    _counted_all_reduces(case.get("count_reduces")) as counts:
                res = dist_cg_solve(part, pad_vector(part, case["b"]), mesh, tol=case["tol"],
                                    max_iters=case["max_iters"])
            x = unpad_vector(part, gather_padded(res.x, mesh)).cpu().numpy()
            out.append((x, res.iters) + (() if counts is None else (counts,)))
        elif kind == "swell":
            mesh = make_mesh(world)
            saved = {k: os.environ.get(k) for k in case.get("env", {})}
            os.environ.update(case.get("env", {}))
            try:
                dsp = build_dist_swell(csr, world, halo=case.get("halo"), mesh=mesh)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            run = dist_swell_spmv_fn(dsp, mesh, halo=case.get("halo"))
            d, L = dist.get_rank(), dsp.rows_local
            xp = pad_global(dsp, torch.from_numpy(case["x"]))
            y = gather_padded(run(xp[d * L: (d + 1) * L].contiguous()), mesh)
            out.append((y[: csr.rows].cpu().numpy(), dsp.halo_ok, dsp.tail_nnz))
        elif kind == "swell_cg":
            mesh = make_mesh(world)
            with _eager_iters(case.get("eager_iters")), \
                    _counted_all_reduces(case.get("count_reduces")) as counts:
                res, _ = dist_swell_cg_solve(csr, torch.from_numpy(case["b"]), mesh,
                                             tol=case["tol"], max_iters=case["max_iters"])
            x = gather_padded(res.x, mesh)[: csr.rows].cpu().numpy()
            out.append((x, res.iters) + (() if counts is None else (counts,)))
        elif kind == "scaling_loop":
            out.append(_scaling_loop(csr, case["steps"]))
        elif kind == "masked_step":
            out.append(_masked_step_without_host_reads(csr, case["b"]))
        elif kind == "context":
            ctx = init_distributed(device="cpu")
            mesh = make_mesh(world)
            part = shard_partitioned(partition_rows(csr, world, balance=False), mesh)
            out.append({"process_index": ctx.process_index, "process_count": ctx.process_count,
                        "global_device_count": ctx.global_device_count,
                        "initialized": ctx.initialized,
                        "halo_feasible": halo_feasible(part, mesh),
                        "jax_imported": "jax" in sys.modules})
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    return out
