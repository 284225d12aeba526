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
from unittest import mock

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
def _patched(*changes):
    """Each ``(obj, name, value)`` of ``changes`` set inside and restored
    after; a None value leaves its attribute alone."""
    changes = [c for c in changes if c[2] is not None]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in changes]
    for obj, name, value in changes:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


@contextlib.contextmanager
def _counted_all_reduces(on):
    """With ``on``, ``torch.distributed.all_reduce`` counted inside, by the
    number of elements of the floating-point tensors it sums: yields the
    counts (a dict), else None and nothing is replaced."""
    real, counts = dist.all_reduce, {}

    def counted(t, *args, **kwargs):
        if t.is_floating_point():
            counts[t.numel()] = counts.get(t.numel(), 0) + 1
        return real(t, *args, **kwargs)

    with _patched((dist, "all_reduce", counted if on else None)):
        yield counts if on else None


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


def _kept_solves(csr, bs, tol, max_iters, solver) -> dict:
    """``solver`` (``"dist_swell_cg_solve"`` or ``"dist_cg_solve"``) on one
    mesh for each of ``bs`` in turn (the first builds its solver, the others
    find it kept), then each again on a fresh solver: per solve x in global
    rows, the iterations, the counters' growth and whether the plain start
    ran; with the halo path's choice and the rows of a shard."""
    from ..models import cg
    from ..utils import profiling
    from .dist_spmv import halo_feasible, make_mesh
    from .dist_swell import dist_swell_cg_solve
    from .partition import pad_vector, partition_rows, unpad_vector

    mesh = make_mesh(dist.get_world_size())
    part = partition_rows(csr, mesh.size(), balance=False)
    out = {"kept": [], "fresh": []}

    def solve(b):
        before = profiling.spans()
        if solver == "dist_cg_solve":
            res = cg.dist_cg_solve(part, pad_vector(part, b), mesh, tol=tol, max_iters=max_iters)
            x = unpad_vector(part, gather_padded(res.x, mesh))
            out.update(halo_ok=halo_feasible(part, padded=True), rows_local=part.local_rows)
        else:
            res, dsp = dist_swell_cg_solve(csr, torch.from_numpy(b), mesh, tol=tol,
                                           max_iters=max_iters)
            x = gather_padded(res.x, mesh)[: csr.rows]
            out.update(halo_ok=dsp.halo_ok, rows_local=dsp.rows_local)
        grown = profiling.since(before)
        rec = {n: grown[n].total if n in grown else 0
               for n in ("dist.solvers.built", "dist.solvers.hit", "dist.halo_bytes")}
        rec.update(x=x.cpu().numpy(), iters=res.iters, eager="cg.eager" in grown)
        return rec

    for key in ("kept", "fresh"):
        for b in bs:
            if key == "fresh":
                cg.clear_dist_solver_cache()
            out[key].append(solve(b))
    return out


@contextlib.contextmanager
def _counted_p2p():
    """``torch.distributed.batch_isend_irecv`` counted inside: yields a list
    that each call appends its (point-to-point ops, elements they move) to."""
    real, calls = dist.batch_isend_irecv, []

    def counted(ops):
        calls.append((len(ops), sum(op.tensor.numel() for op in ops)))
        return real(ops)

    with _patched((dist, "batch_isend_irecv", counted)):
        yield calls


def _whole_block_exchanger(mesh, *_):
    """The tests' reference halo exchange, called as ``halo_exchanger``:
    ``exchange(x_local) -> window`` sends this rank's whole block to each
    neighbour and receives theirs whole, into a new 3-block window (zeros
    where there is no neighbour)."""
    from .dist_spmv import mesh_rank

    group = mesh.get_group()
    ranks = dist.get_process_group_ranks(group)
    d = mesh_rank(mesh)
    peers = (ranks[d - 1] if d > 0 else None, ranks[d + 1] if d < len(ranks) - 1 else None)

    def exchange(x_local):
        n = x_local.shape[0]
        window = x_local.new_zeros(3 * n)
        window[n: 2 * n] = x_local
        ops = [dist.P2POp(op, buf, peer, group)
               for peer, far in zip(peers, (window[:n], window[2 * n:])) if peer is not None
               for op, buf in ((dist.isend, window[n: 2 * n]), (dist.irecv, far))]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return window

    return exchange


def _whole_blocks():
    """Every halo matvec built inside exchanges whole neighbour blocks
    (``_whole_block_exchanger``) in place of the spans its shard reads."""
    from . import dist_swell

    return _patched(*((mod, "halo_exchanger", _whole_block_exchanger)
                      for mod in (sys.modules[__package__ + ".dist_spmv"], dist_swell)))


def _spans_against_whole_blocks(csr, xs) -> dict:
    """Both halo matvecs on each of ``xs`` in turn, built as the program
    builds them (each shard receives only the spans it reads, into one kept
    window) and under ``_whole_blocks``: ``dist_swell_spmv_fn`` (``span``,
    ``whole``) and ``dist_spmv_halo_fn`` in the square partition's padded
    coordinates, as ``dist_cg_solve`` runs it (``gather_span``,
    ``gather_whole``).  Of each, per call: y in global rows (``y``), the
    point-to-point ops issued (``ops``) and the elements they moved
    (``elems``); with the swell plan's spans, and how many windows its span
    exchanger returned over the calls."""
    from .dist_spmv import (dist_spmv_halo_fn, halo_exchanger, make_mesh, mesh_device,
                            shard_partitioned)
    from .dist_swell import build_dist_swell, dist_swell_spmv_fn, pad_global
    from .partition import pad_vector, partition_rows, unpad_vector

    mesh = make_mesh(dist.get_world_size())
    dsp = build_dist_swell(csr, mesh.size(), halo=True, mesh=mesh)
    part = shard_partitioned(partition_rows(csr, mesh.size(), balance=False), mesh)
    d, L, lr, dev = dist.get_rank(), dsp.rows_local, part.local_rows, mesh_device(mesh)
    xs = [torch.as_tensor(x) for x in xs]
    swell = ([pad_global(dsp, x.to(dev))[d * L: (d + 1) * L].contiguous() for x in xs],
             lambda y: gather_padded(y, mesh)[: csr.rows])
    gather = ([pad_vector(part, x)[d * lr: (d + 1) * lr].to(dev) for x in xs],
              lambda y: unpad_vector(part, gather_padded(y, mesh)))

    def gather_matvec():
        run, _ = dist_spmv_halo_fn(mesh, part, padded=True)
        return functools.partial(run, part.values, part.col_idx_padded, part.row_ids)

    runs = {}
    for name, build, io in (("", lambda: dist_swell_spmv_fn(dsp, mesh), swell),
                            ("gather_", gather_matvec, gather)):
        runs[name + "span"] = build(), io
        with _whole_blocks():
            runs[name + "whole"] = build(), io
    out = {"spans": dsp.halo_spans}
    for name, (matvec, (x_locals, unpad)) in runs.items():
        rec = out[name] = {"y": [], "ops": [], "elems": []}
        for x_local in x_locals:
            with _counted_p2p() as calls:
                y = matvec(x_local)
            rec["y"].append(unpad(y).cpu().numpy())
            rec["ops"].append(sum(n for n, _ in calls))
            rec["elems"].append(sum(e for _, e in calls))
    exchange = halo_exchanger(mesh, dsp.halo_spans, L, dsp.dtype)
    out["windows"] = len({exchange(x).data_ptr() for x in swell[0]})
    return out


def _span_solve_against_whole_blocks(csr, b, tol, max_iters) -> dict:
    """``dist_swell_cg_solve`` (the span exchange), then a fresh one built
    under ``_whole_blocks`` on the same matrix: x in global rows and the
    iterations of each."""
    from ..models import cg
    from .dist_spmv import make_mesh
    from .dist_swell import dist_swell_cg_solve

    mesh = make_mesh(dist.get_world_size())
    res = []
    for whole in (False, True):
        cg.clear_dist_solver_cache()
        with _whole_blocks() if whole else contextlib.nullcontext():
            res.append(dist_swell_cg_solve(csr, torch.from_numpy(b), mesh, tol=tol,
                                           max_iters=max_iters)[0])
    cg.clear_dist_solver_cache()  # the graphs hold NCCL collectives: freed before the group goes
    xs = [gather_padded(r.x, mesh)[: csr.rows].cpu().numpy() for r in res]
    return {"x": xs[0], "iters": res[0].iters, "whole_x": xs[1], "whole_iters": res[1].iters}


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
                with _patched((torch.Tensor, "item", refuse), (torch.Tensor, "__bool__", refuse)):
                    _masked_step(matvec, M, red, tol2, max_iters, carry)
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
    - ``swell_spans``: ``csr`` (its halo window must hold), ``xs`` (a list of
      x), ``env``: ``_spans_against_whole_blocks``;
    - ``swell_cg_spans``: ``csr``, ``b``, ``tol``, ``max_iters``,
      ``eager_iters``: ``_span_solve_against_whole_blocks``;
    - ``cg_kept``: ``csr``, ``bs`` (a list of b), ``tol``, ``max_iters``,
      ``eager_iters``, ``solver`` (``"dist_swell_cg_solve"`` or
      ``"dist_cg_solve"``): ``_kept_solves`` (the kept solver, then fresh
      ones);
    - ``shutdown`` (last: it leaves the group): the distributed solvers kept
      before and after ``multihost.shutdown_distributed``, and whether a
      group is still joined;
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
    from ..models import cg

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
            with _patched((cg, "CG_EAGER_ITERS", case.get("eager_iters"))), \
                    _counted_all_reduces(case.get("count_reduces")) as counts:
                res = cg.dist_cg_solve(part, pad_vector(part, case["b"]), mesh, tol=case["tol"],
                                       max_iters=case["max_iters"])
            x = unpad_vector(part, gather_padded(res.x, mesh)).cpu().numpy()
            out.append((x, res.iters) + (() if counts is None else (counts,)))
        elif kind == "swell":
            mesh = make_mesh(world)
            with mock.patch.dict(os.environ, case.get("env") or {}):
                dsp = build_dist_swell(csr, world, halo=case.get("halo"), mesh=mesh)
            run = dist_swell_spmv_fn(dsp, mesh, halo=case.get("halo"))
            d, L = dist.get_rank(), dsp.rows_local
            xp = pad_global(dsp, torch.from_numpy(case["x"]))
            y = gather_padded(run(xp[d * L: (d + 1) * L].contiguous()), mesh)
            out.append((y[: csr.rows].cpu().numpy(), dsp.halo_ok, dsp.tail_nnz))
        elif kind == "swell_cg":
            mesh = make_mesh(world)
            with _patched((cg, "CG_EAGER_ITERS", case.get("eager_iters"))), \
                    _counted_all_reduces(case.get("count_reduces")) as counts:
                res, _ = dist_swell_cg_solve(csr, torch.from_numpy(case["b"]), mesh,
                                             tol=case["tol"], max_iters=case["max_iters"])
            x = gather_padded(res.x, mesh)[: csr.rows].cpu().numpy()
            out.append((x, res.iters) + (() if counts is None else (counts,)))
        elif kind == "swell_spans":
            with mock.patch.dict(os.environ, case.get("env") or {}):
                out.append(_spans_against_whole_blocks(csr, case["xs"]))
        elif kind == "swell_cg_spans":
            with _patched((cg, "CG_EAGER_ITERS", case.get("eager_iters"))):
                out.append(_span_solve_against_whole_blocks(csr, case["b"], case["tol"],
                                                            case["max_iters"]))
        elif kind == "cg_kept":
            with _patched((cg, "CG_EAGER_ITERS", case.get("eager_iters"))):
                out.append(_kept_solves(csr, case["bs"], case["tol"], case["max_iters"],
                                        case["solver"]))
        elif kind == "shutdown":
            from .multihost import shutdown_distributed

            before = cg.dist_solvers_kept()
            shutdown_distributed()
            out.append((before, cg.dist_solvers_kept(), dist.is_initialized()))
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
