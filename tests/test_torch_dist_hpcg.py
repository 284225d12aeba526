"""HPCG's weak-scaling deployment in small: the 27-point operator on an
8x8x32 grid over four gloo ranks, one 8x8x8 z-slab a rank (2,048 rows; the
swell layout's 16 row blocks of 128 give K = 4 blocks and L = 512 rows a
shard, so each shard's columns lie in its own and its neighbours' x blocks
and the 1-hop halo exchange runs).

Both distributed solvers, ``dist_swell_cg_solve`` and ``dist_cg_solve`` (its
matvec the gather product over the square partition, the halo of spans
here), keep their solvers across calls: three seeded b solved in turn on one
mesh (the first builds, the others find it kept and run their blocks from the
first iteration), then each again on a fresh solver.  ``CG_EAGER_ITERS`` is 4
inside the ranks, so that the masked blocks run.  The kept solves are held
against the benchmark's plain reference (``perfbench/reference.py::pcg`` with
M = I on ``matrices/hpcg27.Operator``), against the fresh ones bit for bit,
and the swell solver's halo counter against the bytes each rank receives (one
plane from each neighbour); ``shutdown_distributed`` leaves no kept solver.
The cache they share (``models.cg.kept_solver``) is checked with fake solvers
in this process."""

import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import inputs, reference
from perfbench.matrices import hpcg27
from spmv_acc_tpu_torch.models import cg
from spmv_acc_tpu_torch.models.cg import CG_BLOCK
from spmv_acc_tpu_torch.parallel.launch import rank_cases, spawn
from spmv_acc_tpu_torch.utils import profiling

GRID = {"nx": 8, "ny": 8, "nz": 32}
D, L, M = 4, 512, 2048
PLANE = GRID["nx"] * GRID["ny"]  # the entries of a neighbour's block a slab reads
TOL, MAX_ITERS, EAGER = 1e-10, 500, 4
SEEDS = [2 ** 33 + 17, 5, 2 ** 31 + 12345]
SOLVERS = ["dist_swell_cg_solve", "dist_cg_solve"]
# x_gap = max|x - x_ref| / max|x_ref| is the cell's own limit, 1e-10: the
# program and the reference run the same algorithm and stop rule in float64,
# and differ only in the order of each dot's sum (four ranks' partial sums
# all-reduced by gloo against one torch.dot), which rounding amplifies by far
# less; in float32 the reference lands ~1e-6 away (PERF.md's control readings)
X_GAP = 1e-10


def _b(seed):
    return inputs.Draw("cpu").vector(seed, 0, M).numpy()


_RESULTS = {}


def _results():
    """Every rank's results of one spawn of four gloo ranks."""
    if not _RESULTS:
        csr = hpcg27.build(GRID)
        cases = [dict(kind="cg_kept", csr=csr, bs=[_b(s) for s in SEEDS], tol=TOL,
                      max_iters=MAX_ITERS, eager_iters=EAGER, solver=solver)
                 for solver in SOLVERS] + [dict(kind="shutdown")]
        _RESULTS["ranks"] = spawn(rank_cases, D, "cpu", cases)
    return _RESULTS["ranks"]


def _kept(solver="dist_swell_cg_solve"):
    return [r[SOLVERS.index(solver)] for r in _results()]


@pytest.mark.parametrize("solver", SOLVERS)
def test_each_rank_holds_one_slab_and_the_halo_runs(solver):
    for res in _kept(solver):
        assert res["halo_ok"] and res["rows_local"] == L == GRID["nx"] * GRID["ny"] * 8


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_kept_solve_matches_the_reference(i, solver):
    op = hpcg27.Operator(GRID, None, "cpu")
    b = torch.from_numpy(_b(SEEDS[i]))
    x_ref, it_ref = reference.pcg(op, lambda r: r, b, TOL, MAX_ITERS)
    for res in _kept(solver):
        got = res["kept"][i]
        # gloo's all-reduce sums the dots in another order than one torch.dot
        assert abs(got["iters"] - it_ref) <= 1 and 0 < got["iters"] < MAX_ITERS
        gap = float(np.abs(got["x"] - x_ref.numpy()).max() / x_ref.abs().max())
        assert gap <= X_GAP, gap
        assert reference.relative_residual(op, torch.from_numpy(got["x"]), b) <= TOL


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_kept_solver_equals_a_fresh_one_bit_for_bit(i, solver):
    """The first call builds and runs the plain start; the second and third
    find the solver kept and run blocks from the first iteration.  Masked
    iterations past convergence change nothing, so x and the iterations are
    a fresh solver's."""
    for res in _kept(solver):
        kept, fresh = res["kept"][i], res["fresh"][i]
        assert kept["dist.solvers.built"] == (i == 0) and kept["dist.solvers.hit"] == (i > 0)
        assert kept["eager"] == (i == 0) and fresh["eager"]
        assert fresh["dist.solvers.built"] == 1 and fresh["dist.solvers.hit"] == 0
        assert kept["iters"] == fresh["iters"]
        assert kept["x"].tobytes() == fresh["x"].tobytes()


def _matvecs(iters, eager):
    """Matvecs a solve runs: the start's one, the plain iterations, then whole
    blocks of CG_BLOCK (masked ones included) until the stop test fails."""
    plain = min(iters, eager)
    return 1 + plain + CG_BLOCK * math.ceil((iters - plain) / CG_BLOCK)


@pytest.mark.parametrize("rank", range(D))
def test_halo_bytes_are_the_neighbour_blocks_received(rank):
    """What the halo exchange receives of the neighbour blocks a matvec: the
    spans the slab reads, one nx*ny plane of float64 from each neighbour."""
    res = _kept()[rank]
    neighbours = 1 if rank in (0, D - 1) else 2
    for i, (kept, fresh) in enumerate(zip(res["kept"], res["fresh"])):
        for got, eager in ((kept, EAGER if i == 0 else 0), (fresh, EAGER)):
            want = _matvecs(got["iters"], eager) * neighbours * PLANE * 8
            assert got["dist.halo_bytes"] == want


def test_shutdown_drops_every_kept_solver():
    for r in _results():
        kept, after, joined = r[len(SOLVERS)]
        assert kept == 1 and after == 0 and not joined


def test_kept_dist_solvers_share_the_bound_and_clear_alone(monkeypatch):
    """Distributed solvers are kept in ``cg_solve``'s cache under its one
    bound, least recently used out, each entry holding the objects its key's
    ids were taken from and the mesh's group; a solver is out of the cache
    while it is lent (a second caller of its key builds its own) and kept
    again after; ``clear_dist_solver_cache`` drops the distributed ones and
    leaves ``cg_solve``'s.  The ranks' agreement is this process's own
    answer here."""
    monkeypatch.setattr(importlib.import_module("spmv_acc_tpu_torch.parallel.dist_spmv"),
                        "all_agree", lambda hit, mesh: hit)
    group = object()
    mesh = SimpleNamespace(get_group=lambda: group)
    objs = [object() for _ in range(cg.CG_SOLVERS + 2)]

    def solve(o, build=None, mesh=mesh):
        with cg.kept_solver((o,), ("spec",), build or (lambda: f"solver {id(o)}"),
                            mesh) as solver:
            return solver

    def counts(before):
        grown = profiling.since(before)
        return [int(grown[k].total) if k in grown else 0 for k in
                ("dist.solvers.built", "dist.solvers.hit", "cg.solvers.built", "cg.solvers.hit")]

    cg.clear_solver_cache()
    try:
        before = profiling.spans()
        for o in objs[:-1]:
            solve(o)
        solve(objs[-1], mesh=None)
        assert counts(before) == [len(objs) - 1, 0, 1, 0]
        assert [held for held, _ in cg._SOLVERS.values()] == (
            [(o, group) for o in objs[-cg.CG_SOLVERS:-1]] + [(objs[-1],)])
        assert cg.dist_solvers_kept() == cg.CG_SOLVERS - 1
        before = profiling.spans()
        with cg.kept_solver((objs[-2],), ("spec",), lambda: "unused", mesh) as lent:
            assert lent == f"solver {id(objs[-2])}"
            assert solve(objs[-2], lambda: "its own") == "its own"  # lent out: built anew
        assert solve(objs[-2]) == f"solver {id(objs[-2])}"  # kept again after the block
        assert solve(objs[0]) == f"solver {id(objs[0])}"  # dropped past the bound: built
        assert counts(before) == [2, 2, 0, 0]
        cg.clear_dist_solver_cache()
        assert [held for held, _ in cg._SOLVERS.values()] == [(objs[-1],)]
        assert cg.dist_solvers_kept() == 0
    finally:
        cg.clear_solver_cache()
    assert not cg._SOLVERS


def test_blocks_report_every_matvec_they_run():
    """``CGBlocks``' ``on_matvecs`` on one device: the start, the plain
    iterations and each block, masked iterations included."""
    op = hpcg27.Operator({"nx": 6, "ny": 5, "nz": 4}, None, "cpu")
    calls, seen = [], []

    def matvec(v):
        calls.append(1)
        return op(v)

    b = inputs.Draw("cpu").vector(7, 0, op.shape[0])
    blocks = cg.CGBlocks(matvec, None, b, eager_iters=3, on_matvecs=seen.append)
    res = blocks.solve(b, torch.zeros_like(b), 1e-10, 200)
    assert seen[:2] == [1, 3] and set(seen[2:]) == {CG_BLOCK}
    assert sum(seen) == len(calls) == _matvecs(res.iters, 3)
    seen.clear()
    calls.clear()
    res = blocks.solve(b, torch.zeros_like(b), 1e-10, 200)  # blocks from the first iteration
    assert seen[0] == 1 and sum(seen) == len(calls) == _matvecs(res.iters, 0)
