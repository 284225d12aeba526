"""HPCG's multigrid preconditioner (``models/mg.py``) against the benchmark's
plain reference (``perfbench/matrices/hpcg27mg.py``), which works the V-cycle
out on the grids: natural-order Gauss-Seidel hyperplane by hyperplane, from
HPCG's formula with a_ii = 26 and a_ij = -1, never from the CSR arrays.

On seeded data, over grids 16^3 (4 levels), 16x8x24 (4 levels) and 8^3 (2
levels): one SymGS step (from x = 0, which skips U x, and from a given x),
one V-cycle, and 50 MG-preconditioned CG iterations through ``cg_solve`` at
tol 0, within 1e-12 of the reference; the injection maps and the coarse
operators against HPCG's own loops (``GenerateCoarseProblem``,
``GenerateProblem``); M's symmetry; the counters; the argument checks.  On
the card (``-m cuda``; the file imports nothing of JAX, so ``--noconftest``
runs it there) the same V-cycle against its plain version on a CPU copy and
against the reference, at 16^3 and at 72^3, each level's F-3 plans in the
form their shape gives them."""

import itertools

import numpy as np
import pytest
import torch

from perfbench import inputs, reference
from perfbench.matrices import hpcg27mg
from spmv_acc_tpu_torch import CSR, mg_preconditioner
from spmv_acc_tpu_torch.models.cg import cg_solve
from spmv_acc_tpu_torch.ops import trisolve as tri
from spmv_acc_tpu_torch.utils import profiling

GRIDS = [((16, 16, 16), 4), ((16, 8, 24), 4), ((8, 8, 8), 2)]
SEED = 2 ** 33 + 17
TOL = 1e-12


def _cfg(dims, levels):
    return dict(zip(("nx", "ny", "nz"), dims), mg_levels=levels)


def _hierarchy(cfg, device="cpu"):
    cfgs = hpcg27mg.coarse_cfgs(cfg)
    levels = [CSR.from_numpy(*hpcg27mg.build(c), device=device) for c in cfgs]
    return levels, [torch.from_numpy(hpcg27mg.f2c(c)) for c in cfgs[:-1]]


def _gap(a, b):
    return float((a.cpu() - b.cpu()).abs().max() / b.abs().max())


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: "x".join(map(str, g[0])))
def case(request):
    dims, levels = request.param
    cfg = _cfg(dims, levels)
    csrs, f2c = _hierarchy(cfg)
    return cfg, csrs, mg_preconditioner(csrs, f2c), hpcg27mg.MGSymGS(cfg, levels, "cpu")


def _vector(n, i):
    return inputs.Draw("cpu").vector(SEED, i, n)


def test_symgs_step(case):
    cfg, csrs, M, ref = case
    lv, g = M.levels[0], ref.grids[0]
    r, x0 = _vector(lv.plan_dl.m, 0), _vector(lv.plan_dl.m, 1)
    for x in (None, x0):
        xp = torch.zeros(g.padded, dtype=torch.float64)
        if x is not None:
            xp[g.interior] = x
        ref._symgs(g, r, xp)
        mine = M._symgs(lv, r, None if x is None else x.clone())
        assert _gap(mine, xp[g.interior]) <= TOL


def test_vcycle(case):
    cfg, csrs, M, ref = case
    r = _vector(csrs[0].rows, 2)
    assert _gap(M(r), ref(r)) <= TOL


def test_cg_50_iterations(case):
    cfg, csrs, M, ref = case
    b = _vector(csrs[0].rows, 3)
    res = cg_solve(csrs[0], b, tol=0.0, max_iters=50, strategy="swell", precond=M)
    x_ref, it = reference.pcg(hpcg27mg.Operator(cfg, None, "cpu"), ref, b, 0.0, 50)
    assert res.iters == it == 50
    assert _gap(res.x, x_ref) <= TOL


def test_injection_and_coarse_operators(case):
    """``f2c`` by GenerateCoarseProblem's loop, each coarse operator by
    GenerateProblem's: 26 on the diagonal, -1 to every neighbour inside the
    grid, columns ascending."""
    cfg, csrs, M, ref = case
    cfgs = hpcg27mg.coarse_cfgs(cfg)
    assert len(cfgs) == len(csrs) == cfg["mg_levels"]
    for k, c in enumerate(cfgs):
        nx, ny, nz = c["nx"], c["ny"], c["nz"]
        assert (nx, ny, nz) == tuple(d >> k for d in (cfg["nx"], cfg["ny"], cfg["nz"]))
        if k + 1 < len(cfgs):
            want = [2 * izc * nx * ny + 2 * iyc * nx + 2 * ixc
                    for izc in range(nz // 2) for iyc in range(ny // 2) for ixc in range(nx // 2)]
            assert hpcg27mg.f2c(c).tolist() == want
            assert M.levels[k].f2c.tolist() == want
        rp, ci, v, _ = csrs[k].to_numpy()
        row = 0
        for iz, iy, ix in itertools.product(range(nz), range(ny), range(nx)):
            cols, vals = [], []
            for sz, sy, sx in itertools.product((-1, 0, 1), repeat=3):
                if 0 <= iz + sz < nz and 0 <= iy + sy < ny and 0 <= ix + sx < nx:
                    col = (iz + sz) * nx * ny + (iy + sy) * nx + ix + sx
                    cols.append(col)
                    vals.append(26.0 if col == row else -1.0)
            assert ci[rp[row]:rp[row + 1]].tolist() == cols
            assert v[rp[row]:rp[row + 1]].tolist() == vals
            row += 1
        assert row == csrs[k].rows


def test_symmetric(case):
    cfg, csrs, M, ref = case
    u, v = _vector(csrs[0].rows, 4), _vector(csrs[0].rows, 5)
    mv, mu = M(v), M(u)
    assert abs(float(u @ mv - v @ mu)) <= 1e-12 * float(u.norm() * mv.norm())


def test_counters(case):
    """One ``mg.vcycles`` an M(r); ``mg.tri_solves``: four a level with a
    coarser one and two on the coarsest; at tol 0 a 50-iteration solve
    applies M 51 times (the start's and one an iteration) and never
    captures."""
    cfg, csrs, M, ref = case
    per = 4 * (len(M.levels) - 1) + 2
    before = profiling.spans()
    M(_vector(csrs[0].rows, 6))
    got = profiling.since(before)
    assert got["mg.vcycles"].count == 1 and got["mg.tri_solves"].count == per
    assert got["mg.apply"].count == 1
    before = profiling.spans()
    res = cg_solve(csrs[0], _vector(csrs[0].rows, 7), tol=0.0, max_iters=50, strategy="swell",
                   precond=M)
    got = profiling.since(before)
    assert res.iters == 50
    assert got["mg.vcycles"].count == 51 and got["mg.tri_solves"].count == 51 * per
    assert "graphs.capture" not in got


def test_setup_span():
    cfg = _cfg((8, 8, 8), 2)
    before = profiling.spans()
    mg_preconditioner(*_hierarchy(cfg))
    got = profiling.since(before)
    assert got["mg.setup"].count == 1 and got["mg.setup"].self_seconds > 0


def test_argument_checks():
    cfg = _cfg((8, 8, 8), 2)
    levels, f2c = _hierarchy(cfg)
    with pytest.raises(ValueError, match="maps"):
        mg_preconditioner(levels, [])
    with pytest.raises(ValueError, match="injective"):
        mg_preconditioner(levels, [torch.zeros(64, dtype=torch.int64)])
    with pytest.raises(ValueError, match="outside"):
        mg_preconditioner(levels, [f2c[0] + 512])
    with pytest.raises(ValueError, match="integers"):
        mg_preconditioner(levels, [f2c[0][:10]])
    with pytest.raises(ValueError, match="at least one"):
        mg_preconditioner([], [])
    rect = CSR.from_numpy(np.array([0, 1, 2]), np.array([0, 1]), np.ones(2), (2, 3))
    with pytest.raises(ValueError, match="square"):
        mg_preconditioner([rect], [])
    no_diag = CSR.from_numpy(np.array([0, 1, 2]), np.array([1, 0]), np.ones(2), (2, 2))
    with pytest.raises(ValueError, match="diagonal"):
        tri.gauss_seidel_split(no_diag)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(16, 16, 16), (72, 72, 72)], ids=["16", "72"])
def test_vcycle_on_card(dims):
    """The V-cycle on the card (F-3's ``tri_levels`` and the sweep store)
    within 1e-12 of its plain version on a CPU copy of the hierarchy and of
    the reference on the card; 14 F-3 launches a V-cycle, each plan's in
    the form ``_walk_shape`` gives it;
    at 16^3 the 50-iteration solve against the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    cfg = _cfg(dims, 4)
    levels, f2c = _hierarchy(cfg)
    plain = mg_preconditioner(levels, f2c)
    on_card = [a.to(dev) for a in levels]
    card = mg_preconditioner(on_card, f2c)
    ref = hpcg27mg.MGSymGS(cfg, 4, dev)
    r = inputs.Draw(dev).vector(SEED, 0, levels[0].rows)
    tri.LAUNCHES.clear()
    got = card(r)
    torch.cuda.synchronize()
    launched = dict(tri.LAUNCHES)
    planned = {}
    for lv in card.levels:
        for plan in (lv.plan_dl, lv.plan_du):
            key = ("f64", "levels_" + tri._walk_shape(plan)[0])
            planned[key] = planned.get(key, 0) + (2 if lv.f2c is not None else 1)
    assert launched == planned and sum(launched.values()) == 14
    assert _gap(got, plain(r.cpu())) <= TOL
    assert _gap(got, ref(r)) <= TOL
    if dims == (16, 16, 16):
        res = cg_solve(on_card[0], r, tol=0.0, max_iters=50, strategy="swell", precond=card)
        x_ref, it = reference.pcg(hpcg27mg.Operator(cfg, None, dev), ref, r, 0.0, 50)
        assert res.iters == it == 50 and _gap(res.x, x_ref) <= TOL
