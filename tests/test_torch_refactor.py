"""New values on one pattern: ``replace_values`` (``formats/containers.py``)
and ``ILU0.refactor`` (``ops/trisolve.py``, with the swell layouts' value
maps of ``ops/swell.py``), against fresh objects made from those values.

On the CPU: after ``replace_values`` and ``refactor`` every value tensor of
an ILU(0) handle equals a fresh ``ilu0`` of a fresh CSR bit for bit (exact,
gather-sweep and swell-sweep handles; a 27-point grid with a coefficient
field, anisotropic diffusion, a random SPD matrix), and a kept ``cg_solve``
gives a fresh solver's bits without building one; ``spmv`` by every
strategy answers for the new values; what cannot be refreshed is dropped;
the argument checks; the layouts' value maps on BSR and COO-tail layouts;
a scalar emulation of F-4's walk (``csrc/trisolve.cu``, ``ilu0_refactor``)
gives ``ilu0_host``'s bits in any order its flags and warps allow; the
benchmark's reference (``perfbench/matrices/hpcg27vc.py``) against the
port's host factor and, at c = 1, against ``hpcg27``.

On the card (``-m cuda``; the file imports nothing of JAX, so
``--noconftest`` runs it there): F-4 bit for bit ``ilu0_host`` on HPCG's
104^3 grid with a coefficient field, aniso 512^2, af23560-SPD and
dw4096-SPD; the same from a captured graph's replays; three refactors under
one kept solver with no new capture."""

import numpy as np
import pytest
import torch

from perfbench.matrices import hpcg27, hpcg27vc
from spmv_acc_tpu_torch import CSR, replace_values, spmv
from spmv_acc_tpu_torch.cli.solve import spdize
from spmv_acc_tpu_torch.dispatch import STRATEGIES, clear_caches
from spmv_acc_tpu_torch.formats.generate import (aniso_laplacian_csr, banded_csr, example_like,
                                                 random_csr)
from spmv_acc_tpu_torch.models.cg import cg_solve
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.ops import trisolve as tri
from spmv_acc_tpu_torch.utils import profiling

GRID = {"nx": 10, "ny": 9, "nz": 8}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _field(cfg, seed):
    m = cfg["nx"] * cfg["ny"] * cfg["nz"]
    u = np.random.default_rng(seed).uniform(-1.0, 1.0, m)
    return torch.from_numpy(1.0 + 0.5 * u)


def _spd(m, seed):
    rp, ci, v, _ = banded_csr(m, bandwidth=5, seed=seed).to_numpy()
    return spdize(rp.astype(np.int64), ci.astype(np.int64), v, m) + ((m, m),)


def _scaled(arrays, seed):
    """New values on the pattern: D A D with a positive diagonal D drawn from
    the seed (symmetric and SPD where A is)."""
    rp, ci, v, shape = arrays
    d = np.random.default_rng(seed).uniform(0.5, 1.5, shape[0])
    rows = np.repeat(np.arange(shape[0]), np.diff(np.asarray(rp, dtype=np.int64)))
    return v * d[rows] * d[np.asarray(ci, dtype=np.int64)]


# name -> (the first arrays, values for seed s on the same pattern)
SYSTEMS = {
    "hpcg_vc": (lambda: hpcg27vc.build(GRID, _field(GRID, 1)),
                lambda a, s: hpcg27vc.build(GRID, _field(GRID, s))[2]),
    "aniso": (lambda: aniso_laplacian_csr(24, 24).to_numpy(), _scaled),
    "spd": (lambda: _spd(300, 33), _scaled),
}
FORMS = {"exact": (0, None), "sweeps": (3, 10 ** 9), "swell": (3, 0)}


def _handle(arrays, form, monkeypatch):
    sweeps, swell_min = FORMS[form]
    if swell_min is not None:
        monkeypatch.setattr(tri, "ILU_SWELL_MIN", swell_min)
    csr = CSR.from_numpy(*arrays)
    return csr, tri.ilu0(csr, sweeps=sweeps)


def _tensors(ilu):
    """Every value tensor an ILU(0) handle holds, by name."""
    out = {"l.dep_vals": ilu.l_plan.dep_vals, "l.diag": ilu.l_plan.diag,
           "u.dep_vals": ilu.u_plan.dep_vals, "u.diag": ilu.u_plan.diag}
    for side, plan in (("l", ilu.l_plan), ("u", ilu.u_plan)):
        out[f"{side}.f32"] = torch.cat(plan.values(torch.float32))
    if ilu.swell is not None:
        for side, lay in (("l", ilu.swell.layout_l), ("u", ilu.swell.layout_u)):
            out[f"{side}.cells"] = lay.vals
            out[f"{side}.tail"] = lay.tail_v
        out["inv_diag"] = ilu.swell.inv_diag
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_refactor_equals_a_fresh_factor(name, form, monkeypatch):
    """Two rounds of replace_values and refactor: every value tensor of the
    handle (kept in place) equals a fresh ilu0 of a fresh CSR, bit for bit;
    the f32 casts made before are refreshed; the host factor is counted."""
    first, values = SYSTEMS[name]
    arrays = first()
    csr, ilu = _handle(arrays, form, monkeypatch)
    assert (ilu.swell is not None) == (form == "swell")
    before = _tensors(ilu)
    ptrs = {k: t.data_ptr() for k, t in before.items() if not k.endswith("f32")}
    host = profiling.spans().get("ilu.refactor.host")
    for seed in (7, 8):
        v = values(arrays, seed)
        replace_values(csr, torch.from_numpy(v))
        ilu.refactor(csr)
        fresh = tri.ilu0(CSR.from_numpy(arrays[0], arrays[1], v, arrays[3]),
                         sweeps=FORMS[form][0])
        got, want = _tensors(ilu), _tensors(fresh)
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
    assert {k: t.data_ptr() for k, t in _tensors(ilu).items() if k in ptrs} == ptrs
    assert profiling.spans()["ilu.refactor.host"].count - (host.count if host else 0) == 2


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", ["aniso", "hpcg_vc"])
def test_kept_solver_after_new_values(name, form, monkeypatch):
    """A kept cg_solve after replace_values and refactor is hit, not built,
    and gives a fresh solver's bits (a fresh CSR and a fresh ilu0)."""
    first, values = SYSTEMS[name]
    arrays = first()
    csr, ilu = _handle(arrays, form, monkeypatch)
    b = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, csr.rows))
    cg_solve(csr, b, tol=1e-10, max_iters=500, strategy="swell", precond=ilu)
    v = values(arrays, 9)
    replace_values(csr, torch.from_numpy(v))
    ilu.refactor(csr)
    t0 = profiling.spans()
    got = cg_solve(csr, b, tol=1e-10, max_iters=500, strategy="swell", precond=ilu)
    t1 = profiling.spans()
    assert _delta(t0, t1, "cg.solvers.hit") == 1 and _delta(t0, t1, "cg.solvers.built") == 0
    fresh_csr = CSR.from_numpy(arrays[0], arrays[1], v, arrays[3])
    fresh = tri.ilu0(fresh_csr, sweeps=FORMS[form][0])
    want = cg_solve(fresh_csr, b, tol=1e-10, max_iters=500, strategy="swell", precond=fresh)
    assert got.iters == want.iters > 0 and torch.equal(got.x, want.x)


def _square(seed=5):
    return random_csr(300, 300, 4000, seed=seed).to_numpy()


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_spmv_answers_for_new_values(strategy):
    """spmv by every strategy, its caches filled before, answers after
    replace_values as on a fresh CSR of the new values, bit for bit."""
    rp, ci, v, shape = _square()
    csr = CSR.from_numpy(rp, ci, v, shape)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, shape[1]))
    y = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, shape[0]))
    spmv(csr, x, y, 1.0, 0.5, strategy=strategy)
    v2 = np.random.default_rng(4).uniform(-2, 2, len(v))
    replace_values(csr, torch.from_numpy(v2))
    got = spmv(csr, x, y, 1.0, 0.5, strategy=strategy)
    want = spmv(CSR.from_numpy(rp, ci, v2, shape), x, y, 1.0, 0.5, strategy=strategy)
    assert torch.equal(got, want)


def test_what_cannot_be_refreshed_is_dropped():
    """The transpose, ELL slab, tile layout and packs made from the old values
    go, and a kept solver on another matvec than swell with them; a kept
    swell solver stays.  ``csr.revalue.dropped`` counts them; the swell
    layout is refreshed in place (``swell.revalues``)."""
    from spmv_acc_tpu_torch import dispatch
    from spmv_acc_tpu_torch.models import cg
    from spmv_acc_tpu_torch.ops import adaptive_plus, zoo

    rp, ci, v, shape = aniso_laplacian_csr(12, 12).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    x = torch.ones(shape[0], dtype=torch.float64)
    for strategy in ("ell", "adaptive_plus", "light", "swell"):
        spmv(csr, x, strategy=strategy)
    spmv(csr, x, trans="T", strategy="default")
    for strategy in ("swell", "flat"):
        cg_solve(csr, x, tol=1e-8, max_iters=50, strategy=strategy)
    layout = swell.get_swell_plan(csr)
    caches = (dispatch._T_CACHE, dispatch._ELL_CACHE, adaptive_plus._TILE_CACHE,
              zoo._PACK_CACHE)
    held = [len(c) for c in caches]
    assert all(held) and len(cg._SOLVERS) == 2
    t0 = profiling.spans()
    replace_values(csr, torch.from_numpy(2.0 * v))
    t1 = profiling.spans()
    assert [len(c) for c in caches] == [0, 0, 0, 0]
    assert [k[5] for k in cg._SOLVERS] == ["swell"]
    assert _delta(t0, t1, "csr.revalue.dropped", "total") == sum(held) + 1
    assert _delta(t0, t1, "swell.revalues") == 1
    assert swell.get_swell_plan(csr) is layout
    fresh = swell.get_swell_plan(CSR.from_numpy(rp, ci, 2.0 * v, shape))
    assert torch.equal(layout.vals, fresh.vals)


def test_a_swell_solver_off_the_plan_cache_is_dropped():
    """A kept swell solver whose layout has left the plan cache holds the old
    values (``replace_values`` refreshes only cached layouts), so it goes;
    the next solve builds one that answers for the new values."""
    rp, ci, v, shape = aniso_laplacian_csr(12, 12).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    b = torch.ones(shape[0], dtype=torch.float64)
    cg_solve(csr, b, tol=1e-10, max_iters=200, strategy="swell")
    swell.clear_swell_cache()
    t0 = profiling.spans()
    replace_values(csr, torch.from_numpy(2.0 * v))
    got = cg_solve(csr, b, tol=1e-10, max_iters=200, strategy="swell")
    t1 = profiling.spans()
    assert _delta(t0, t1, "csr.revalue.dropped", "total") == 1
    assert _delta(t0, t1, "cg.solvers.built") == 1
    want = cg_solve(CSR.from_numpy(rp, ci, 2.0 * v, shape), b, tol=1e-10, max_iters=200,
                    strategy="swell")
    assert torch.equal(got.x, want.x) and got.iters == want.iters


def test_a_distributed_solver_is_rebuilt_for_new_values(tmp_path):
    """``dist_swell_cg_solve`` keeps its solver on the CSR's arrays over a
    shard copied from the old values: ``replace_values`` (called by every
    rank) drops it, so the next solve, on a one-rank gloo mesh, equals a
    solve on a fresh CSR of the new values."""
    import torch.distributed as dist

    from spmv_acc_tpu_torch.models.cg import clear_dist_solver_cache
    from spmv_acc_tpu_torch.parallel.dist_spmv import make_mesh
    from spmv_acc_tpu_torch.parallel.dist_swell import dist_swell_cg_solve
    from spmv_acc_tpu_torch.parallel.multihost import init_distributed

    rp, ci, v, shape = aniso_laplacian_csr(12, 12).to_numpy()
    v2 = _scaled((rp, ci, v, shape), 5)
    b = torch.from_numpy(np.random.default_rng(3).uniform(-1.0, 1.0, shape[0]))
    init_distributed(coordinator_address="file://" + str(tmp_path / "rendezvous"),
                     num_processes=1, process_id=0, device="cpu")
    try:
        mesh = make_mesh(1)
        csr = CSR.from_numpy(rp, ci, v, shape)
        dist_swell_cg_solve(csr, b, mesh, tol=1e-10, max_iters=300)
        t0 = profiling.spans()
        replace_values(csr, torch.from_numpy(v2))
        got, _ = dist_swell_cg_solve(csr, b, mesh, tol=1e-10, max_iters=300)
        t1 = profiling.spans()
        want, _ = dist_swell_cg_solve(CSR.from_numpy(rp, ci, v2, shape), b, mesh, tol=1e-10,
                                      max_iters=300)
    finally:
        clear_dist_solver_cache()
        dist.destroy_process_group()
    assert _delta(t0, t1, "dist.solvers.built") == 1 and _delta(t0, t1, "dist.solvers.hit") == 0
    assert torch.equal(got.x, want.x) and got.iters == want.iters


def _delta(t0, t1, name, field="count"):
    """How much ``name``'s ``field`` grew between two span tables."""
    return sum(getattr(t[name], field) * sign for t, sign in ((t1, 1), (t0, -1)) if name in t)


def test_a_raw_edit_is_not_seen():
    """An edit of csr.values made in place without replace_values leaves the
    cached layout as it was (the documented divergence); replace_values with
    the same tensor then makes it seen."""
    rp, ci, v, shape = aniso_laplacian_csr(12, 12).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    x = torch.ones(shape[0], dtype=torch.float64)
    before = spmv(csr, x, strategy="swell")
    csr.values.mul_(3.0)
    assert torch.equal(spmv(csr, x, strategy="swell"), before)
    replace_values(csr, csr.values)
    assert torch.equal(spmv(csr, x, strategy="swell"),
                       spmv(CSR.from_numpy(rp, ci, 3.0 * v, shape), x, strategy="swell"))


def _bad_calls():
    """case -> (a call, the error it raises)."""
    rp, ci, v, shape = aniso_laplacian_csr(8, 8).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    ilu = tri.ilu0(csr, sweeps=0)
    other = CSR.from_numpy(*aniso_laplacian_csr(8, 9).to_numpy())
    t = torch.from_numpy(v)
    moved = ci.copy()
    moved[1] += 1  # row 0's neighbour (0, 1) moved to (0, 2): the same size, another pattern
    return {
        "short": (lambda: replace_values(csr, t[:-1]), ValueError),
        "dtype": (lambda: replace_values(csr, t.float()), ValueError),
        "device": (lambda: replace_values(csr, t.to("meta")), ValueError),
        "not_a_tensor": (lambda: replace_values(csr, list(v)), TypeError),
        "refactor_pattern": (lambda: ilu.refactor(other), ValueError),
        "refactor_same_size": (lambda: ilu.refactor(CSR.from_numpy(rp, moved, v, shape)),
                               ValueError),
        "refactor_no_pattern": (lambda: tri.ILU0(ilu.l_plan, ilu.u_plan).refactor(csr),
                                ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_argument_checks(case):
    call, error = _bad_calls()[case]
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("r,spill", [(1, None), (2, None), (3, None), (1, "3000")])
def test_value_map_places_every_value(r, spill, monkeypatch):
    """A layout's value map (BSR r x r cells, and a COO tail where the spill
    rule makes one: the second x chunk's 1,605 entries) puts new values where
    a fresh layout of them holds them; a pattern whose (row, column) repeats
    has none."""
    if spill is not None:
        monkeypatch.setenv("SPMV_TPU_SPILL", spill)
    rp, ci, v, shape = random_csr(700, 20000, 9000, seed=1).to_numpy()
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, shape), r=r)
    assert spill is None or layout.tail_v.numel() > 0
    v2 = np.random.default_rng(r).uniform(-1, 1, len(v))
    vmap = swell.value_map(layout, rp, ci, shape)
    swell.revalue(layout, torch.from_numpy(np.concatenate([[0.0], v2])), vmap)
    fresh = swell.get_swell_plan(CSR.from_numpy(rp, ci, v2, shape), r=r)
    assert torch.equal(layout.vals, fresh.vals) and torch.equal(layout.tail_v, fresh.tail_v)
    rep = np.array([0, 2, 3]), np.array([1, 1, 0]), (2, 2)
    assert swell.value_map(layout, rep[0], rep[1], rep[2]) is None


def _diag(rp, ci):
    rows = np.repeat(np.arange(len(rp) - 1), np.diff(rp))
    diag = np.zeros(len(rp) - 1, dtype=np.int64)
    diag[rows[ci == rows]] = np.flatnonzero(ci == rows)
    return diag


def _merged(rp, ci, diag):
    """ilu0_host's pairs (t, s) of each strict-lower entry q, by a merge of
    the two rows as the host pass makes it: q -> list."""
    out = {}
    for i in range(len(rp) - 1):
        for q in range(rp[i], diag[i]):
            k, pairs = ci[q], []
            t, s = q + 1, diag[ci[q]] + 1
            while t < rp[i + 1] and s < rp[k + 1]:
                if ci[t] == ci[s]:
                    pairs.append((t, s))
                    t, s = t + 1, s + 1
                elif ci[t] < ci[s]:
                    t += 1
                else:
                    s += 1
            out[q] = pairs
    return out


def _f4_walk(rp, ci, a, order, warps, seed, epoch):
    """F-4's walk as scalar Python floats: warp w takes the rows at positions
    w, w + warps, ... of ``order`` in turn, copying a row's values when it
    takes it.  At every step one warp, drawn from the seed, whose next
    strict-lower entry q's row k is flagged epoch + 1 divides lu[q] by row
    k's diagonal and makes q's listed updates (``_ikj_updates``), or, with
    none left, publishes its row.  lu starts NaN, so a read of a row before
    its flag shows; flags start at ``epoch``."""
    m = len(rp) - 1
    diag = _diag(rp, ci)
    ptr, ut, us = (x.numpy() for x in tri._ikj_updates(
        torch.from_numpy(rp), torch.from_numpy(ci), torch.from_numpy(diag), m))
    lu = np.full(len(a), np.nan)
    flag = np.full(m, epoch)
    want = epoch + 1
    done, nxt = [0] * warps, {}

    def row_of(w):
        p = w + done[w] * warps
        if p >= m:
            return None
        row = int(order[p])
        if row not in nxt:
            nxt[row] = int(rp[row])
            lu[rp[row]:rp[row + 1]] = a[rp[row]:rp[row + 1]]
        return row

    rng = np.random.default_rng(seed)
    while True:
        ready = [w for w in range(warps) if row_of(w) is not None and (
            nxt[row_of(w)] == diag[row_of(w)] or flag[ci[nxt[row_of(w)]]] == want)]
        if not ready:
            break
        w = ready[rng.integers(len(ready))]
        row = row_of(w)
        q = nxt[row]
        if q == diag[row]:
            flag[row] = want
            done[w] += 1
            continue
        lik = lu[q] / lu[diag[ci[q]]]
        for u in range(ptr[q], ptr[q + 1]):
            lu[ut[u]] = lu[ut[u]] - lik * lu[us[u]]
        lu[q] = lik
        nxt[row] = q + 1
    assert all(row_of(w) is None for w in range(warps)), "the walk deadlocked"
    return lu, flag


WALK_SYSTEMS = {
    "hpcg_vc": lambda: hpcg27vc.build({"nx": 6, "ny": 5, "nz": 4}, _field(
        {"nx": 6, "ny": 5, "nz": 4}, 2)),
    "aniso": lambda: aniso_laplacian_csr(10, 10).to_numpy(),
    "spd": lambda: _spd(80, 22),
    "random": lambda: _with_diagonal(random_csr(90, 90, 1200, seed=4)),
}


def _with_diagonal(csr):
    """``csr``'s pattern with a diagonal entry in every row, as arrays: 50 on
    the diagonal, values drawn on [-1, 1) off it."""
    rp, ci, v, shape = csr.to_numpy()
    rows = np.repeat(np.arange(shape[0]), np.diff(rp))
    keys = np.unique(np.concatenate([rows * shape[1] + ci, np.arange(shape[0]) * (shape[1] + 1)]))
    r, c = keys // shape[1], keys % shape[1]
    vals = np.where(r == c, 50.0, np.random.default_rng(0).uniform(-1, 1, len(keys)))
    out = np.zeros(shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=shape[0]), out=out[1:])
    return out, c, vals, shape


@pytest.mark.parametrize("name", sorted(WALK_SYSTEMS))
def test_symbolic_factor_is_the_host_merge(name, monkeypatch):
    """The symbolic factor F-4 reads (``_ikj_updates``, cut into chunks of 7
    candidates here) lists, for each strict-lower entry, the pairs the host
    pass's merge makes, in the same order, and nothing for other entries."""
    monkeypatch.setattr(tri, "_IKJ_CHUNK", 7)
    rp, ci, _, shape = WALK_SYSTEMS[name]()
    rp, ci = np.asarray(rp, dtype=np.int64), np.asarray(ci, dtype=np.int64)
    diag = _diag(rp, ci)
    ptr, ut, us = (x.numpy() for x in tri._ikj_updates(
        torch.from_numpy(rp), torch.from_numpy(ci), torch.from_numpy(diag), shape[1]))
    want = _merged(rp, ci, diag)
    assert ut.dtype == us.dtype == np.int32 and ptr[-1] == sum(map(len, want.values())) > 0
    for q in range(len(ci)):
        assert list(zip(ut[ptr[q]:ptr[q + 1]], us[ptr[q]:ptr[q + 1]])) == want.get(q, [])


@pytest.mark.parametrize("warps", [1, 3, 16])
@pytest.mark.parametrize("order", ["levels", "natural"])
@pytest.mark.parametrize("name", sorted(WALK_SYSTEMS))
def test_f4_walk_gives_the_host_bits(name, order, warps):
    """Rows finishing in any order their flags allow, in the L solve's level
    order (the card's) or in natural order, give ilu0_host's bits, from
    fresh flags and from the flags an earlier factor left."""
    rp, ci, v, shape = WALK_SYSTEMS[name]()
    rp, ci = np.asarray(rp, dtype=np.int64), np.asarray(ci, dtype=np.int64)
    want = tri.ilu0_host(rp, ci, v, shape)
    rows = (tri.analyze_trisolve(rp, ci, v, shape, lower=True, unit_diag=True)
            .rows_sorted.numpy() if order == "levels" else np.arange(shape[0]))
    lu, flag = _f4_walk(rp, ci, v, rows, warps, seed=warps, epoch=0)
    assert np.array_equal(lu, want) and (flag == 1).all()
    lu, flag = _f4_walk(rp, ci, v, rows, warps, seed=warps + 1, epoch=1)
    assert np.array_equal(lu, want) and (flag == 2).all()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_factor_is_the_host_factor(seed):
    """The benchmark's reference factors the field's operator on the grid
    (``ilu0_coeffs``) to ilu0_host's bits of its CSR (``build``), and its
    grid operator is the CSR's product."""
    c = _field(GRID, seed)
    rp, ci, v, shape = hpcg27vc.build(GRID, c)
    lu = tri.ilu0_host(rp, ci, v, shape)
    idx = hpcg27vc.entry_index(GRID)
    assert np.array_equal(hpcg27vc.ilu0_coeffs(GRID, c).reshape(-1)[idx], lu)
    x = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, shape[0]))
    y = spmv(CSR.from_numpy(rp, ci, v, shape), x, strategy="default")
    assert torch.allclose(hpcg27vc.Operator(GRID, None, "cpu", c=c)(x), y, rtol=0, atol=1e-12)


def test_reference_at_unit_field_is_hpcg():
    """c = 1 gives hpcg27's arrays, factor and operator exactly."""
    ones = torch.ones(GRID["nx"] * GRID["ny"] * GRID["nz"], dtype=torch.float64)
    for got, want in zip(hpcg27vc.build(GRID, ones), hpcg27.build(GRID)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(hpcg27vc.ilu0_coeffs(GRID), hpcg27.ilu0_coeffs(GRID))
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, len(ones)))
    assert torch.allclose(hpcg27vc.Operator(GRID, None, "cpu")(x),
                          hpcg27.Operator(GRID, None, "cpu")(x), rtol=0, atol=1e-12)
    assert torch.equal(hpcg27vc.Operator(GRID, None, "cpu").diagonal(),
                       hpcg27.Operator(GRID, None, "cpu").diagonal())


def test_refactor_takes_another_csr_of_the_pattern():
    """refactor accepts a CSR other than the one the handle was made from
    where its pattern is the same (compared on the device), and factors its
    values."""
    rp, ci, v, shape = aniso_laplacian_csr(16, 16).to_numpy()
    ilu = tri.ilu0(CSR.from_numpy(rp, ci, v, shape), sweeps=0)
    v2 = _scaled((rp, ci, v, shape), 3)
    ilu.refactor(CSR.from_numpy(rp, ci, v2, shape))
    fresh = tri.ilu0(CSR.from_numpy(rp, ci, v2, shape), sweeps=0)
    assert torch.equal(ilu.u_plan.dep_vals, fresh.u_plan.dep_vals)
    assert torch.equal(ilu.l_plan.dep_vals, fresh.l_plan.dep_vals)


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_system(name):
    """(arrays, values for seed s) of the card's systems at full size."""
    if name == "hpcg104":
        cfg = {"nx": 104, "ny": 104, "nz": 104}
        return (hpcg27vc.build(cfg, _field(cfg, 1)),
                lambda a, s: hpcg27vc.build(cfg, _field(cfg, s))[2])
    if name == "aniso512":
        return aniso_laplacian_csr(512, 512).to_numpy(), _scaled
    rp, ci, v, (m, _) = example_like(name.replace("-SPD", "")).to_numpy()
    return spdize(rp.astype(np.int64), ci.astype(np.int64), v, m) + ((m, m),), _scaled


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hpcg104", "aniso512", "af23560-SPD", "dw4096-SPD"])
def test_f4_equals_the_host_factor_on_card(card, name):
    """F-4 on the card, two rounds: every value tensor of the handle equals
    a fresh ilu0 (the host factor) of the new values bit for bit; one F-4
    launch a refactor, none on the host."""
    arrays, values = _card_system(name)
    csr = CSR.from_numpy(*arrays, device=card)
    ilu = tri.ilu0(csr, sweeps=3)
    host = profiling.spans().get("ilu.refactor.host")
    for seed in (5, 6):
        v = values(arrays, seed)
        launches = tri.LAUNCHES[("f64", "factor")]
        replace_values(csr, torch.from_numpy(v).to(card))
        ilu.refactor(csr)
        torch.cuda.synchronize()
        assert tri.LAUNCHES[("f64", "factor")] == launches + 1
        fresh = tri.ilu0(CSR.from_numpy(arrays[0], arrays[1], v, arrays[3], device=card),
                         sweeps=3)
        got, want = _tensors(ilu), _tensors(fresh)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, seed, k)
    assert profiling.spans().get("ilu.refactor.host") == host


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aniso512", "dw4096-SPD"])
def test_f4_in_a_captured_graph_on_card(card, name):
    """A captured refactor (F-4 and the value rewrites), replayed after each
    of three replace_values, leaves the fresh factor's bits each time: each
    replay's F-4 takes the next epoch."""
    arrays, values = _card_system(name)
    csr = CSR.from_numpy(*arrays, device=card)
    ilu = tri.ilu0(csr, sweeps=3)
    ilu.refactor(csr)  # the state, made outside the capture
    _tensors(ilu)  # and the f32 casts: a capture refreshes what the handle holds then
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ilu.refactor(csr)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ilu.refactor(csr)
    for seed in (11, 12, 13):
        v = values(arrays, seed)
        replace_values(csr, torch.from_numpy(v).to(card))
        graph.replay()
        torch.cuda.synchronize()
        fresh = tri.ilu0(CSR.from_numpy(arrays[0], arrays[1], v, arrays[3], device=card),
                         sweeps=3)
        got, want = _tensors(ilu), _tensors(fresh)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, seed, k)


@pytest.mark.cuda
def test_three_refactors_under_one_kept_solver_on_card(card):
    """The solver kept from the first solve is hit three times after new
    values and a refactor, captures nothing more, and gives a fresh
    solver's bits each time."""
    arrays, values = _card_system("aniso512")
    csr = CSR.from_numpy(*arrays, device=card)
    ilu = tri.ilu0(csr, sweeps=3)
    assert ilu.swell is not None
    b = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, csr.rows)).to(card)
    first = cg_solve(csr, b, tol=1e-8, max_iters=2000, strategy="swell", precond=ilu)
    assert first.iters > 64  # past the plain start: the first solve captured
    for seed in (21, 22, 23):
        v = values(arrays, seed)
        t0 = profiling.spans()
        replace_values(csr, torch.from_numpy(v).to(card))
        ilu.refactor(csr)
        got = cg_solve(csr, b, tol=1e-8, max_iters=2000, strategy="swell", precond=ilu)
        t1 = profiling.spans()
        assert _delta(t0, t1, "cg.solvers.hit") == 1
        assert _delta(t0, t1, "cg.solvers.built") == 0
        assert _delta(t0, t1, "graphs.capture") == 0
        fresh_csr = CSR.from_numpy(arrays[0], arrays[1], v, arrays[3], device=card)
        want = cg_solve(fresh_csr, b, tol=1e-8, max_iters=2000, strategy="swell",
                        precond=tri.ilu0(fresh_csr, sweeps=3))
        assert got.iters == want.iters and torch.equal(got.x, want.x)
