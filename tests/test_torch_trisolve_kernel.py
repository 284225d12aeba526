"""F-3's plan arrays and plain versions (``ops/trisolve.py``) on the CPU.

F-3 (``csrc/trisolve.cu``) walks ``level_ptr`` over ``rows_sorted`` and each
row's ``dep_start`` / ``dep_len`` range of the level-sorted dependencies.  Here:

* the walk visits the JAX package's ``rows_sorted`` order and dependency
  order, array for array (integers: equal);
* the renamed plain versions ``trisolve_plain`` / ``trisolve_sweeps_plain``
  stay within 1e-12 max|y| of the JAX package's solves (the same products in
  the same order; XLA's CPU scatter and PyTorch's ``index_add_`` may round
  the partial sums' adds at other places), past ``_EXACT_MAX_LEVELS`` too;
* a scalar emulation of the kernels' walk (each row's products summed in
  plan order from 0, every operation rounded in the vector's dtype) gives
  the plain versions' bits, in float64 and float32: the arithmetic the
  kernels are held to bit for bit on the card;
* CPU tensors run the plain version and never reach a launch, and the
  argument checks raise.

The kernels themselves run only on the card (``tests/test_torch_package.py
-m cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import banded_csr
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays, csr_to_dense
from spmv_acc_tpu.formats.generate import aniso_laplacian_csr
from spmv_acc_tpu.ops import trisolve as ref_tri
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import trisolve as tri


def spd(m, seed):
    """Symmetric, diagonally dominant banded matrix (``test_torch_trisolve``'s)."""
    rp, ci, v, shape = banded_csr(m, bandwidth=5, seed=seed).to_numpy()
    d = csr_to_dense(rp, ci, v, shape)
    d = 0.5 * (d + d.T)
    d += np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    return coo_to_csr_arrays(rr, cc, d[rr, cc], shape) + (shape,)


def triangular(m, seed, density):
    """A random lower triangle with a diagonal away from 0 (``test_torch_trisolve``'s)."""
    rng = np.random.default_rng(seed)
    d = np.tril(rng.random((m, m)) * (rng.random((m, m)) < density), k=-1) + np.diag(
        rng.random(m) + 1.0)
    rr, cc = np.nonzero(d)
    return coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m)) + ((m, m), d)


def bidiagonal(m, seed):
    """A lower bidiagonal factor: a chain, m levels of one row each."""
    rng = np.random.default_rng(seed)
    d = np.diag(rng.random(m) + 1.0) + np.diag(rng.standard_normal(m - 1), k=-1)
    rr, cc = np.nonzero(d)
    return rr, cc, d[rr, cc], (m, m)


def diagonal(m, seed):
    """A factor without dependencies: one level of m rows."""
    v = np.random.default_rng(seed).random(m) + 1.0
    return np.arange(m), np.arange(m), v, (m, m)


def _csr(coo):
    rr, cc, v, shape = coo
    return coo_to_csr_arrays(rr, cc, v, shape) + (shape,)


# test_torch_trisolve's MATRICES, and the edge cases of a factor
CASES = {
    "spd80": lambda: spd(80, 22),
    "spd300": lambda: spd(300, 33),
    "aniso16": lambda: aniso_laplacian_csr(16, 16).to_numpy(),
}
CASES["aniso24"] = lambda: aniso_laplacian_csr(24, 24).to_numpy()
CASES["chain40"] = lambda: _csr(bidiagonal(40, 3))
CASES["diag30"] = lambda: _csr(diagonal(30, 4))
CASES["tri90"] = lambda: triangular(90, 4, 0.15)[:4]


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _plans(name, lower):
    rp, ci, v, shape = CASES[name]()
    lu = tri.ilu0_host(rp, ci, v, shape)
    ours = tri.analyze_trisolve(rp, ci, lu, shape, lower=lower, unit_diag=lower)
    ref = ref_tri.analyze_trisolve(rp, ci, lu, shape, lower=lower, unit_diag=lower)
    return ours, ref


def _walk(plan):
    """(rows in level_ptr order, the dependency positions in the walk's
    order, the level of each visited row)."""
    lp = plan.level_ptr.numpy()
    rows_sorted = plan.rows_sorted.numpy()
    start, length = plan.dep_start.numpy(), plan.dep_len.numpy()
    rows, deps, levels = [], [], []
    for lvl in range(plan.num_levels):
        for row in rows_sorted[lp[lvl]:lp[lvl + 1]]:
            rows.append(row)
            levels.append(lvl)
            deps.extend(range(start[row], start[row] + length[row]))
    return np.asarray(rows), np.asarray(deps, dtype=np.int64), np.asarray(levels)


def _check_walk(ours, ref):
    m, nd = ours.m, ours.num_deps
    rows, deps, levels = _walk(ours)
    assert np.array_equal(rows, np.asarray(ref.rows_sorted)[:m])
    assert np.array_equal(levels, ours.level_of_row[rows])
    # the walk reads every dependency once, in the plan's (the JAX package's) order
    assert np.array_equal(deps, np.arange(nd))
    assert np.array_equal(ours.dep_rows.numpy()[deps], np.asarray(ref.dep_rows)[:nd])
    assert np.array_equal(ours.dep_cols.numpy()[deps], np.asarray(ref.dep_cols)[:nd])
    assert np.array_equal(np.repeat(rows, ours.dep_len.numpy()[rows]), ours.dep_rows.numpy())
    counts = np.bincount(ours.level_of_row, minlength=ours.num_levels)
    assert ours.widest_level == counts.max()
    assert ours.level_ptr.numel() == ours.num_levels + 1


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_walk_matches_reference(name, lower):
    ours, ref = _plans(name, lower)
    assert ours.num_levels == ref.num_levels and ours.level_ptr is not None
    for t in (ours.dep_start, ours.dep_len, ours.level_ptr, ours.rows_sorted):
        assert t.dtype == torch.int64 and t.is_contiguous()
    assert ours.dep_start.shape == ours.dep_len.shape == (ours.m,)
    _check_walk(ours, ref)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", ["tri90", "aniso24"])
def test_plan_walk_with_small_chunks(name, lower, monkeypatch):
    """_W / _R forced small: the chunk schedule has many chunks a level, the
    level arrays do not depend on it."""
    for mod in (tri, ref_tri):
        monkeypatch.setattr(mod, "_W", 7)
        monkeypatch.setattr(mod, "_R", 5)
    ours, ref = _plans(name, lower)
    assert ours.num_iters == ref.num_iters > ours.num_levels
    _check_walk(ours, ref)


@pytest.mark.parametrize("lower", [True, False])
def test_plan_past_the_level_cap(lower, monkeypatch):
    """Past _EXACT_MAX_LEVELS: no rows_sorted and no level_ptr, the
    dependency ranges kept (the sweeps read them)."""
    monkeypatch.setattr(tri, "_EXACT_MAX_LEVELS", 4)
    ours, _ = _plans("aniso24", lower)
    assert ours.rows_sorted is None and ours.level_ptr is None and ours.num_levels > 4
    start, length, dep_rows = (t.numpy() for t in (ours.dep_start, ours.dep_len,
                                                   ours.dep_rows))
    for row in range(ours.m):
        assert (dep_rows[start[row]:start[row] + length[row]] == row).all()
    assert length.sum() == ours.num_deps


def test_dependency_ranges_of_rows_without_one():
    ours, _ = _plans("diag30", True)
    assert ours.num_deps == 0 and ours.num_levels == 1 and ours.widest_level == 30
    assert not ours.dep_len.any() and not ours.dep_start.any()
    assert ours.level_ptr.tolist() == [0, 30]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_reference(name, lower):
    ours, ref = _plans(name, lower)
    b = np.random.default_rng(5).standard_normal(ours.m)
    y = tri.trisolve_plain(ours, torch.from_numpy(b)).numpy()
    y_ref = np.asarray(ref_tri.trisolve(ref, jnp.asarray(b)))
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    for sweeps in (0, 1, 3):
        ys = tri.trisolve_sweeps_plain(ours, torch.from_numpy(b), sweeps).numpy()
        ys_ref = np.asarray(ref_tri.trisolve_sweeps(ref, jnp.asarray(b), sweeps))
        assert np.abs(ys - ys_ref).max() <= 1e-12 * np.abs(ys_ref).max()


@pytest.mark.parametrize("lower", [True, False])
def test_plain_versions_past_the_level_cap_match_reference(lower, monkeypatch):
    for mod in (tri, ref_tri):
        monkeypatch.setattr(mod, "_EXACT_MAX_LEVELS", 8)
    ours, ref = _plans("aniso24", lower)
    assert ours.rows_sorted is None and ref.rows_sorted is None
    b = np.random.default_rng(6).standard_normal(ours.m)
    y = tri.trisolve_plain(ours, torch.from_numpy(b)).numpy()
    y_ref = np.asarray(ref_tri.trisolve(ref, jnp.asarray(b)))
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    assert torch.equal(tri.trisolve_plain(ours, torch.from_numpy(b)),
                       tri.trisolve_sweeps_plain(ours, torch.from_numpy(b), ours.num_levels))


def _emulate(plan, b, sweeps=None):
    """The kernels' arithmetic as scalar numpy in b's dtype: tri_levels
    (``sweeps`` None: the levels in order) or tri_sweeps."""
    dt = b.dtype
    vals = plan.dep_vals.numpy().astype(dt)
    diag = plan.diag.numpy().astype(dt)
    cols, start, length = (t.numpy() for t in (plan.dep_cols, plan.dep_start, plan.dep_len))

    def row_value(row, y):
        s = dt.type(0)
        for k in range(start[row], start[row] + length[row]):
            s = dt.type(s + dt.type(vals[k] * y[cols[k]]))
        return dt.type(dt.type(b[row] - s) / diag[row])

    if sweeps is None:
        y = np.zeros(plan.m, dtype=dt)
        lp, rows = plan.level_ptr.numpy(), plan.rows_sorted.numpy()
        for lvl in range(plan.num_levels):
            for row in rows[lp[lvl]:lp[lvl + 1]]:
                y[row] = row_value(row, y)
        return y
    y = (b / diag).astype(dt)
    for _ in range(sweeps):
        y = np.array([row_value(row, y) for row in range(plan.m)], dtype=dt)
    return y


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", ["spd80", "aniso16", "chain40", "diag30"])
def test_kernel_walk_gives_the_plain_bits(name, lower, dtype):
    """Summing a row's products in plan order from 0 and rounding each
    operation in b's dtype is what the plain versions compute, bit for bit."""
    ours, _ = _plans(name, lower)
    b = np.random.default_rng(7).standard_normal(ours.m).astype(dtype)
    tb = torch.from_numpy(b)
    assert np.array_equal(_emulate(ours, b), tri.trisolve_plain(ours, tb).numpy())
    for sweeps in (0, 2, 5):
        assert np.array_equal(_emulate(ours, b, sweeps),
                              tri.trisolve_sweeps_plain(ours, tb, sweeps).numpy())


def test_chunked_plain_gives_the_walk_bits(monkeypatch):
    """Dependencies of one row split across chunks (_W = 3) still add in plan
    order: the chunk schedule's bits are the level walk's."""
    monkeypatch.setattr(tri, "_W", 3)
    monkeypatch.setattr(tri, "_R", 2)
    rp, ci, v, shape, _ = triangular(60, 8, 0.3)
    plan = tri.analyze_trisolve(rp, ci, v, shape, lower=True, unit_diag=False)
    assert plan.dep_len.max() > 3
    b = np.random.default_rng(11).standard_normal(60)
    assert np.array_equal(_emulate(plan, b), tri.trisolve_plain(plan, torch.from_numpy(b)).numpy())


def test_values_cast_once():
    ours, _ = _plans("spd80", False)
    assert ours.values(torch.float64) == (ours.dep_vals, ours.diag)
    v32, d32 = ours.values(torch.float32)
    assert v32.dtype == d32.dtype == torch.float32
    assert torch.equal(v32, ours.dep_vals.float()) and torch.equal(d32, ours.diag.float())
    again = ours.values(torch.float32)
    assert again[0] is v32 and again[1] is d32


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    """trisolve, trisolve_sweeps and ILU0.solve (exact and gather sweeps) on
    CPU tensors: the plain versions' bits, no launch."""
    def no_launch(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(tri, "_launch", no_launch)
    tri.LAUNCHES.clear()
    ours, _ = _plans("spd300", True)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(ours.m))
    assert torch.equal(tri.trisolve(ours, b), tri.trisolve_plain(ours, b))
    assert torch.equal(tri.trisolve_sweeps(ours, b, 3), tri.trisolve_sweeps_plain(ours, b, 3))
    assert torch.equal(tri.trisolve_sweeps(ours, b, np.int64(2)),
                       tri.trisolve_sweeps_plain(ours, b, 2))
    rp, ci, v, shape = CASES["spd300"]()
    csr = CSR.from_numpy(rp, ci, v, shape)
    for sweeps in (0, 3):
        fact = tri.ilu0(csr, sweeps=sweeps)
        z = tri.trisolve_sweeps_plain(fact.l_plan, b, sweeps) if sweeps else tri.trisolve_plain(
            fact.l_plan, b)
        want = (tri.trisolve_sweeps_plain(fact.u_plan, z, sweeps) if sweeps
                else tri.trisolve_plain(fact.u_plan, z))
        assert torch.equal(fact.solve(b), want)
    assert not tri.LAUNCHES


def test_argument_checks_raise():
    ours, _ = _plans("spd80", True)
    b = torch.zeros(ours.m, dtype=torch.float64)
    for fn in (lambda v: tri.trisolve(ours, v), lambda v: tri.trisolve_sweeps(ours, v, 2)):
        with pytest.raises(TypeError, match="must be a torch.Tensor"):
            fn(np.zeros(ours.m))
        with pytest.raises(ValueError, match="runs float64 and float32"):
            fn(torch.zeros(ours.m, dtype=torch.int64))
        with pytest.raises(ValueError, match="runs float64 and float32"):
            fn(torch.zeros(ours.m, dtype=torch.float16))
        with pytest.raises(ValueError, match="has shape"):
            fn(torch.zeros(ours.m + 1, dtype=torch.float64))
        with pytest.raises(ValueError, match="has shape"):
            fn(torch.zeros((ours.m, 1), dtype=torch.float64))
        with pytest.raises(ValueError, match="the plan on cpu"):
            fn(torch.zeros(ours.m, dtype=torch.float64, device="meta"))
    for bad in (-1, 1.5, True, None):
        with pytest.raises(ValueError, match="sweeps must be an int >= 0"):
            tri.trisolve_sweeps(ours, b, bad)
    rp, ci, v, shape = CASES["spd80"]()
    lu = tri.ilu0_host(rp, ci, v, shape)
    meta = tri.analyze_trisolve(rp, ci, lu, shape, lower=True, unit_diag=True, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for device meta"):
        tri.trisolve(meta, torch.zeros(ours.m, dtype=torch.float64, device="meta"))


def test_launch_counters_hold_f3():
    from spmv_acc_tpu_torch.utils.graphs import launch_counters

    assert any(c is tri.LAUNCHES for c in launch_counters())
