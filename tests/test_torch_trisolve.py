"""The port's ILU(0) and triangular solves (``ops/trisolve.py``) against the
JAX package's, on the same numpy inputs.

Tolerances: the native factorization is the same C++ on the same arrays, so
its values are equal; the Python fallback reorders nothing but its divisions
and subtractions run in another loop, rtol 1e-13 (as the JAX package's own
test).  Plans are integer arrays and equal.  Solves sum the same products in
the same order on both sides, within 1e-12 max|y|; against np.linalg.solve
they pass ``verify_y``.  The swell-backed sweeps sum in another order than the
JAX package's interpret-mode kernel: rtol 1e-10, atol 1e-12 (the JAX package's
own bound for its two backings)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import banded_csr
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays, csr_to_dense
from spmv_acc_tpu.formats.generate import aniso_laplacian_csr
from spmv_acc_tpu.ops import trisolve as ref_tri
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.io import native
from spmv_acc_tpu_torch.ops import trisolve as tri
from spmv_acc_tpu_torch.utils.verify import verify_y


def spd(m, seed):
    """Symmetric, diagonally dominant (SPD) banded matrix, as the JAX package's
    tests build it."""
    rp, ci, v, shape = banded_csr(m, bandwidth=5, seed=seed).to_numpy()
    d = csr_to_dense(rp, ci, v, shape)
    d = 0.5 * (d + d.T)
    d += np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    return coo_to_csr_arrays(rr, cc, d[rr, cc], shape) + (shape,)


def triangular(m, seed, density):
    rng = np.random.default_rng(seed)
    d = np.tril(rng.random((m, m)) * (rng.random((m, m)) < density), k=-1) + np.diag(
        rng.random(m) + 1.0)
    rr, cc = np.nonzero(d)
    return coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m)) + ((m, m), d)


MATRICES = {
    "spd80": lambda: spd(80, 22),
    "spd300": lambda: spd(300, 33),
    "aniso16": lambda: aniso_laplacian_csr(16, 16).to_numpy(),
}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ilu0_host_native_matches_reference(name):
    rp, ci, v, shape = MATRICES[name]()
    assert native.available()
    lu = tri.ilu0_host(rp, ci, v, shape)
    assert lu.dtype == np.float64
    assert np.array_equal(lu, ref_tri.ilu0_host(rp, ci, v, shape))


@pytest.mark.parametrize("name", ["spd80", "aniso16"])
def test_ilu0_host_fallback_matches_native(name, monkeypatch):
    rp, ci, v, shape = MATRICES[name]()
    lu_native = tri.ilu0_host(rp, ci, v, shape)
    monkeypatch.setattr(native, "ilu0_factor_native", lambda *a, **k: None)
    np.testing.assert_allclose(tri.ilu0_host(rp, ci, v, shape), lu_native, rtol=1e-13)


@pytest.mark.parametrize("use_native", [True, False])
def test_ilu0_needs_a_full_diagonal(use_native, monkeypatch):
    rp, ci, v = coo_to_csr_arrays(np.array([0, 1, 1]), np.array([0, 0, 2]),
                                  np.array([2.0, 1.0, 3.0]), (3, 3))
    if not use_native:
        monkeypatch.setattr(native, "ilu0_factor_native", lambda *a, **k: None)
    with pytest.raises(ValueError, match="ILU\\(0\\) requires a full diagonal; row 1 has none"):
        tri.ilu0_host(rp, ci, v, (3, 3))


def _plans(name, lower):
    rp, ci, v, shape = MATRICES[name]()
    lu = tri.ilu0_host(rp, ci, v, shape)
    ours = tri.analyze_trisolve(rp, ci, lu, shape, lower=lower, unit_diag=lower)
    ref = ref_tri.analyze_trisolve(rp, ci, lu, shape, lower=lower, unit_diag=lower)
    return ours, ref, lu


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_analyze_trisolve_matches_reference(name, lower):
    """Array for array; the reference pads its dependency and row arrays for
    static shapes (``_W`` / ``_R`` entries at the sink slot m), the port not."""
    ours, ref, _ = _plans(name, lower)
    m, nd = ours.m, ours.num_deps
    assert (ours.m, ours.lower, ours.num_levels, ours.num_iters) == (
        ref.m, ref.lower, ref.num_levels, ref.num_iters)
    assert np.array_equal(ours.level_of_row, ref.level_of_row)
    assert nd == ref.dep_rows.shape[0] - ref_tri._W
    for a, b in ((ours.dep_rows, ref.dep_rows), (ours.dep_cols, ref.dep_cols),
                 (ours.dep_vals, ref.dep_vals)):
        assert np.array_equal(a.numpy(), np.asarray(b)[:nd])
    assert np.array_equal(ours.diag.numpy(), np.asarray(ref.diag))
    assert np.array_equal(ours.rows_sorted.numpy(), np.asarray(ref.rows_sorted)[:m])
    for a, b in ((ours.dep_off, ref.dep_off), (ours.dep_cnt, ref.dep_cnt),
                 (ours.row_off, ref.row_off), (ours.row_cnt, ref.row_cnt)):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("lower", [True, False])
def test_level_fallback_matches_native(lower, monkeypatch):
    rp, ci, _, shape = MATRICES["spd300"]()
    want = tri._levels(np.asarray(rp, np.int64), np.asarray(ci, np.int64), shape[0], lower)
    monkeypatch.setattr(native, "trisolve_levels_native", lambda *a, **k: None)
    got = tri._levels(np.asarray(rp, np.int64), np.asarray(ci, np.int64), shape[0], lower)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_trisolve_and_sweeps_match_reference(name, lower):
    ours, ref, _ = _plans(name, lower)
    b = np.random.default_rng(5).standard_normal(ours.m)
    y = tri.trisolve(ours, torch.from_numpy(b)).numpy()
    y_ref = np.asarray(ref_tri.trisolve(ref, jnp.asarray(b)))
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    for sweeps in (1, 3):
        ys = tri.trisolve_sweeps(ours, torch.from_numpy(b), sweeps).numpy()
        ys_ref = np.asarray(ref_tri.trisolve_sweeps(ref, jnp.asarray(b), sweeps))
        assert np.abs(ys - ys_ref).max() <= 1e-12 * np.abs(ys_ref).max()


@pytest.mark.parametrize("exact_max_levels", [4096, 4])
def test_trisolve_matches_dense_solve(exact_max_levels, monkeypatch):
    """The chunk schedule and, past the level cap, num_levels sweeps."""
    monkeypatch.setattr(tri, "_EXACT_MAX_LEVELS", exact_max_levels)
    rp, ci, v, shape, d = triangular(64, 21, 0.2)
    plan = tri.analyze_trisolve(rp, ci, v, shape, lower=True, unit_diag=False)
    assert (plan.rows_sorted is None) == (plan.num_levels > exact_max_levels)
    b = np.random.default_rng(9).random(64)
    golden = np.linalg.solve(d, b)
    assert verify_y(tri.trisolve(plan, torch.from_numpy(b)).numpy(), golden).ok
    assert verify_y(tri.trisolve_sweeps(plan, torch.from_numpy(b), plan.num_levels).numpy(),
                    golden).ok


def test_chunked_schedule_crosses_chunk_boundaries(monkeypatch):
    """Small _W / _R force levels of several dependency and row chunks."""
    monkeypatch.setattr(tri, "_W", 7)
    monkeypatch.setattr(tri, "_R", 5)
    rp, ci, v, shape, d = triangular(90, 4, 0.15)
    plan = tri.analyze_trisolve(rp, ci, v, shape, lower=True, unit_diag=False)
    assert plan.dep_cnt.max() == 7 and plan.row_cnt.max() == 5
    b = np.random.default_rng(10).random(90)
    assert verify_y(tri.trisolve(plan, torch.from_numpy(b)).numpy(),
                    np.linalg.solve(d, b)).ok


def _ilu_pair(name, sweeps, monkeypatch, swell_min=None):
    rp, ci, v, shape = MATRICES[name]()
    if swell_min is not None:
        monkeypatch.setenv("SPMV_TPU_ILU_SWELL_MIN", str(swell_min))
        monkeypatch.setattr(tri, "ILU_SWELL_MIN", swell_min)
    ours = tri.ilu0(CSR.from_numpy(rp, ci, v, shape), sweeps=sweeps)
    ref = ref_tri.ilu0(RefCSR.from_numpy(rp, ci, v, shape), sweeps=sweeps)
    return ours, ref


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ilu0_auto_rule_matches_reference(name, monkeypatch):
    ours, ref = _ilu_pair(name, None, monkeypatch)
    assert ours.sweeps == ref.sweeps
    assert (ours.swell is None) == (ref.swell is None)
    r = np.random.default_rng(12).standard_normal(ours.l_plan.m)
    z = ours.solve(torch.from_numpy(r)).numpy()
    z_ref = np.asarray(ref.solve(jnp.asarray(r)))
    assert np.abs(z - z_ref).max() <= 1e-12 * np.abs(z_ref).max()


def test_ilu0_picks_sweeps_on_long_chains(monkeypatch):
    rp, ci, v, shape = aniso_laplacian_csr(24, 24).to_numpy()
    ours = tri.ilu0(CSR.from_numpy(rp, ci, v, shape))
    ref = ref_tri.ilu0(RefCSR.from_numpy(rp, ci, v, shape))
    assert ours.sweeps == ref.sweeps
    monkeypatch.setattr(tri, "_EXACT_MAX_LEVELS", 8)
    monkeypatch.setattr(ref_tri, "_EXACT_MAX_LEVELS", 8)
    ours = tri.ilu0(CSR.from_numpy(rp, ci, v, shape))
    ref = ref_tri.ilu0(RefCSR.from_numpy(rp, ci, v, shape))
    assert ours.sweeps == ref.sweeps == 6 and ours.l_plan.rows_sorted is None


@pytest.mark.parametrize("name", ["spd300", "aniso16"])
def test_sweep_apply_swell_matches_reference(name, monkeypatch):
    ours, ref = _ilu_pair(name, 4, monkeypatch, swell_min=0)
    assert ours.swell is not None and ref.swell is not None
    r = np.random.default_rng(34).standard_normal(ours.l_plan.m)
    z = ours.solve(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(z, np.asarray(ref.solve(jnp.asarray(r))), rtol=1e-10, atol=1e-12)
    gather = tri.ILU0(ours.l_plan, ours.u_plan, sweeps=4)
    np.testing.assert_allclose(z, gather.solve(torch.from_numpy(r)).numpy(), rtol=1e-10,
                               atol=1e-12)


def test_swell_backing_starts_at_the_threshold(monkeypatch):
    rp, ci, v, shape = MATRICES["spd80"]()
    n_off = int((np.repeat(np.arange(80), np.diff(rp)) != ci).sum())
    monkeypatch.setattr(tri, "ILU_SWELL_MIN", n_off)
    assert tri.ilu0(CSR.from_numpy(rp, ci, v, shape), sweeps=2).swell is not None
    monkeypatch.setattr(tri, "ILU_SWELL_MIN", n_off + 1)
    assert tri.ilu0(CSR.from_numpy(rp, ci, v, shape), sweeps=2).swell is None
