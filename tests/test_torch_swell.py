"""The port's swell strategy (the kernel's plain version on the CPU) against the JAX
package's ``spmv_swell`` (Pallas interpret mode) and the CPU golden.

Tolerances: every output passes ``verify_y`` against ``host_spmv`` (rel 1e-7,
abs 1e-14 near zero), and port and reference agree row-wise within
1e-12 * (|A|·|x|)[row] — FP64 summation order differs, nothing else."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays
from spmv_acc_tpu.formats.generate import example_like, random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.swell import spmv_swell as ref_spmv_swell
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.utils.verify import verify_y

ALPHA, BETA = 1.25, -0.5
ROW_TOL = 1e-12


def _duplicate_columns():
    rng = np.random.default_rng(90)
    m = n = 96
    cols = rng.integers(0, n, size=5 * m).astype(np.int64)
    cols[:5] = [7, 3, 7, 7, 3]
    return RefCSR.from_numpy(np.arange(0, 5 * m + 1, 5), cols, rng.standard_normal(5 * m), (m, n))


def _long_row():
    m = 260
    rows = np.concatenate([np.repeat(np.arange(m), 2), np.full(m, 7)])
    cols = np.concatenate([np.tile(np.array([0, 1]), m) + np.repeat(np.arange(m), 2) % 100,
                           np.arange(m)])
    vals = np.random.default_rng(3).standard_normal(len(rows))
    rp, ci, v = coo_to_csr_arrays(rows, cols, vals, (m, m))
    return RefCSR.from_numpy(rp, ci, v, (m, m))


MATRICES = {
    "banded": lambda: banded_csr(300, bandwidth=5, seed=70),
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=72),
    "outlier": lambda: dense_row_outlier_csr(140, 140, avg_nnz=3, n_dense=2, seed=73),
    "window_dense": lambda: random_csr(64, 100, 3000, seed=74),
    "tall": lambda: random_csr(40000, 300, 9000, seed=75),
    "wide": lambda: random_csr(300, 40000, 9000, seed=76),
    "single_col": lambda: random_csr(200, 1, 180, seed=77),
    "duplicate_cols": _duplicate_columns,
    "long_row": _long_row,
    "rajat03": lambda: example_like("rajat03"),
    "dw4096": lambda: example_like("dw4096"),
    "af23560": lambda: example_like("af23560"),
}

_REF: dict = {}


def _case(name):
    """(reference CSR, x, y, reference spmv_swell output), made once per module."""
    if name not in _REF:
        ref = MATRICES[name]()
        m, n = ref.shape
        x, y = random_x_y(n, m, seed=75)
        out = np.asarray(ref_spmv_swell(ALPHA, BETA, ref, jnp.asarray(x), jnp.asarray(y)))
        _REF[name] = (ref, x, y, out)
    return _REF[name]


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _row_bound(rp, ci, v, x, scale=1.0):
    return scale * host_spmv(1.0, 0.0, rp, ci, np.abs(v), np.abs(x), np.zeros(len(rp) - 1))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_swell_matches_reference(name):
    ref, x, y, ref_out = _case(name)
    rp, ci, v, _ = ref.to_numpy()
    csr = CSR.from_numpy(*ref.to_numpy())
    out = swell.spmv_swell(ALPHA, BETA, csr, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    golden = host_spmv(ALPHA, BETA, rp, ci, v, x, y)
    assert verify_y(out, golden).ok and verify_y(ref_out, golden).ok
    bound = ROW_TOL * (_row_bound(rp, ci, v, x, abs(ALPHA)) + abs(BETA * y))
    assert (np.abs(out - ref_out) <= bound).all()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_swell_ax_matches_golden_without_launch(name):
    ref, x, _, _ = _case(name)
    rp, ci, v, _ = ref.to_numpy()
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, ref.shape))
    before = sum(swell.LAUNCHES.values())
    ax = swell.swell_ax(layout, torch.from_numpy(x)).numpy()
    assert sum(swell.LAUNCHES.values()) == before == 0
    golden = host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(ref.shape[0]))
    assert verify_y(ax, golden).ok
    assert (np.abs(ax - golden) <= ROW_TOL * _row_bound(rp, ci, v, x)).all()
    plain = swell.swell_ax_plain(layout, torch.from_numpy(x)).numpy()
    assert np.array_equal(ax, plain)


def test_spill_tail_matches_reference(monkeypatch):
    """A forced COO-tail spill: the tail goes through index_add_ beside the slabs."""
    monkeypatch.setenv("SPMV_TPU_SPILL", "16")
    m = 40_000
    base = banded_csr(m, bandwidth=5, seed=11)
    rp, ci, v, _ = base.to_numpy()
    rng = np.random.default_rng(12)
    ro = rng.integers(0, m, size=60)
    rp, ci, v = coo_to_csr_arrays(
        np.concatenate([np.repeat(np.arange(m), np.diff(rp)), ro]),
        np.concatenate([ci, (ro + m // 2) % m]), np.concatenate([v, rng.uniform(-1, 1, 60)]),
        (m, m))
    x, y = random_x_y(m, m, seed=4)
    ref_out = np.asarray(ref_spmv_swell(ALPHA, BETA, RefCSR.from_numpy(rp, ci, v, (m, m)),
                                        jnp.asarray(x), jnp.asarray(y)))
    csr = CSR.from_numpy(rp, ci, v, (m, m))
    assert swell.get_swell_plan(csr).tail_v.numel() > 0
    out = swell.spmv_swell(ALPHA, BETA, csr, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok
    bound = ROW_TOL * (_row_bound(rp, ci, v, x, abs(ALPHA)) + abs(BETA * y))
    assert (np.abs(out - ref_out) <= bound).all()


def test_swell_ax_checks_inputs():
    rp, ci, v, shape = random_csr(50, 60, 300, seed=6).to_numpy()
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, shape))
    with pytest.raises(ValueError):
        swell.swell_ax(layout, torch.zeros(59, dtype=torch.float64))
    with pytest.raises(ValueError):
        swell.swell_ax(layout, torch.zeros(120, dtype=torch.float64)[::2])
    with pytest.raises(TypeError):
        swell.swell_ax(layout, np.zeros(60))


def test_plan_cache_holds_keyed_tensors():
    rp, ci, v, shape = random_csr(70, 70, 400, seed=7).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    assert swell.get_swell_plan(csr) is swell.get_swell_plan(csr)
    # a new matrix sharing row_ptr and col_idx but not values gets its own plan
    other = CSR(csr.row_ptr, csr.col_idx, csr.values * 2, shape)
    lay2 = swell.get_swell_plan(other)
    assert lay2 is not swell.get_swell_plan(csr)
    x = torch.from_numpy(random_x_y(70, 70, seed=8)[0])
    assert torch.allclose(swell.swell_ax(lay2, x), 2 * swell.swell_ax(swell.get_swell_plan(csr), x),
                          rtol=1e-14, atol=0)


def test_make_swell_run_chains():
    ref, x, y, _ = _case("banded")
    csr = CSR.from_numpy(*ref.to_numpy())
    run = swell.make_swell_run(csr, ALPHA, BETA)
    xs = run(torch.from_numpy(x), torch.from_numpy(y), 3)
    assert xs.shape == (300,) and torch.isfinite(xs).all()
    assert torch.allclose(xs, torch.from_numpy(x), rtol=1e-20 + 1e-15, atol=0)
