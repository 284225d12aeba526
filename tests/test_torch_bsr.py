"""The port's BSR micro-block swell path against the JAX package's: block-size
detection, condensation (numpy and native branches), forced r = 2, 3, 4 plans
through the kernel's plain version, and ``spmv(strategy="adaptive")`` on a
block-structured matrix whose plan gets r > 1.

Tolerances: float64 outputs pass ``verify_y`` against ``host_spmv`` (rel 1e-7,
abs 1e-14 near zero), and port and reference agree row-wise within
1e-12 * (|A|·|x|)[row]: FP64 summation order differs, nothing else.  float32
outputs pass the f32 gate (rel 1e-3, abs 1e-5 near 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_acc_tpu.io.native as ref_native
import spmv_acc_tpu_torch.io.native as port_native
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays
from spmv_acc_tpu.formats.generate import banded_csr, example_like, fem_like_csr, random_csr, random_x_y
from spmv_acc_tpu.ops.bsr_block import bsr_condense as ref_bsr_condense
from spmv_acc_tpu.ops.bsr_block import detect_block_size as ref_detect
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.swell import get_swell_plan as ref_get_swell_plan
from spmv_acc_tpu.ops.swell import spmv_swell as ref_spmv_swell
from spmv_acc_tpu_torch import dispatch
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.ops.bsr_block import bsr_condense, detect_block_size
from spmv_acc_tpu_torch.utils.verify import verify_y

ALPHA, BETA = 1.25, -0.5
ROW_TOL = 1e-12


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    dispatch.clear_caches()


def _row_bound(rp, ci, v, x, y):
    return host_spmv(abs(ALPHA), abs(BETA), rp, ci, np.abs(v.astype(np.float64)),
                     np.abs(x.astype(np.float64)), np.abs(y.astype(np.float64)))


DETECT = {
    # the JAX package's fixtures (tests/test_swell_bsr.py:28-49) and one corpus matrix
    "fem_b3": (lambda: fem_like_csr(4000, 4000, 700000, block=3, seed=3, dtype=np.float64), 3),
    "fem_b16": (lambda: fem_like_csr(4000, 4000, 700000, block=16, seed=3, dtype=np.float64), 4),
    "fem_b6": (lambda: fem_like_csr(4000, 4000, 700000, block=6, seed=3, dtype=np.float64), 3),
    "scattered": (lambda: random_csr(4000, 4000, 60000, seed=1), 1),
    "shallow": (lambda: fem_like_csr(4000, 4000, 120000, block=3, seed=3, dtype=np.float64), 1),
    "exdata_1": (lambda: example_like("exdata_1"), 4),
}


@pytest.mark.parametrize("name", sorted(DETECT))
def test_detect_block_size_matches_reference(name):
    make, expect = DETECT[name]
    rp, ci, _, shape = make().to_numpy()
    assert ref_detect(rp, ci, shape) == expect
    assert detect_block_size(rp, ci, shape) == expect


def _no_native(monkeypatch):
    monkeypatch.setattr(ref_native, "bsr_condense_native", lambda *a: None)
    monkeypatch.setattr(port_native, "bsr_condense_native", lambda *a: None)


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bsr_condense_matches_reference(branch, r, dtype, monkeypatch):
    """Array for array, on both branches (float32 values take numpy on both)."""
    csr = fem_like_csr(2001, 1998, 60000, block=4, seed=9, dtype=np.float64)
    rp, ci, v, shape = csr.to_numpy()
    v = v.astype(dtype)
    if branch == "numpy":
        _no_native(monkeypatch)
    elif dtype == np.float64 and port_native.get_lib() is None:
        pytest.skip("the native library could not be built")
    want = ref_bsr_condense(rp, ci, v, shape, r)
    got = bsr_condense(rp, ci, v, shape, r)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2].shape == (len(got[1]), r * r) and got[0][-1] == len(got[1])


def _fem(m, nnz, blk, seed, dtype=np.float64):
    return fem_like_csr(m, m, nnz, block=blk, seed=seed, dtype=dtype)


def _dup_cells():
    """A block matrix with repeated (row, col) cells, which must be summed."""
    rp, ci, v, shape = _fem(300, 9000, 3, seed=21).to_numpy()
    # every stored cell twice in a row, as v and v/2: the matrix is 1.5 A
    vv = np.stack([v, 0.5 * v], axis=1).reshape(-1)
    return RefCSR.from_numpy(2 * np.asarray(rp), np.repeat(ci, 2), vv, shape)


FORCED = {
    "fem_b6": lambda dtype: _fem(601, 30000, 6, seed=7, dtype=dtype),
    "fem_b4": lambda dtype: _fem(1003, 40000, 4, seed=8, dtype=dtype),
    "banded": lambda dtype: banded_csr(301, bandwidth=4, seed=37, dtype=dtype),
}


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(FORCED))
def test_forced_bsr_swell_matches_reference(name, r, monkeypatch):
    """Forced r (the reference pinned with SPMV_TPU_BSR): port and reference
    plans get r, and their outputs agree; m is no multiple of r on two cases,
    so the trailing node block is partial."""
    ref = FORCED[name](np.float64)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=11)
    monkeypatch.setenv("SPMV_TPU_BSR", str(r))
    ref_out = np.asarray(ref_spmv_swell(ALPHA, BETA, ref, jnp.asarray(x), jnp.asarray(y)))
    assert ref_get_swell_plan(ref, np.float64).r == r
    csr = CSR.from_numpy(rp, ci, v, (m, n))
    layout = swell.get_swell_plan(csr, r=r)
    assert layout.r == r and (layout.rows, layout.cols) == (-(-m // r), -(-n // r))
    assert layout.tail_v.numel() == 0 and layout.vals.numel() == layout.slots * r * r
    out = dispatch._xla.axpby_finish(ALPHA, BETA, swell.swell_ax(layout, torch.from_numpy(x)),
                                     torch.from_numpy(y)).numpy()
    golden = host_spmv(ALPHA, BETA, rp, ci, v, x, y)
    assert verify_y(out, golden).ok and verify_y(ref_out, golden).ok
    assert (np.abs(out - ref_out) <= ROW_TOL * _row_bound(rp, ci, v, x, y)).all()


@pytest.mark.parametrize("r", [2, 3, 4])
def test_forced_bsr_swell_float32(r, monkeypatch):
    ref = FORCED["fem_b6"](np.float32)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=12, dtype=np.float32)
    monkeypatch.setenv("SPMV_TPU_BSR", str(r))
    ref_out = np.asarray(ref_spmv_swell(1.0, 1.0, ref, jnp.asarray(x), jnp.asarray(y)))
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, (m, n)), r=r)
    assert layout.r == r and layout.dtype == torch.float32
    out = (swell.swell_ax(layout, torch.from_numpy(x)) + torch.from_numpy(y)).numpy()
    golden = host_spmv(1.0, 1.0, rp, ci, v, x, y)
    assert out.dtype == np.float32
    assert verify_y(out, golden, dtype=np.float32).ok
    assert verify_y(ref_out, golden, dtype=np.float32).ok


def test_duplicate_cells_summed_before_condensing():
    ref = _dup_cells()
    rp, ci, v, (m, n) = ref.to_numpy()
    x, _ = random_x_y(n, m, seed=13)
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, (m, n)), r=3)
    out = swell.swell_ax(layout, torch.from_numpy(x)).numpy()
    golden = host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(m))
    assert verify_y(out, golden).ok


def test_bsr_plan_never_spills(monkeypatch):
    """The reference spills only scalar plans; a forced spill leaves BSR alone."""
    monkeypatch.setenv("SPMV_TPU_SPILL", "16")
    m = 40_000
    base = banded_csr(m, bandwidth=5, seed=11)
    rp, ci, v, _ = base.to_numpy()
    rng = np.random.default_rng(12)
    ro = rng.integers(0, m, size=60)
    rp, ci, v = coo_to_csr_arrays(np.concatenate([np.repeat(np.arange(m), np.diff(rp)), ro]),
                                  np.concatenate([ci, (ro + m // 2) % m]),
                                  np.concatenate([v, rng.uniform(-1, 1, 60)]), (m, m))
    csr = CSR.from_numpy(rp, ci, v, (m, m))
    assert swell.get_swell_plan(csr, r=1).tail_v.numel() > 0
    layout = swell.get_swell_plan(csr, r=2)
    assert layout.tail_v.numel() == 0
    x, _ = random_x_y(m, m, seed=14)
    golden = host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(m))
    assert verify_y(swell.swell_ax(layout, torch.from_numpy(x)), golden).ok


DETECTED = {
    "fem_b16": (lambda: _fem(1200, 150000, 16, seed=3), 4),
    "fem_b6": (lambda: _fem(1000, 100000, 6, seed=3), 3),
}


@pytest.mark.parametrize("name", sorted(DETECTED))
def test_adaptive_spmv_detects_blocks_end_to_end(name):
    """The slice end to end: ``spmv(strategy="adaptive")`` picks swell, the
    plan gets the reference detector's r > 1, and the output matches the
    reference's swell (which detects the same r) and the golden."""
    make, r = DETECTED[name]
    ref = make()
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=15)
    ref_out = np.asarray(ref_spmv_swell(ALPHA, BETA, ref, jnp.asarray(x), jnp.asarray(y)))
    assert ref_get_swell_plan(ref, np.float64).r == r
    csr = CSR.from_numpy(rp, ci, v, (m, n))
    h = dispatch.Handle()
    out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), ALPHA, BETA,
                        strategy="adaptive", handle=h).numpy()
    assert h.strategy_used == "swell" and swell.get_swell_plan(csr).r == r
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok
    assert (np.abs(out - ref_out) <= ROW_TOL * _row_bound(rp, ci, v, x, y)).all()


def test_explicit_r_is_validated():
    csr = CSR.from_numpy(*random_csr(40, 40, 200, seed=16).to_numpy())
    with pytest.raises(ValueError):
        swell.get_swell_plan(csr, r=5)
    assert swell.get_swell_plan(csr, r=2) is not swell.get_swell_plan(csr, r=3)
    assert swell.get_swell_plan(csr, r=2) is swell.get_swell_plan(csr, r=2)
