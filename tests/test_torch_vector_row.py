"""The port's ``vector_row`` strategy against the JAX package's: the row-sum
kernel's plain version against JAX's Pallas row-sum kernels (interpret mode),
``spmv(strategy="vector_row")`` against JAX's vector_row computation, and the
ELL cell budget that sends ell and vector_row to flat.

On a CPU tensor ``ell_rowsum`` runs its plain version (float64 sums).  JAX's
kernels read 256 x 512 tiles; in interpret mode they read past a smaller slab
and return NaN, so the slabs handed to them here are zero-padded to whole tiles
(zero cells add nothing).  Tolerances, element-wise, with ``B`` the row sums
of ``|vals|·|x[col]|`` (plus ``|beta|·|y|`` after the combine):
  * float64: ``|port - JAX| <= 1e-12 · B`` and ``verify_y`` (rel 1e-7);
  * float32: ``|port - JAX| <= 1e-5 · B`` (JAX sums in float32, the port in
    float64) and the f32 gate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu import dispatch as ref_dispatch
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.vector_row import (TILE_M, TILE_W, ell_rowsum_pallas,
                                         ell_rowsum_pallas_f64)
from spmv_acc_tpu_torch import dispatch
from spmv_acc_tpu_torch.formats.containers import CSR, ELL
from spmv_acc_tpu_torch.formats.convert import csr_to_ell
from spmv_acc_tpu_torch.ops import vector_row
from spmv_acc_tpu_torch.utils.verify import verify_y

TOL = {np.float64: 1e-12, np.float32: 1e-5}
MATRICES = {
    "banded": lambda: banded_csr(200, bandwidth=5, seed=0),
    "random": lambda: random_csr(150, 120, 1800, seed=1),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=2),
    "outlier": lambda: dense_row_outlier_csr(128, 128, avg_nnz=3, n_dense=2, seed=3),
    "wide_rows": lambda: random_csr(40, 900, 20000, seed=61),  # width > one 512 tile
}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    dispatch.clear_caches()


def _tile_padded(a):
    out = np.zeros((-(-a.shape[0] // TILE_M) * TILE_M, -(-a.shape[1] // TILE_W) * TILE_W),
                   a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


# JAX's two-f32 kernel is held on slabs of one 512-wide tile: across tiles its
# carried (hi, err) pair keeps only about float32 digits (5.2e-7 absolute on the
# 1024-wide "wide_rows" slab, rows of ~1e2), which the port's FP64 sum does not
# share.  That slab is held against the other two kernels.
KERNEL_CASES = [(name, kernel) for name in sorted(MATRICES)
                for kernel in ("ell_rowsum_pallas", "ell_rowsum_pallas_f64",
                               "ell_rowsum_pallas-f32")
                if (name, kernel) != ("wide_rows", "ell_rowsum_pallas_f64")]


@pytest.mark.parametrize("name,kernel", KERNEL_CASES)
def test_rowsum_plain_matches_reference_kernel(name, kernel):
    dtype = np.float32 if kernel.endswith("f32") else np.float64
    ref = MATRICES[name]()
    rp, ci, v, (m, n) = ref.to_numpy()
    ell = csr_to_ell(CSR.from_numpy(rp, ci, v.astype(dtype), (m, n)))
    x = random_x_y(n, m, seed=62, dtype=dtype)[0]
    got = vector_row.ell_rowsum(ell, torch.from_numpy(x)).numpy()
    vals, cols = ell.values.numpy(), ell.col_idx.numpy()
    xg = x[cols]
    pv, px = jnp.asarray(_tile_padded(vals)), jnp.asarray(_tile_padded(xg))
    if kernel == "ell_rowsum_pallas_f64":
        want = ell_rowsum_pallas_f64(pv, px, interpret=True)
    else:
        want = ell_rowsum_pallas(pv, px)
    want = np.asarray(want)[: len(got)]
    assert got.shape == (ell.padded_rows,) and got.dtype == dtype
    assert np.isfinite(got).all() and np.isfinite(want).all()
    bound = (np.abs(vals.astype(np.float64)) * np.abs(xg.astype(np.float64))).sum(1)
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (gap <= TOL[dtype] * bound).all(), float(gap.max())
    golden = host_spmv(1.0, 0.0, rp, ci, v.astype(dtype), x, np.zeros(m))
    assert verify_y(got[:m], golden, dtype=dtype).ok


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_vector_row_matches_reference(name, dtype):
    """spmv(strategy='vector_row') against JAX's vector_row on the CPU: its ELL
    slab (the same as the port's), ``ell_rowsum_pallas`` and the combine."""
    ref = MATRICES[name]()
    if dtype == np.float32:
        ref = ref.astype(jnp.float32)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=63, dtype=dtype)
    alpha, beta = 1.25, -0.5
    rell = ref_dispatch._get_ell(ref, ref_dispatch.DEFAULT_TUNE)
    vals = np.asarray(rell.values)
    xg = x[np.asarray(rell.col_idx)]
    ax = np.asarray(ell_rowsum_pallas(jnp.asarray(_tile_padded(vals)),
                                      jnp.asarray(_tile_padded(xg))))[:m]
    want = dtype(alpha) * ax + dtype(beta) * y
    csr = CSR.from_numpy(rp, ci, v, (m, n))
    out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), alpha, beta,
                        strategy="vector_row").numpy()
    port_ell = dispatch._get_ell(csr, dispatch.DEFAULT_TUNE)
    assert np.array_equal(port_ell.values.numpy(), vals)
    assert np.array_equal(port_ell.col_idx.numpy(), np.asarray(rell.col_idx))
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    bound = host_spmv(abs(alpha), abs(beta), rp, ci, np.abs(f64(v)), np.abs(f64(x)),
                      np.abs(f64(y)))
    assert out.dtype == dtype and np.isfinite(out).all()
    gap = np.abs(out.astype(np.float64) - want.astype(np.float64))
    assert (gap <= TOL[dtype] * bound).all(), float(gap.max())
    golden = host_spmv(alpha, beta, rp, ci, v, x, y)
    assert verify_y(out, golden, dtype=dtype).ok and verify_y(want, golden, dtype=dtype).ok


def test_ell_cell_budget_runs_flat(monkeypatch):
    """Past _ELL_MAX_CELLS the ell and vector_row branches run flat, as the
    reference's do (tests/test_spmv_strategies.py:189-208), and no ELL slab is
    built: a size rule decided before any allocation."""
    ref = dense_row_outlier_csr(3000, 3000, avg_nnz=4, seed=43)
    rp, ci, v, _ = ref.to_numpy()
    x, y = random_x_y(3000, 3000, seed=44)
    golden = host_spmv(1.0, 1.0, rp, ci, v, x, y)
    csr = CSR.from_numpy(rp, ci, v, ref.shape)
    monkeypatch.setattr(dispatch, "_ELL_MAX_CELLS", 1 << 16)
    monkeypatch.setattr(ref_dispatch, "_ELL_MAX_CELLS", 1 << 16)
    assert dispatch.ell_cells(csr, dispatch.DEFAULT_TUNE) == ref_dispatch.ell_cells(
        ref, ref_dispatch.DEFAULT_TUNE) > 1 << 16
    flat = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), 1.0, 1.0,
                         strategy="flat")
    for strat in ("vector_row", "ell"):
        out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), 1.0, 1.0,
                            strategy=strat)
        assert torch.equal(out, flat)
        fn, chosen = dispatch.make_spmv_fn(csr, 1.0, 1.0, strategy=strat)
        assert chosen == strat and torch.equal(fn(torch.from_numpy(x), torch.from_numpy(y)), flat)
        ref_out = np.asarray(ref_dispatch.spmv(ref, jnp.asarray(x), jnp.asarray(y), 1.0, 1.0,
                                               strategy=strat))
        assert verify_y(out, golden).ok and verify_y(ref_out, golden).ok
        assert np.allclose(out.numpy(), ref_out, rtol=1e-12, atol=1e-12)
    assert dispatch._ELL_CACHE == {}


def test_vector_size_thresholds():
    """Lanes a row by its width in 16-B vectors: float64 (8-B values) and
    float32 (4-B values) at the same widths."""
    widths = (1, 8, 15, 16, 24, 31, 32, 40, 64, 127, 128, 448, 2920)
    assert [vector_row.vector_size(w, 8) for w in widths] == \
        [2, 2, 2, 4, 4, 4, 8, 8, 16, 16, 32, 32, 32]
    assert [vector_row.vector_size(w, 4) for w in widths] == \
        [2, 2, 2, 2, 2, 2, 4, 4, 8, 8, 16, 32, 32]


def test_rowsum_checks_its_input():
    ell = ELL(torch.zeros(8, 8, dtype=torch.int32), torch.zeros(8, 8, dtype=torch.float64),
              (8, 5))
    with pytest.raises(ValueError):
        vector_row.ell_rowsum(ell, torch.zeros(6, dtype=torch.float64))
    with pytest.raises(ValueError):
        vector_row.ell_rowsum(ell, torch.zeros(5, dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rowsum_of_matrix_without_columns_is_zero(dtype):
    """csr_to_ell pads an m x 0 matrix to a slab of column-0 cells; the row
    sums are zeros, with no read of the empty x."""
    csr = CSR.from_numpy(np.zeros(6, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, dtype=np.dtype(str(dtype).split(".")[1])), (5, 0))
    ell = csr_to_ell(csr)
    assert ell.width > 0
    x = torch.zeros(0, dtype=dtype)
    for fn in (vector_row.ell_rowsum, vector_row.ell_rowsum_plain):
        got = fn(ell, x)
        assert got.dtype == dtype and torch.equal(got, torch.zeros(ell.padded_rows, dtype=dtype))
