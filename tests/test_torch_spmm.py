"""The port's multi-RHS SpMM and BSR products against the JAX package's:
``spmm`` with every strategy, ``swell_amx`` (grouped columns, BSR x SpMM),
``make_swell_amx_run``, the kernel's column grouping, ``bsr_spmv`` /
``bsr_spmm`` and the ELL/BSR conversions.

Tolerances: every output passes ``verify_y`` against the float64 golden
(``host_spmm`` or a dense product; rel 1e-7, abs 1e-14 near zero), and port and
reference agree element-wise within 1e-12 * (|alpha||A|·|X| + |beta Y|): FP64
summation order differs, nothing else.  Conversions match array for array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import csr_to_bsr as ref_csr_to_bsr
from spmv_acc_tpu.formats import random_csr
from spmv_acc_tpu.formats.convert import csr_to_dense as ref_csr_to_dense
from spmv_acc_tpu.formats.convert import csr_to_ell_arrays as ref_csr_to_ell_arrays
from spmv_acc_tpu.formats.generate import banded_csr, example_like, fem_like_csr
from spmv_acc_tpu.ops.bsr import bsr_spmm as ref_bsr_spmm
from spmv_acc_tpu.ops.bsr import bsr_spmv as ref_bsr_spmv
from spmv_acc_tpu.ops.golden import host_spmm as ref_host_spmm
from spmv_acc_tpu.ops.spmm import spmm as ref_spmm
from spmv_acc_tpu_torch import bsr_spmm, bsr_spmv, csr_to_bsr, csr_to_ell, spmm
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.formats.convert import csr_to_dense, csr_to_ell_arrays
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.ops.golden import host_spmm
from spmv_acc_tpu_torch.utils.verify import verify_y

ROW_TOL = 1e-12


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _port(ref):
    return CSR.from_numpy(*ref.to_numpy())


def _close(out, ref_out, rp, ci, v, X, Y, alpha, beta):
    scale = host_spmm(abs(alpha), abs(beta), rp, ci, np.abs(v), np.abs(X), np.abs(Y))
    return bool((np.abs(np.asarray(out) - np.asarray(ref_out)) <= ROW_TOL * scale).all())


def test_host_spmm_matches_reference():
    rp, ci, v, (m, n) = random_csr(60, 50, 600, seed=30).to_numpy()
    rng = np.random.default_rng(4)
    X, Y = rng.random((n, 6)), rng.random((m, 6))
    assert np.array_equal(host_spmm(1.5, -0.5, rp, ci, v, X, Y),
                          ref_host_spmm(1.5, -0.5, rp, ci, v, X, Y))


@pytest.mark.parametrize("strategy", ["ell", "segment", "swell", "adaptive"])
@pytest.mark.parametrize("matrix", ["random", "powerlaw_like"])
def test_spmm_matches_reference(strategy, matrix):
    ref = (random_csr(60, 50, 600, seed=31) if matrix == "random"
           else example_like("rajat03"))
    rp, ci, v, (m, n) = ref.to_numpy()
    rng = np.random.default_rng(5)
    X, Y = rng.random((n, 8)), rng.random((m, 8))
    golden = host_spmm(1.5, -0.5, rp, ci, v, X, Y)
    out = spmm(_port(ref), torch.from_numpy(X), torch.from_numpy(Y), alpha=1.5, beta=-0.5,
               strategy=strategy)
    assert out.shape == (m, 8) and out.dtype == torch.float64
    assert verify_y(out.numpy().ravel(), golden.ravel()).ok
    ref_out = np.asarray(ref_spmm(ref, jnp.asarray(X), jnp.asarray(Y), alpha=1.5, beta=-0.5,
                                  strategy=strategy))
    assert _close(out.numpy(), ref_out, rp, ci, v, X, Y, 1.5, -0.5)


def test_spmm_default_y():
    ref = random_csr(40, 30, 300, seed=32)
    rp, ci, v, (m, n) = ref.to_numpy()
    X = np.random.default_rng(6).random((n, 3))
    out = spmm(_port(ref), torch.from_numpy(X), strategy="segment", alpha=2.0, beta=7.0)
    assert verify_y(out.numpy().ravel(), host_spmm(2.0, 0.0, rp, ci, v, X, np.zeros((m, 3))).ravel()).ok
    with pytest.raises(ValueError):
        spmm(_port(ref), torch.from_numpy(X), strategy="nope")


def test_spmm_swell_multirhs_groups(monkeypatch):
    """k = 5, the reference in groups of 2 (its last group zero-padded); the
    port's kernel masks the spare columns of its last group instead."""
    monkeypatch.setenv("SPMV_TPU_SPMM_GROUP", "2")
    ref = random_csr(60, 50, 600, seed=36)
    rp, ci, v, (m, n) = ref.to_numpy()
    rng = np.random.default_rng(8)
    X, Y = rng.random((n, 5)), rng.random((m, 5))
    golden = host_spmm(2.0, 0.5, rp, ci, v, X, Y)
    ref_out = np.asarray(ref_spmm(ref, jnp.asarray(X), jnp.asarray(Y), alpha=2.0, beta=0.5,
                                  strategy="swell"))
    out = spmm(_port(ref), torch.from_numpy(X), torch.from_numpy(Y), alpha=2.0, beta=0.5,
               strategy="swell").numpy()
    assert verify_y(out.ravel(), golden.ravel()).ok and verify_y(ref_out.ravel(), golden.ravel()).ok
    assert _close(out, ref_out, rp, ci, v, X, Y, 2.0, 0.5)


@pytest.mark.parametrize("r", [2, 3, 4])
def test_spmm_swell_bsr_combined(r, monkeypatch):
    """BSR micro-blocks x multi-RHS (r x k = 5 columns): the reference pinned to
    r with SPMV_TPU_BSR, the port's plan with r."""
    monkeypatch.setenv("SPMV_TPU_BSR", str(r))
    monkeypatch.setenv("SPMV_TPU_NO_PLAN_CACHE", "1")
    ref = banded_csr(100, bandwidth=4, seed=37)
    rp, ci, v, (m, n) = ref.to_numpy()
    rng = np.random.default_rng(9)
    X, Y = rng.random((n, 5)), rng.random((m, 5))
    golden = host_spmm(1.0, 0.0, rp, ci, v, X, Y)
    ref_out = np.asarray(ref_spmm(ref, jnp.asarray(X), jnp.asarray(Y), strategy="swell"))
    layout = swell.get_swell_plan(_port(ref), r=r)
    assert layout.r == r
    out = swell.swell_amx(layout, torch.from_numpy(X)).numpy()
    assert verify_y(out.ravel(), golden.ravel()).ok
    assert _close(out, ref_out, rp, ci, v, X, Y, 1.0, 0.0)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_swell_amx_columns_match_swell_ax(r, k):
    ref = fem_like_csr(257, 257, 6000, block=4, seed=38, dtype=np.float64)
    csr = _port(ref)
    layout = swell.get_swell_plan(csr, r=r)
    X = torch.from_numpy(np.random.default_rng(10).standard_normal((257, k)))
    Y = swell.swell_amx(layout, X)
    assert Y.shape == (257, k)
    for j in range(k):
        assert torch.allclose(Y[:, j], swell.swell_ax(layout, X[:, j].contiguous()),
                              rtol=1e-14, atol=1e-14)
    assert torch.equal(Y, swell.swell_amx_plain(layout, X))


def test_swell_amx_checks_inputs():
    layout = swell.get_swell_plan(_port(random_csr(50, 60, 300, seed=39)))
    with pytest.raises(ValueError):
        swell.swell_amx(layout, torch.zeros(59, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        swell.swell_amx(layout, torch.zeros(60, 0, dtype=torch.float64))
    with pytest.raises(ValueError):
        swell.swell_amx(layout, torch.zeros(60, 4, dtype=torch.float64)[:, ::2])
    with pytest.raises(ValueError):
        swell.swell_amx(layout, torch.zeros(60, 2, dtype=torch.float32))
    with pytest.raises(TypeError):
        swell.swell_amx(layout, np.zeros((60, 2)))


def test_make_swell_amx_run_chains():
    ref = banded_csr(300, bandwidth=5, seed=70)
    X = np.random.default_rng(11).random((300, 8))
    run = swell.make_swell_amx_run(_port(ref), 8)
    Xs = run(torch.from_numpy(X), 3)
    assert Xs.shape == (300, 8) and torch.isfinite(Xs).all()
    assert torch.allclose(Xs, torch.from_numpy(X), rtol=1e-15, atol=0)
    with pytest.raises(ValueError):
        run(torch.from_numpy(X[:, :4].copy()), 1)
    with pytest.raises(ValueError):
        swell.make_swell_amx_run(_port(random_csr(40, 50, 200, seed=40)), 2)


@pytest.mark.parametrize("r,k,g", [(1, 1, 1), (1, 3, 4), (1, 5, 8), (1, 8, 8), (1, 20, 8),
                                   (2, 3, 4), (2, 8, 4), (3, 1, 1), (3, 5, 2), (4, 8, 2)])
def test_kernel_group(r, k, g):
    """Columns per kernel block: the reference's max(1, 8 // r), shrunk to the
    next power of two above k; only these (r, g) pairs are instantiated."""
    assert swell.kernel_group(r, k) == g


def test_bsr_spmv_matches_dense_and_reference():
    ref = random_csr(32, 48, 300, seed=32)
    rbsr = ref_csr_to_bsr(ref, blocksize=(8, 16))
    bsr = csr_to_bsr(_port(ref), blocksize=(8, 16))
    assert bsr.shape == rbsr.shape == (32, 48) and bsr.blocksize == (8, 16)
    for a, b in ((bsr.row_ptr, rbsr.row_ptr), (bsr.col_idx, rbsr.col_idx),
                 (bsr.values, rbsr.values)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(6).random(48)
    golden = csr_to_dense(*ref.to_numpy()) @ x
    out = bsr_spmv(bsr, torch.from_numpy(x)).numpy()
    assert verify_y(out, golden).ok
    np.testing.assert_allclose(out, np.asarray(ref_bsr_spmv(rbsr, jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)
    y = np.random.default_rng(7).random(32)
    out2 = bsr_spmv(bsr, torch.from_numpy(x), torch.from_numpy(y), 2.0, -1.0).numpy()
    assert verify_y(out2, 2.0 * golden - y).ok


def test_bsr_spmm_matches_dense_and_reference():
    ref = random_csr(24, 30, 200, seed=33)
    rbsr = ref_csr_to_bsr(ref, blocksize=(8, 16))
    bsr = csr_to_bsr(_port(ref), blocksize=(8, 16))
    assert bsr.shape == (24, 32) and bsr.nblocks == rbsr.nblocks
    X = np.random.default_rng(7).random((32, 4))
    dpad = np.zeros(bsr.shape)
    dpad[:24, :30] = csr_to_dense(*ref.to_numpy())
    out = bsr_spmm(bsr, torch.from_numpy(X)).numpy()
    assert verify_y(out.ravel(), (dpad @ X).ravel()).ok
    np.testing.assert_allclose(out, np.asarray(ref_bsr_spmm(rbsr, jnp.asarray(X))),
                               rtol=1e-13, atol=1e-13)


def test_conversions_match_reference():
    ref = random_csr(37, 45, 400, seed=34)
    arrays = ref.to_numpy()
    assert np.array_equal(csr_to_dense(*arrays), ref_csr_to_dense(*arrays))
    for a, b in zip(csr_to_ell_arrays(*arrays), ref_csr_to_ell_arrays(*arrays)):
        assert np.array_equal(a, b)
    ell = csr_to_ell(_port(ref))
    ec, ev, width, mp = ref_csr_to_ell_arrays(*arrays)
    assert (ell.width, ell.padded_rows, ell.shape) == (width, mp, (37, 45))
    assert np.array_equal(ell.col_idx.numpy(), ec) and np.array_equal(ell.values.numpy(), ev)
