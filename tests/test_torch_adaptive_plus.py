"""The port's ``adaptive_plus`` strategy against the JAX package's, whose tile
kernels run in Pallas interpret mode on the CPU, and against the golden; the
dropped VMEM column cap; the identity-checked tile-plan cache.

On a CPU tensor ``tile_spmv`` runs its plain version (float64 sums over the
same layout the Hopper kernel reads).  Tolerances, element-wise, with
``B = |alpha|·|A|·|x| + |beta|·|y|`` per row:
  * float64: ``|port - JAX| <= 1e-12 · B`` (JAX's df64 kernel is ~1e-14
    relative), and both pass ``verify_y`` (rel 1e-7);
  * float32: ``|port - JAX| <= 1e-5 · B`` (JAX sums float32 products in
    float32, the port in float64), and both pass the f32 gate.
JAX's float64 kernel takes seconds a matrix in interpret mode, so it runs at the
sizes of the non-slow JAX tests (``tests/test_adaptive_plus.py``); the other
matrices are held against JAX in float32 and against the golden in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu import dispatch as ref_dispatch
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.adaptive_plus import X_VMEM_LIMIT_F64
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu_torch import dispatch
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import adaptive_plus
from spmv_acc_tpu_torch.utils.verify import verify_y

ALPHA, BETA = 1.25, -0.5
TOL = {np.float64: 1e-12, np.float32: 1e-5}

# tests/test_adaptive_plus.py's MATRICES and tests/test_spmv_strategies.py's
MATRICES = {
    "banded": lambda: banded_csr(200, bandwidth=5, seed=70),
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=72),
    "outlier": lambda: dense_row_outlier_csr(140, 140, avg_nnz=3, n_dense=2, seed=73),
    "window_dense": lambda: random_csr(64, 100, 3000, seed=74),
    "short_rows": lambda: random_csr(300, 300, 600, seed=4),
    "tiny": lambda: random_csr(5, 7, 12, seed=5),
    "single_row": lambda: random_csr(1, 64, 30, seed=6),
}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    dispatch.clear_caches()


def _run(ref, dtype, seed, with_jax=True):
    """(port output, JAX output or None, bound B, golden)."""
    if dtype == np.float32:
        ref = ref.astype(jnp.float32)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=seed, dtype=dtype)
    ref_out = None
    if with_jax:
        ref_out = np.asarray(ref_dispatch.spmv(ref, jnp.asarray(x), jnp.asarray(y), ALPHA, BETA,
                                               strategy="adaptive_plus"))
    out = dispatch.spmv(CSR.from_numpy(rp, ci, v, (m, n)), torch.from_numpy(x),
                        torch.from_numpy(y), ALPHA, BETA, strategy="adaptive_plus").numpy()
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    bound = host_spmv(abs(ALPHA), abs(BETA), rp, ci, np.abs(f64(v)), np.abs(f64(x)),
                      np.abs(f64(y)))
    return out, ref_out, bound, host_spmv(ALPHA, BETA, rp, ci, v, x, y)


def _check(out, ref_out, bound, golden, dtype):
    assert out.dtype == dtype and np.isfinite(out).all()
    assert verify_y(out, golden, dtype=dtype).ok
    if ref_out is not None:
        assert np.isfinite(ref_out).all() and verify_y(ref_out, golden, dtype=dtype).ok
        gap = np.abs(out.astype(np.float64) - ref_out.astype(np.float64))
        assert (gap <= TOL[dtype] * bound).all(), float(gap.max())


@pytest.mark.parametrize("case", ["f64-100x100", "f32-120x120"])
def test_adaptive_plus_matches_reference(case):
    """The non-slow JAX tests' matrices (test_adaptive_plus.py:37-56), both dtypes."""
    if case.startswith("f64"):
        ref, dtype, seed = random_csr(100, 100, 2000, seed=78), np.float64, 79
    else:
        ref, dtype, seed = random_csr(120, 120, 900, seed=76), np.float32, 77
    _check(*_run(ref, dtype, seed), dtype)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_adaptive_plus_f32_matches_reference(name):
    _check(*_run(MATRICES[name](), np.float32, 75), np.float32)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_adaptive_plus_f64_matches_golden(name):
    _check(*_run(MATRICES[name](), np.float64, 75, with_jax=False), np.float64)


def test_make_spmv_fn_and_shim_match_spmv():
    ref = MATRICES["powerlaw"]()
    rp, ci, v, (m, n) = ref.to_numpy()
    csr = CSR.from_numpy(rp, ci, v, (m, n))
    x, y = (torch.from_numpy(a) for a in random_x_y(n, m, seed=5))
    fn, chosen = dispatch.make_spmv_fn(csr, ALPHA, BETA, strategy="adaptive_plus")
    assert chosen == "adaptive_plus"
    want = dispatch.spmv(csr, x, y, ALPHA, BETA, strategy="adaptive_plus")
    assert torch.equal(fn(x, y), want)
    assert torch.equal(dispatch.sparse_csr_spmv("N", ALPHA, BETA, csr, x, y, "adaptive_plus"),
                       want)
    assert sum(adaptive_plus.LAUNCHES.values()) == 0  # CPU tensors run the plain version


def test_columns_past_vmem_limit_run():
    """The JAX package refuses adaptive_plus past X_VMEM_LIMIT_F64 columns (x had
    to fit in VMEM); the port reads x from device memory and runs it."""
    n = X_VMEM_LIMIT_F64 + 1000
    rng = np.random.default_rng(3)
    m, nnz = 300, 3000
    rows = np.sort(rng.integers(0, m, nnz))
    cols = rng.integers(0, n, nnz)
    cols[:3] = n - 1  # the last column tile is touched
    from spmv_acc_tpu_torch.formats.convert import coo_to_csr_arrays

    rp, ci, v = coo_to_csr_arrays(rows, cols, rng.uniform(-1, 1, nnz), (m, n))
    x, y = random_x_y(n, m, seed=4)
    out = dispatch.spmv(CSR.from_numpy(rp, ci, v, (m, n)), torch.from_numpy(x),
                        torch.from_numpy(y), ALPHA, BETA, strategy="adaptive_plus")
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok


def test_new_values_get_a_fresh_plan():
    """A CSR sharing row_ptr and col_idx with a cached one but holding new values
    gets a new tile plan (the JAX cache keys on row_ptr alone,
    spmv_acc_tpu/ops/adaptive_plus.py:339)."""
    rp, ci, v, shape = MATRICES["random"]().to_numpy()
    a = CSR.from_numpy(rp, ci, v, shape)
    b = CSR(a.row_ptr, a.col_idx, -3.0 * a.values, shape)
    dp = adaptive_plus.get_tile_plan(a)
    assert adaptive_plus.get_tile_plan(a) is dp
    assert adaptive_plus.get_tile_plan(b) is not dp
    x = torch.from_numpy(random_x_y(shape[1], shape[0], seed=6)[0])
    ya = dispatch.spmv(a, x, strategy="adaptive_plus")
    yb = dispatch.spmv(b, x, strategy="adaptive_plus")
    assert torch.allclose(yb, -3.0 * ya, rtol=1e-14, atol=0)


def test_named_wrappers_check_dtype():
    csr = CSR.from_numpy(*random_csr(40, 50, 300, seed=7).to_numpy())
    dp64 = adaptive_plus.get_tile_plan(csr)
    dp32 = adaptive_plus.get_tile_plan(csr, torch.float32)
    x = torch.from_numpy(random_x_y(50, 40, seed=8)[0])
    assert torch.equal(adaptive_plus.tile_spmv_df64(dp64, x),
                       adaptive_plus.tile_spmv_plain(dp64, x))
    assert adaptive_plus.tile_spmv_f32(dp32, x.float()).dtype == torch.float32
    with pytest.raises(ValueError):
        adaptive_plus.tile_spmv_f32(dp64, x)
    with pytest.raises(ValueError):
        adaptive_plus.tile_spmv_df64(dp32, x.float())
    with pytest.raises(ValueError):
        adaptive_plus.tile_spmv(dp64, x.float())
    with pytest.raises(ValueError):
        adaptive_plus.get_tile_plan(csr, torch.float16)
