"""The port's strategy zoo against the JAX package's ``spmv`` on the same inputs,
mirroring ``tests/test_spmv_strategies.py``: every strategy on every matrix, the
WF_REDUCE orders, the dense-row spill, float32, the transpose, and the picker's
decision tree below the swell gate.

Tolerances, element-wise against the JAX output, with
``B = |alpha|·|A|·|x| + |beta|·|y|`` per row (float64 host sums):
  * float64: ``|port - JAX| <= 1e-12 · B`` (both sum in float64 in other
    orders), and both pass ``verify_y`` against ``host_spmv`` (rel 1e-7);
  * float32: ``|port - JAX| <= 1e-5 · B`` (both sum float32 products, in other
    orders and, in the port's kernels, in FP64), and both pass the f32 gate.
``adaptive_plus`` is held against JAX in ``test_torch_adaptive_plus.py``: its
JAX float64 path runs the df64 Pallas kernel in interpret mode, seconds a
matrix.  For ``vector_row`` the JAX reference is its own computation, the ELL
slab's row sums by ``ell_rowsum_pallas`` then the alpha/beta combine, with the
slab zero-padded to whole 256 x 512 kernel tiles: in interpret mode the JAX
kernel reads past a smaller slab and returns NaN on every row, which its
``verify_y`` lets pass (NaN compares false)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu import dispatch as ref_dispatch
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.vector_row import TILE_M, TILE_W, ell_rowsum_pallas
from spmv_acc_tpu_torch import dispatch
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import zoo
from spmv_acc_tpu_torch.utils.verify import verify_y

# tests/test_spmv_strategies.py's MATRICES
MATRICES = {
    "banded": lambda: banded_csr(200, bandwidth=5, seed=0),
    "random": lambda: random_csr(150, 120, 1800, seed=1),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=2),
    "outlier": lambda: dense_row_outlier_csr(128, 128, avg_nnz=3, n_dense=2, seed=3),
    "short_rows": lambda: random_csr(300, 300, 600, seed=4),
    "tiny": lambda: random_csr(5, 7, 12, seed=5),
    "single_row": lambda: random_csr(1, 64, 30, seed=6),
}
TOL = {np.float64: 1e-12, np.float32: 1e-5}
STRATEGIES = sorted(dispatch.STRATEGIES - {"adaptive_plus"})


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    dispatch.clear_caches()


def _tile_padded(a):
    out = np.zeros((-(-a.shape[0] // TILE_M) * TILE_M, -(-a.shape[1] // TILE_W) * TILE_W),
                   a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _ref_vector_row(ref, x, y, alpha, beta):
    """JAX's vector_row on the CPU (spmv_acc_tpu/ops/vector_row.py:153-168) on
    a slab padded to whole kernel tiles."""
    ell = ref_dispatch._get_ell(ref, ref_dispatch.DEFAULT_TUNE)
    vals = np.asarray(ell.values)
    xg = np.asarray(x, dtype=vals.dtype)[np.asarray(ell.col_idx)]
    ax = ell_rowsum_pallas(jnp.asarray(_tile_padded(vals)), jnp.asarray(_tile_padded(xg)))
    ax = np.asarray(ax)[: ref.shape[0]]
    return vals.dtype.type(alpha) * ax + vals.dtype.type(beta) * y.astype(vals.dtype)


def _both(ref, x, y, alpha, beta, strategy, trans="N"):
    """(port output, JAX output, row bound B, golden) on the same inputs."""
    if strategy == "vector_row":
        t = ref_dispatch._get_transposed(ref) if trans == "T" else ref
        ref_out = _ref_vector_row(t, x, y, alpha, beta)
    else:
        ref_out = np.asarray(ref_dispatch.spmv(ref, jnp.asarray(x), jnp.asarray(y), alpha,
                                               beta, trans=trans, strategy=strategy))
    rp, ci, v, _ = ref.to_numpy()
    csr = CSR.from_numpy(rp, ci, v, ref.shape)
    out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), alpha, beta, trans=trans,
                        strategy=strategy)
    if trans == "T":
        rp, ci, v = dispatch._get_transposed(csr).to_numpy()[:3]
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    bound = host_spmv(abs(alpha), abs(beta), rp, ci, np.abs(f64(v)), np.abs(f64(x)),
                      np.abs(f64(y)))
    return out.numpy(), ref_out, bound, host_spmv(alpha, beta, rp, ci, v, x, y)


def _check(out, ref_out, bound, golden, dtype=np.float64):
    assert out.dtype == dtype and out.shape == ref_out.shape
    assert np.isfinite(out).all() and np.isfinite(ref_out).all()
    gap = np.abs(out.astype(np.float64) - ref_out.astype(np.float64))
    assert (gap <= TOL[dtype] * bound).all(), float(gap.max())
    assert verify_y(out, golden, dtype=dtype).ok
    assert verify_y(ref_out, golden, dtype=dtype).ok


@pytest.mark.parametrize("matrix_name", sorted(MATRICES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_reference(matrix_name, strategy):
    ref = MATRICES[matrix_name]()
    m, n = ref.shape
    x, y = random_x_y(n, m, seed=11)
    _check(*_both(ref, x, y, 1.25, -0.5, strategy))


@pytest.mark.parametrize("mode", ["default", "reg", "lds"])
@pytest.mark.parametrize("strategy", ["wf_row", "block_row"])
def test_wf_reduce_variants_match_reference(strategy, mode, monkeypatch):
    """The WF_REDUCE build flag's three reduce orders (config.cmake:30-34)."""
    monkeypatch.setenv("SPMV_TPU_WF_REDUCE", mode)
    ref = MATRICES["powerlaw"]()
    x, y = random_x_y(ref.shape[1], ref.shape[0], seed=21)
    assert zoo._wf_reduce_mode() is zoo._WF_REDUCERS[mode]
    _check(*_both(ref, x, y, 0.75, 2.0, strategy))


@pytest.mark.parametrize("strategy", ["thread_row", "wf_row", "block_row", "light", "acsr"])
def test_zoo_dense_row_spill(strategy):
    """A 100k-nnz row does not make a pack O(m * 100k): cells past the width cap
    spill to the COO tail, as in the reference."""
    ref = dense_row_outlier_csr(1000, 200_000, avg_nnz=3, n_dense=1, seed=21)
    m, n = ref.shape
    csr = CSR.from_numpy(*ref.to_numpy())
    assert int(np.diff(csr.to_numpy()[0]).max()) >= 100_000
    cols, vals, tail = zoo._row_packed(csr, 8)
    assert cols.shape[1] <= zoo._WIDTH_CAP and tail[0].numel() > 0
    x, y = random_x_y(n, m, seed=22)
    _check(*_both(ref, x, y, 1.5, -0.5, strategy))


@pytest.mark.parametrize("strategy", ["default", "line", "ell", "flat", "vector_row",
                                      "thread_row", "wf_row", "light", "line_enhance", "acsr"])
def test_float32_matches_reference(strategy):
    ref = random_csr(64, 64, 400, seed=10).astype(jnp.float32)
    x, y = random_x_y(64, 64, seed=15, dtype=np.float32)
    _check(*_both(ref, x, y, 1.0, 1.0, strategy), dtype=np.float32)


@pytest.mark.parametrize("strategy", ["default", "line", "flat", "vector_row", "acsr"])
def test_transpose_matches_reference(strategy):
    ref = random_csr(50, 70, 400, seed=8)
    x, y = random_x_y(50, 70, seed=9)  # A^T is 70 x 50
    out, ref_out, bound, golden = _both(ref, x, y, 1.25, -0.5, strategy, trans="T")
    assert out.shape == (70,)
    _check(out, ref_out, bound, golden)


@pytest.mark.parametrize("matrix_name", sorted(MATRICES))
def test_picker_tree_branch_matches_reference(matrix_name, monkeypatch):
    """Below the swell gate the port walks the reference's decision tree: it
    picks what the JAX package picks on the CPU and matches its output."""
    monkeypatch.setattr(dispatch, "SWELL_MIN_FILL", 2.0)
    ref = MATRICES[matrix_name]()
    m, n = ref.shape
    x, y = random_x_y(n, m, seed=12)
    csr = CSR.from_numpy(*ref.to_numpy())
    expect = ref_dispatch.pick_strategy(ref_dispatch.get_plan(ref), ref)
    h = dispatch.Handle()
    out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), 1.0, 1.0, handle=h)
    assert h.strategy_used == expect
    ref_out, bound, golden = _both(ref, x, y, 1.0, 1.0, expect)[1:]
    assert np.isfinite(ref_out).all()
    _check(out.numpy(), ref_out, bound, golden)


def test_pack_cache_sees_new_values():
    """A CSR sharing row_ptr (and col_idx) with a cached one but holding new
    values gets a new pack (the JAX package keys packs on row_ptr alone)."""
    ref = MATRICES["random"]()
    rp, ci, v, shape = ref.to_numpy()
    a = CSR.from_numpy(rp, ci, v, shape)
    b = CSR(a.row_ptr, a.col_idx, a.values * 2.0, shape)
    x = torch.from_numpy(random_x_y(shape[1], shape[0], seed=13)[0])
    for s in ("thread_row", "acsr", "light"):
        ya = dispatch.spmv(a, x, strategy=s)
        yb = dispatch.spmv(b, x, strategy=s)
        assert torch.allclose(yb, 2.0 * ya, rtol=1e-14, atol=0)


def _ref_flat_choice(plan):
    """The JAX package's spmv_flat choice from its plan
    (spmv_acc_tpu/ops/flat.py::spmv_flat): (rows per chunk, two-level)."""
    from spmv_acc_tpu.ops.flat import MAX_ROWS_PER_CHUNK

    cfr = np.asarray(plan.chunk_first_row)
    span = cfr[1:] - cfr[:-1]
    rpc = min(-(-(int(span.max()) + 1) // 8) * 8, MAX_ROWS_PER_CHUNK)
    return rpc, bool((span + 1 <= rpc).all()) and plan.num_chunks > 1


@pytest.mark.parametrize("matrix_name", sorted(MATRICES) + ["several_chunks",
                                                         "chunks_past_the_row_cap"])
def test_flat_plan_choice_matches_reference(matrix_name):
    """flat's rows per chunk and its two-level/direct choice, made once in the
    port's plan (no SpMV reads them back from the device), equal the choice the
    JAX package's spmv_flat makes on every call; a chunk spanning more rows
    than the cap sends flat to the direct sum."""
    from spmv_acc_tpu.plan import get_plan as ref_get_plan
    from spmv_acc_tpu.formats.containers import CSR as RefCSR
    from spmv_acc_tpu_torch.plan import get_plan

    ref = {"several_chunks": lambda: banded_csr(4000, bandwidth=17, seed=9),
           "chunks_past_the_row_cap": lambda: random_csr(20000, 50, 300, seed=8),
           **MATRICES}[matrix_name]()
    rp, ci, v, shape = ref.to_numpy()
    plan = get_plan(CSR.from_numpy(rp, ci, v, shape))
    want = _ref_flat_choice(ref_get_plan(RefCSR.from_numpy(rp, ci, v, shape)))
    assert (plan.flat_rows_per_chunk, plan.flat_two_level) == want
    if matrix_name == "chunks_past_the_row_cap":
        assert want == (1024, False)
    if matrix_name == "several_chunks":
        assert plan.num_chunks > 1 and want[1]
