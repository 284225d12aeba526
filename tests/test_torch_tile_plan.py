"""The port's tile plan (``ops/tile_plan.py``) against the JAX package's, array
for array, on the native branch (``native/spmv_native.cpp::tile_analyze``) and
on the numpy branch, and the device layout the port builds from it.

Tolerance: none.  The plan is integer bookkeeping plus copies of the values, so
every array must be equal, dtype included; ``fill_efficiency`` is the same
quotient of the same integers."""

import numpy as np
import pytest

from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.io import native as ref_native
from spmv_acc_tpu.ops.tile_plan import build_tile_plan as ref_build_tile_plan
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.io import native as port_native
from spmv_acc_tpu_torch.ops import adaptive_plus
from spmv_acc_tpu_torch.ops.tile_plan import BUCKETS, COL_WINDOW, LANES, build_tile_plan

# tests/test_adaptive_plus.py's MATRICES, plus tests/test_tile_plan.py's shapes
MATRICES = {
    "banded": lambda: banded_csr(200, bandwidth=5, seed=70),
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=72),
    "outlier": lambda: dense_row_outlier_csr(140, 140, avg_nnz=3, n_dense=2, seed=73),
    "window_dense": lambda: random_csr(64, 100, 3000, seed=74),
    "tall": lambda: random_csr(500, 70, 2000, seed=64),
    "wide": lambda: random_csr(70, 500, 2000, seed=65),
}

FIELDS = ("values", "local_idx", "col_tile", "row_block", "flush")


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    """Build the shared native library through the port's locked, atomic build
    before the reference's loader reads it."""
    port_native.get_lib()


def _plans(name, branch, monkeypatch):
    if branch == "numpy":
        monkeypatch.setattr(ref_native, "tile_analyze_native", lambda *a: None)
        monkeypatch.setattr(port_native, "tile_analyze_native", lambda *a: None)
    elif not port_native.available() or ref_native.get_lib() is None:
        pytest.skip("the native analyze library could not be built")
    arrays = MATRICES[name]().to_numpy()
    return ref_build_tile_plan(*arrays), build_tile_plan(*arrays)


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_tile_plan_matches_reference(name, branch, monkeypatch):
    ref, got = _plans(name, branch, monkeypatch)
    for f in ("num_row_blocks", "num_col_tiles", "rows", "cols", "nnz", "fill_efficiency"):
        assert getattr(got, f) == getattr(ref, f), f
    assert [b.depth for b in got.buckets] == [b.depth for b in ref.buckets]
    for rb, gb in zip(ref.buckets, got.buckets):
        assert (gb.num_blocks, gb.nnz) == (rb.num_blocks, rb.nnz)
        for f in FIELDS:
            a, b = getattr(rb, f), getattr(gb, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (gb.depth, f)
    assert sorted(got.touched) == sorted(ref.touched)
    for d in ref.touched:
        assert np.array_equal(got.touched[d], ref.touched[d])


def test_empty_matrix_plan():
    rp = np.zeros(6, np.int32)
    for build in (ref_build_tile_plan, build_tile_plan):
        p = build(rp, np.zeros(0, np.int32), np.zeros(0), (5, 300))
        assert p.buckets == () and p.fill_efficiency == 1.0 and p.num_col_tiles == 3


@pytest.mark.parametrize("name", ["random", "outlier", "window_dense"])
def test_device_layout_orders_blocks_by_row_block_bucket_tile(name):
    """The GPU layout holds every bucket's blocks once, contiguous, sorted by
    (row block, bucket, column tile), with a row-block pointer over them."""
    rp, ci, v, shape = MATRICES[name]().to_numpy()
    plan = build_tile_plan(rp, ci, v, shape)
    dp = adaptive_plus.get_tile_plan(CSR.from_numpy(rp, ci, v, shape))
    depth, ct = dp.blk_depth.numpy(), dp.blk_ct.numpy()
    rb_ptr = dp.rb_ptr.numpy()
    rb = np.repeat(np.arange(plan.num_row_blocks), np.diff(rb_ptr))
    bucket = np.searchsorted(BUCKETS, depth)
    assert np.array_equal(np.lexsort((ct, bucket, rb)), np.arange(len(rb)))
    assert np.array_equal(dp.blk_off.numpy(), np.concatenate([[0], np.cumsum(depth)[:-1]]))
    assert dp.slots == LANES * sum(b.num_blocks * b.depth for b in plan.buckets)
    assert dp.lidx.dtype.itemsize == 1 and int(dp.lidx.max()) < COL_WINDOW
    for b in plan.buckets:
        assert (depth == b.depth).sum() == b.num_blocks
    adaptive_plus.clear_tile_cache()
