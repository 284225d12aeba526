"""The port's swell slab decomposition and GPU layout against the JAX package's
plan: the same per-nnz slab keys as the native analyze pass, the same delta,
chunk count and COO tail, and a layout whose invariants the kernel relies on."""

import numpy as np
import pytest

from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays
from spmv_acc_tpu.formats.generate import example_like
from spmv_acc_tpu.io.native import swell_analyze_native as ref_native_analyze
from spmv_acc_tpu.ops.swell_plan import build_swell_plan as ref_build_swell_plan
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.io import native as port_native
from spmv_acc_tpu_torch.ops.swell_plan import build_swell_layout, swell_slabs

MATRICES = {
    "banded": lambda: banded_csr(300, bandwidth=5, seed=70),
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=72),
    "outlier": lambda: dense_row_outlier_csr(140, 140, avg_nnz=3, n_dense=2, seed=73),
    "window_dense": lambda: random_csr(64, 100, 3000, seed=74),
    "tall": lambda: random_csr(40000, 300, 9000, seed=75),
    "wide": lambda: random_csr(300, 40000, 9000, seed=76),
    "single_col": lambda: random_csr(200, 1, 180, seed=77),
    "rajat03": lambda: example_like("rajat03"),
    "dw4096": lambda: example_like("dw4096"),
    "af23560": lambda: example_like("af23560"),
}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    """Build the shared native library through the port's locked, atomic build
    before the reference's loader reads it, so a concurrent in-place build in
    another test worker cannot hand that loader a half-written file."""
    port_native.get_lib()


def _port_numpy_slabs(arrays, monkeypatch):
    monkeypatch.setenv("SPMV_TPU_NO_NATIVE", "1")
    sl = swell_slabs(*arrays)
    monkeypatch.delenv("SPMV_TPU_NO_NATIVE")
    return sl


def _keys(rb, w, k, slot, lane, lidx):
    """Sorted per-nnz (slab_rb, slab_w, slab_k, slot_in_slab, lane, lidx) keys."""
    i64 = [np.asarray(a, dtype=np.int64) for a in (rb, w, k, slot, lane, lidx)]
    rb, w, k, slot, lane, lidx = i64
    return np.sort(((((rb * 2**31 + w) * 8 + k) * 128 + slot) * 128 + lane) * 256 + lidx)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_numpy_slabs_match_reference_native(name, monkeypatch):
    rp, ci, v, shape = MATRICES[name]().to_numpy()
    sl = _port_numpy_slabs((rp, ci, v, shape), monkeypatch)
    assert len(sl.tail_v) == 0
    nat = ref_native_analyze(rp, ci, shape[0], sl.delta)
    if nat is None:
        pytest.skip("the native analyze library could not be built")
    s32, lc, slot, _, srb, sw, sk, _ = nat
    lane = np.repeat(np.arange(shape[0]), np.diff(rp)) & 127
    ref_keys = _keys(srb[s32], sw[s32], sk[s32], slot, lane, lc)
    s = sl.slab_of_nnz
    got = _keys(sl.slab_rb[s], sl.slab_w[s], sl.slab_k[s], sl.slot_in_slab, sl.lane, sl.lidx)
    assert np.array_equal(ref_keys, got)


@pytest.mark.parametrize("name", ["powerlaw", "wide", "af23560"])
def test_port_native_branch_matches_numpy(name, monkeypatch):
    arrays = MATRICES[name]().to_numpy()
    nat = swell_slabs(*arrays)
    ref = _port_numpy_slabs(arrays, monkeypatch)
    s, r = nat.slab_of_nnz, ref.slab_of_nnz
    assert np.array_equal(
        _keys(nat.slab_rb[s], nat.slab_w[s], nat.slab_k[s], nat.slot_in_slab, nat.lane, nat.lidx),
        _keys(ref.slab_rb[r], ref.slab_w[r], ref.slab_k[r], ref.slot_in_slab, ref.lane, ref.lidx))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_delta_chunks_tail_match_reference(name, monkeypatch):
    arrays = MATRICES[name]().to_numpy()
    ref = ref_build_swell_plan(*arrays)
    sl = _port_numpy_slabs(arrays, monkeypatch)
    assert (sl.delta, sl.nchunks, sl.nnz) == (ref.delta, ref.nchunks, ref.nnz)
    for a, b in ((sl.tail_rows, ref.tail_rows), (sl.tail_ci, ref.tail_ci), (sl.tail_v, ref.tail_v)):
        assert np.array_equal(a, b)


def _check_layout(lay, sl, arrays):
    rp, ci, v, (m, n) = arrays
    size = np.int64(128) << lay.slab_log2d.astype(np.int64)
    # slabs tile the slot arrays back to back, 128-aligned
    assert lay.slots == int(size.sum()) >= lay.kernel_nnz == len(sl.values)
    assert np.array_equal(lay.slab_off, np.concatenate([[0], np.cumsum(size)[:-1]]))
    assert lay.mrb == max(1, -(-m // 128))
    assert lay.rb_slab_ptr[0] == 0 and lay.rb_slab_ptr[-1] == lay.nslabs
    assert (np.diff(lay.rb_slab_ptr) >= 0).all()
    assert 0.0 < lay.fill <= 1.0
    # every real slot reads an in-range column; the slot sum is the kernel's nnz
    slab_of_slot = np.repeat(np.arange(lay.nslabs), size)
    col = lay.slab_col_base[slab_of_slot].astype(np.int64) + lay.lidx
    real = lay.vals != 0
    assert ((col[real] >= 0) & (col[real] < n)).all()
    # each slot multiplies the same value into the same row and column as the CSR
    rb_of_slab = np.repeat(np.arange(lay.mrb), np.diff(lay.rb_slab_ptr))
    row = rb_of_slab[slab_of_slot] * 128 + np.arange(lay.slots) % 128
    got = _triplets(np.concatenate([row[real], lay.tail_rows]),
                    np.concatenate([col[real], lay.tail_ci]),
                    np.concatenate([lay.vals[real], lay.tail_v]), n)
    ref = _triplets(np.repeat(np.arange(m), np.diff(rp)), ci, v, n)
    assert np.array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-14, atol=0)


def _triplets(rows, cols, vals, n):
    """(sorted unique row*n + col keys, summed values): the matrix as a set."""
    key = np.asarray(rows, np.int64) * n + np.asarray(cols, np.int64)
    keep = vals != 0
    u, inv = np.unique(key[keep], return_inverse=True)
    return u, np.bincount(inv.reshape(-1), weights=vals[keep], minlength=len(u))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_layout_invariants(name, monkeypatch):
    arrays = MATRICES[name]().to_numpy()
    sl = swell_slabs(*arrays)
    _check_layout(build_swell_layout(sl), sl, arrays)


def _banded_plus_outliers(m, seed, n_out=60):
    """Banded matrix plus scattered far-off-band entries, the structure the
    cell-economic spill targets (as in the JAX package's swell tests)."""
    base = banded_csr(m, bandwidth=5, seed=seed, dtype=np.float64)
    rp, ci, v, _ = base.to_numpy()
    rng = np.random.default_rng(seed + 1)
    rows_b = np.repeat(np.arange(m), np.diff(rp))
    ro = rng.integers(0, m, size=n_out)
    co = (ro + m // 2) % m
    vo = rng.uniform(-1, 1, size=n_out)
    rp2, ci2, v2 = coo_to_csr_arrays(np.concatenate([rows_b, ro]), np.concatenate([ci, co]),
                                     np.concatenate([v, vo]), (m, m))
    return RefCSR.from_numpy(rp2, ci2, v2, (m, m))


def test_forced_spill_tail_matches_reference(monkeypatch):
    monkeypatch.setenv("SPMV_TPU_SPILL", "16")
    arrays = _banded_plus_outliers(40_000, seed=11).to_numpy()
    ref = ref_build_swell_plan(*arrays)
    sl = swell_slabs(*arrays)
    assert len(sl.tail_v) > 0
    assert sl.delta == ref.delta
    for a, b in ((sl.tail_rows, ref.tail_rows), (sl.tail_ci, ref.tail_ci), (sl.tail_v, ref.tail_v)):
        assert np.array_equal(a, b)
    lay = build_swell_layout(sl)
    assert lay.kernel_nnz + len(lay.tail_v) == lay.nnz == len(arrays[2])
    assert (np.diff(lay.tail_rows) >= 0).all()


def test_duplicate_columns_canonicalized(monkeypatch):
    rng = np.random.default_rng(90)
    m = n = 96
    cols = rng.integers(0, n, size=5 * m).astype(np.int64)
    cols[:5] = [7, 3, 7, 7, 3]
    vals = rng.standard_normal(5 * m)
    rp = np.arange(0, 5 * m + 1, 5, dtype=np.int64)
    arrays = (rp, cols, vals, (m, n))
    sl = swell_slabs(*arrays)
    lay = build_swell_layout(sl)
    assert lay.kernel_nnz < 5 * m  # duplicates summed into one slot each
    _check_layout(lay, sl, arrays)


def test_empty_matrix_layout():
    sl = swell_slabs(np.zeros(4, np.int64), np.zeros(0, np.int64), np.zeros(0), (3, 5))
    lay = build_swell_layout(sl)
    assert lay.slots == 0 and lay.nslabs == 0 and lay.mrb == 1
    assert np.array_equal(lay.rb_slab_ptr, [0, 0])
