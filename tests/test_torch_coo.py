"""The port's COO container and its conversions against the JAX package's:
``COO.from_numpy``, ``coo_to_csr`` (repeated (row, col) entries summed, as
``spmv_acc_tpu/formats/convert.py:29-60``) and ``csr_to_coo``, array for array
on seeded numpy triplets, and the round trip CSR -> COO -> CSR."""

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import COO as RefCOO
from spmv_acc_tpu.formats import coo_to_csr as ref_coo_to_csr
from spmv_acc_tpu.formats import csr_to_coo as ref_csr_to_coo
from spmv_acc_tpu.formats.generate import banded_csr, example_like, powerlaw_csr, random_csr
from spmv_acc_tpu_torch import COO, coo_to_csr
from spmv_acc_tpu_torch.formats import CSR, csr_to_coo


def _triplets(seed, m, n, nnz, dups, dtype=np.float64):
    """Seeded triplets in random order; ``dups`` of them repeat an earlier
    (row, col) with a new value."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    if dups and nnz:
        src = rng.integers(0, nnz, dups)
        rows = np.concatenate([rows, rows[src]])
        cols = np.concatenate([cols, cols[src]])
        vals = np.concatenate([vals, rng.standard_normal(dups).astype(dtype)])
    order = rng.permutation(len(rows))
    return rows[order], cols[order], vals[order], (m, n)


TRIPLETS = {
    "square_dups": (1, 300, 300, 2000, 400),
    "rect_wide": (2, 40, 900, 1500, 100),
    "rect_tall": (3, 900, 40, 1500, 100),
    "no_dups": (4, 200, 200, 800, 0),
    "empty": (5, 50, 60, 0, 0),
}


def _assert_same(got, want):
    for a, b in zip(got[:3], want[:3]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tuple(got[3]) == tuple(want[3])


def _ref_coo_numpy(coo):
    return np.asarray(coo.rows), np.asarray(coo.cols), np.asarray(coo.values), coo.shape


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_coo_from_numpy_matches_reference(dtype):
    r, c, v, shape = _triplets(6, 120, 130, 700, 50, dtype)
    coo = COO.from_numpy(r, c, v, shape)
    assert coo.device.type == "cpu" and coo.nnz == len(v) and coo.dtype == torch.from_numpy(v).dtype
    _assert_same(coo.to_numpy(), _ref_coo_numpy(RefCOO.from_numpy(r, c, v, shape)))


def test_coo_keeps_float64_and_moves():
    r, c, v, shape = _triplets(7, 30, 30, 50, 0)
    coo = COO.from_numpy(r, c, v, shape)
    assert coo.values.dtype == torch.float64 and coo.rows.dtype == torch.int32
    assert coo.to("cpu") is coo
    moved = coo.to("meta")
    assert moved.device.type == "meta" and moved.shape == shape and moved.nnz == 50


@pytest.mark.parametrize("name", sorted(TRIPLETS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_coo_to_csr_matches_reference(name, dtype):
    r, c, v, shape = _triplets(*TRIPLETS[name], dtype=dtype)
    csr = coo_to_csr(COO.from_numpy(r, c, v, shape))
    assert isinstance(csr, CSR) and csr.device.type == "cpu"
    _assert_same(csr.to_numpy(), ref_coo_to_csr(RefCOO.from_numpy(r, c, v, shape)).to_numpy())


def test_coo_to_csr_sums_duplicates():
    r = np.array([2, 0, 2, 2, 1, 0])
    c = np.array([1, 3, 1, 0, 2, 3])
    v = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    rp, ci, vals, shape = coo_to_csr(COO.from_numpy(r, c, v, (3, 4))).to_numpy()
    assert rp.tolist() == [0, 1, 2, 4] and ci.tolist() == [3, 2, 0, 1]
    assert vals.tolist() == [8.0, 5.0, 4.0, 4.0] and shape == (3, 4)


CSRS = {
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "banded": lambda: banded_csr(300, bandwidth=5, seed=70),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=72),
    "rajat03": lambda: example_like("rajat03"),
}


@pytest.mark.parametrize("name", sorted(CSRS))
def test_csr_to_coo_matches_reference(name):
    ref = CSRS[name]()
    coo = csr_to_coo(CSR.from_numpy(*ref.to_numpy()))
    assert isinstance(coo, COO) and coo.device.type == "cpu"
    _assert_same(coo.to_numpy(), _ref_coo_numpy(ref_csr_to_coo(ref)))


@pytest.mark.parametrize("name", sorted(CSRS))
def test_csr_coo_round_trip(name):
    arrays = CSRS[name]().to_numpy()
    back = coo_to_csr(csr_to_coo(CSR.from_numpy(*arrays)))
    _assert_same(back.to_numpy(), arrays)
