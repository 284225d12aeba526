"""The port's SpGEMM against the JAX package's ``ops/spgemm.py``.

``spgemm_host`` (the numpy Gustavson golden) and ``spgemm_symbolic`` (C's
pattern and the product map) match the reference array for array;
``spgemm`` on the CPU matches the reference's ``spgemm`` and the dense golden
``host_spgemm_dense`` within 1e-12 * (|A|·|B|) per entry in float64 (the
segment sums may add in another order)."""

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import CSR as RefCSR
from spmv_acc_tpu.formats.generate import banded_csr, example_like, powerlaw_csr, random_csr
from spmv_acc_tpu.ops.golden import host_spgemm_dense as ref_host_spgemm_dense
from spmv_acc_tpu.ops.spgemm import spgemm as ref_spgemm
from spmv_acc_tpu.ops.spgemm import spgemm_host as ref_spgemm_host
from spmv_acc_tpu.ops.spgemm import spgemm_symbolic as ref_spgemm_symbolic
from spmv_acc_tpu_torch import spgemm
from spmv_acc_tpu_torch.formats import CSR
from spmv_acc_tpu_torch.formats.convert import csr_to_dense
from spmv_acc_tpu_torch.ops.golden import host_spgemm_dense
from spmv_acc_tpu_torch.ops.spgemm import spgemm_host, spgemm_numeric, spgemm_symbolic

TOL = 1e-12

PAIRS = {
    "random_square": lambda: (random_csr(200, 200, 1500, seed=1), random_csr(200, 200, 1500, seed=2)),
    "rectangular": lambda: (random_csr(90, 140, 800, seed=3), random_csr(140, 60, 900, seed=4)),
    "banded_powerlaw": lambda: (banded_csr(300, bandwidth=5, seed=5),
                                powerlaw_csr(300, 300, avg_nnz=6, seed=6)),
    "rajat03_squared": lambda: (example_like("rajat03"),) * 2,
}


def _port(ref):
    return CSR.from_numpy(*ref.to_numpy())


def _abs_product(a, b):
    """|A|·|B| as a dense array: the scale of each entry's rounding."""
    A = np.abs(csr_to_dense(*a.to_numpy()))
    B = np.abs(csr_to_dense(*b.to_numpy()))
    return A @ B


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_host_matches_reference_in_bits(name):
    a, b = PAIRS[name]()
    got = spgemm_host(*a.to_numpy(), *b.to_numpy())
    want = ref_spgemm_host(*a.to_numpy(), *b.to_numpy())
    assert all(_same(g, w) for g, w in zip(got[:3], want[:3])) and got[3] == want[3]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_symbolic_matches_reference(name):
    a, b = PAIRS[name]()
    pattern, a_pos, b_pos, out_pos, c_nnz = spgemm_symbolic(_port(a), _port(b))
    ref = ref_spgemm_symbolic(a, b)
    rp, ci, v, shape = pattern.to_numpy()
    rrp, rci, rv, rshape = ref[0].to_numpy()
    assert _same(rp, rrp) and _same(ci, rci) and _same(v, rv) and shape == rshape
    assert not v.any() and pattern.device.type == "cpu"
    for got, want in zip((a_pos, b_pos, out_pos), ref[1:4]):
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert c_nnz == ref[4] == len(ci)
    assert bool((out_pos[1:] >= out_pos[:-1]).all())


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_spgemm_matches_reference_and_dense_golden(name):
    a, b = PAIRS[name]()
    c = spgemm(_port(a), _port(b))
    assert isinstance(c, CSR) and c.device.type == "cpu" and c.values.dtype == torch.float64
    ref = ref_spgemm(a, b)
    rp, ci, v, shape = c.to_numpy()
    rrp, rci, rv, _ = ref.to_numpy()
    assert _same(rp, rrp) and _same(ci, rci) and shape == ref.shape
    allowed = TOL * _abs_product(a, b)
    dense = csr_to_dense(rp, ci, v, shape)
    assert (np.abs(dense - csr_to_dense(rrp, rci, np.asarray(rv), shape)) <= allowed).all()
    golden = host_spgemm_dense(*a.to_numpy(), *b.to_numpy())
    assert (np.abs(dense - golden) <= allowed).all()


def test_host_spgemm_dense_matches_reference():
    a, b = PAIRS["rectangular"]()
    assert _same(host_spgemm_dense(*a.to_numpy(), *b.to_numpy()),
                 ref_host_spgemm_dense(*a.to_numpy(), *b.to_numpy()))


def test_spgemm_numeric_repeats_in_bits():
    a, b = (_port(m) for m in PAIRS["rajat03_squared"]())
    _, a_pos, b_pos, out_pos, c_nnz = spgemm_symbolic(a, b)
    one = spgemm_numeric(a.values, b.values, a_pos, b_pos, out_pos, c_nnz)
    two = spgemm_numeric(a.values, b.values, a_pos, b_pos, out_pos, c_nnz)
    assert one.shape == (c_nnz,) and torch.equal(one, two)


def test_spgemm_float32():
    a, b = (random_csr(80, 80, 500, seed=s, dtype=np.float32) for s in (7, 8))
    c = spgemm(_port(a), _port(b))
    assert c.values.dtype == torch.float32
    golden = host_spgemm_dense(*a.to_numpy(), *b.to_numpy()).astype(np.float64)
    dense = csr_to_dense(*c.to_numpy()).astype(np.float64)
    allowed = 2.0**-22 * _abs_product(a, b)
    assert (np.abs(dense - golden) <= allowed).all()


def test_empty_product():
    """B's rows that A's columns reach are all empty: no products, an empty C."""
    a = RefCSR.from_numpy([0, 1, 2, 2], [0, 1], [1.5, -2.0], (3, 3))
    b = RefCSR.from_numpy([0, 0, 0, 2], [0, 2], [4.0, 5.0], (3, 3))
    c = spgemm(_port(a), _port(b))
    rp, ci, v, shape = c.to_numpy()
    assert rp.tolist() == [0, 0, 0, 0] and len(ci) == len(v) == 0 and shape == (3, 3)
    assert ref_spgemm_symbolic(a, b)[4] == spgemm_symbolic(_port(a), _port(b))[4] == 0
    got = spgemm_host(*a.to_numpy(), *b.to_numpy())
    want = ref_spgemm_host(*a.to_numpy(), *b.to_numpy())
    assert all(_same(g, w) for g, w in zip(got[:3], want[:3]))


def test_empty_a():
    a = CSR.from_numpy(np.zeros(5, np.int32), np.zeros(0, np.int32), np.zeros(0), (4, 6))
    b = _port(random_csr(6, 3, 10, seed=9))
    c = spgemm(a, b)
    assert c.shape == (4, 3) and c.nnz == 0 and c.row_ptr.tolist() == [0] * 5


@pytest.mark.parametrize("fn", ["spgemm", "spgemm_symbolic", "spgemm_host"])
def test_inner_dimension_mismatch_raises(fn):
    a, b = random_csr(20, 30, 80, seed=10), random_csr(31, 20, 80, seed=11)
    with pytest.raises(ValueError, match="inner dims"):
        if fn == "spgemm_host":
            spgemm_host(*a.to_numpy(), *b.to_numpy())
        else:
            {"spgemm": spgemm, "spgemm_symbolic": spgemm_symbolic}[fn](_port(a), _port(b))


def test_different_devices_raise():
    a = _port(random_csr(20, 20, 80, seed=12))
    b = CSR(a.row_ptr.to("meta"), a.col_idx.to("meta"), a.values.to("meta"), a.shape)
    with pytest.raises(ValueError, match="different|is on"):
        spgemm(a, b)


def test_dw4096_squared_c_nnz():
    ref = example_like("dw4096")
    pattern, a_pos, _, _, c_nnz = spgemm_symbolic(_port(ref), _port(ref))
    assert c_nnz == ref_spgemm_symbolic(ref, ref)[4] == pattern.nnz
    assert len(a_pos) == int(np.diff(ref.to_numpy()[0])[ref.to_numpy()[1]].sum())
