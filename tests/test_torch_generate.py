"""The port's generators and bin2 I/O against the JAX package's: identical arrays
for every small-set corpus name and the generator recipes, byte-identical bin2."""

import numpy as np
import pytest

from spmv_acc_tpu import config as ref_config
from spmv_acc_tpu.formats import generate as ref_gen
from spmv_acc_tpu.io import binary as ref_bin
from spmv_acc_tpu_torch import config as port_config
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats import generate as port_gen
from spmv_acc_tpu_torch.io import binary as port_bin

SMALL_SET = ["af23560", "bayer10", "bcsstk18", "coater2", "dw4096", "epb1",
             "exdata_1", "nemeth03", "poli_large", "rajat03"]


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _assert_same(ref_csr, port_csr):
    ref, port = ref_csr.to_numpy(), port_csr.to_numpy()
    assert ref[3] == port[3]
    for a, b in zip(ref[:3], port[:3]):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", SMALL_SET)
def test_example_like_identical(name):
    _assert_same(ref_gen.example_like(name, cache=False),
                 port_gen.example_like(name, cache=False))


def test_hardesty3_stencil_recipe_identical():
    """The rectangular stencil recipe behind Hardesty3, at a reduced shape."""
    _assert_same(ref_gen._stencil_csr(8000, 7400, 40000, 7, np.float64),
                 port_gen._stencil_csr(8000, 7400, 40000, 7, np.float64))


@pytest.mark.parametrize("recipe", [
    ("random_csr", (150, 260, 1700), {"seed": 71}),
    ("banded_csr", (300,), {"bandwidth": 5, "seed": 70}),
    ("powerlaw_csr", (180, 180), {"avg_nnz": 6, "seed": 72}),
    ("dense_row_outlier_csr", (140, 140), {"avg_nnz": 3, "n_dense": 2, "seed": 73}),
    ("fem_like_csr", (3000, 3000, 60000), {"block": 3, "seed": 5}),
])
def test_generators_identical(recipe):
    fn, args, kw = recipe
    _assert_same(getattr(ref_gen, fn)(*args, **kw), getattr(port_gen, fn)(*args, **kw))


def test_random_x_y_identical():
    for a, b in zip(ref_gen.random_x_y(333, 222, seed=9), port_gen.random_x_y(333, 222, seed=9)):
        assert np.array_equal(a, b)


def test_bin2_byte_identical(tmp_path):
    rp, ci, v, shape = port_gen.example_like("rajat03", cache=False).to_numpy()
    ref_path, port_path = tmp_path / "ref.bin2", tmp_path / "port.bin2"
    ref_bin.write_bin2(ref_path, rp, ci, v, shape)
    port_bin.write_bin2(port_path, rp, ci, v, shape)
    assert ref_path.read_bytes() == port_path.read_bytes()
    back = port_bin.read_bin2(ref_path)
    assert back[3] == shape
    for a, b in zip(back[:3], (rp, ci, v)):
        assert np.array_equal(a, b)


def test_corpus_cache_shared(tmp_path, monkeypatch):
    """Both packages resolve the same cache dir and read each other's entries."""
    monkeypatch.delenv("SPMV_TPU_CORPUS_CACHE", raising=False)
    assert port_config.cache_dir("corpus") == ref_config.cache_dir("corpus")
    monkeypatch.setenv("SPMV_TPU_CORPUS_CACHE", str(tmp_path))
    ref = ref_gen.example_like("dw4096")
    assert (tmp_path / "dw4096_s7.bin2").exists()
    _assert_same(ref, port_gen.example_like("dw4096"))
