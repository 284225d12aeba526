"""The swell layout's content-hashed disk plan cache (``ops/swell.py``), the
port of ``tests/test_swell.py::test_plan_disk_cache_roundtrip`` and
``::test_plan_disk_cache_detects_value_change``.

With ``SPMV_TPU_PLAN_CACHE=1`` (the cache is consulted for CUDA matrices, or
anywhere when forced) and ``SPMV_TPU_PLAN_CACHE_DIR`` pointed at ``tmp_path``:
one entry per (matrix, plan dtype, requested r); a second process's build
loads it (proved by making ``build_swell_layout`` raise); the loaded layout
equals the live one tensor for tensor and runs to the same bits; a value change,
another dtype or another r gives another entry; a truncated entry is rebuilt
and replaced; nothing is written when the cache is off; and the JAX package's
entries in the same directory are never read by the port, nor the port's by it."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats.generate import banded_csr, fem_like_csr, random_x_y
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats import CSR
from spmv_acc_tpu_torch.ops import swell, swell_plan
from spmv_acc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _clear_port_caches():
    clear_caches()
    yield
    clear_caches()


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SPMV_TPU_PLAN_CACHE", "1")
    monkeypatch.setenv("SPMV_TPU_PLAN_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("SPMV_TPU_NO_PLAN_CACHE", raising=False)
    monkeypatch.delenv("SPMV_TPU_SPILL", raising=False)
    return tmp_path


def _fem(dtype=np.float64):
    return CSR.from_numpy(*fem_like_csr(4096, 4096, 6 * 4096, block=3, seed=77,
                                         dtype=dtype).to_numpy())


def _entries(path):
    return sorted(p.name for p in path.glob("torch_swell_*.npz"))


def _planned(call):
    """(what ``call()`` returns, the plan steps it took: ``swell.plan_steps``)."""
    before = profiling.spans()
    out = call()
    return out, set(swell.plan_steps(before))


def _no_build(monkeypatch):
    def refuse(_sl):
        raise AssertionError("the layout was rebuilt, not loaded")

    monkeypatch.setattr(swell, "build_swell_layout", refuse)


def _assert_layouts_equal(live, loaded):
    for f in dataclasses.fields(live):
        a, b = getattr(live, f.name), getattr(loaded, f.name)
        if f.name == "_plain_idx":
            continue
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b), f.name
        elif f.name == "schedule":
            for g in dataclasses.fields(a):
                x, y = getattr(a, g.name), getattr(b, g.name)
                assert np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype
        else:
            assert a == b, f.name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r", [None, 1, 2])
def test_roundtrip_loads_the_same_layout(cache, monkeypatch, dtype, r):
    csr = _fem(dtype)
    live, steps = _planned(lambda: swell.get_swell_plan(csr, r=r))
    assert len(_entries(cache)) == 1, "layout not persisted"
    assert {"hash", "slabs", "layout", "save"} <= steps
    swell.clear_swell_cache()
    _no_build(monkeypatch)
    loaded, steps = _planned(lambda: swell.get_swell_plan(csr, r=r))
    assert "load" in steps and "slabs" not in steps
    assert loaded is not live and loaded.tail_rows.dtype == torch.int64
    _assert_layouts_equal(live, loaded)
    x = torch.from_numpy(random_x_y(4096, 4096, seed=3, dtype=dtype)[0])
    a, b = swell.swell_ax_plain(live, x), swell.swell_ax_plain(loaded, x)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert torch.equal(swell.swell_ax(loaded, x), b)


def test_value_change_gives_a_new_key(cache):
    rp, ci, v, shape = banded_csr(3000, bandwidth=5, seed=41).to_numpy()
    p1 = swell._plan_cache_path(rp, ci, v, shape, torch.float64, None)
    v2 = v.copy()
    v2[::2] *= 1.5  # same pattern, half the values changed
    assert p1 != swell._plan_cache_path(rp, ci, v2, shape, torch.float64, None)
    v3 = v.copy()
    v3[-1] = np.nextafter(v3[-1], 2.0)  # the last value by one ulp
    assert p1 != swell._plan_cache_path(rp, ci, v3, shape, torch.float64, None)
    assert p1 == swell._plan_cache_path(rp.copy(), ci.copy(), v.copy(), shape, torch.float64,
                                        None)


def test_value_change_loads_the_new_values(cache):
    base = _fem()
    swell.get_swell_plan(base)
    other = CSR(base.row_ptr, base.col_idx, base.values * 2.0, base.shape)
    lay = swell.get_swell_plan(other)
    assert len(_entries(cache)) == 2
    x = torch.from_numpy(random_x_y(4096, 4096, seed=4)[0])
    assert torch.equal(swell.swell_ax(lay, x), 2.0 * swell.swell_ax(swell.get_swell_plan(base), x))


def test_dtype_and_r_get_distinct_entries(cache):
    csr64 = _fem()
    for dtype in (torch.float64, torch.float32):
        for r in (None, 1, 2):
            swell.get_swell_plan(csr64, dtype=dtype, r=r)
    names = _entries(cache)
    assert len(names) == 6
    assert {n.split("_")[5] for n in names} == {"f64", "f32"}
    assert {n.split("_")[6] for n in names} == {"rauto", "r1", "r2"}


def test_spill_setting_is_in_the_key(cache, monkeypatch):
    rp, ci, v, shape = banded_csr(300, bandwidth=5, seed=42).to_numpy()
    auto = swell._plan_cache_path(rp, ci, v, shape, torch.float64, 1)
    monkeypatch.setenv("SPMV_TPU_SPILL", "0")
    never = swell._plan_cache_path(rp, ci, v, shape, torch.float64, 1)
    monkeypatch.setenv("SPMV_TPU_SPILL", "16")
    assert len({auto, never, swell._plan_cache_path(rp, ci, v, shape, torch.float64, 1)}) == 3


def test_truncated_entry_is_rebuilt_and_replaced(cache, monkeypatch):
    csr = _fem()
    live = swell.get_swell_plan(csr)
    (name,) = _entries(cache)
    path = cache / name
    whole = path.read_bytes()
    path.write_bytes(whole[: len(whole) // 2])
    swell.clear_swell_cache()
    rebuilt, steps = _planned(lambda: swell.get_swell_plan(csr))
    assert "slabs" in steps and "save" in steps
    _assert_layouts_equal(live, rebuilt)
    assert path.stat().st_size == len(whole) and _entries(cache) == [name]
    swell.clear_swell_cache()
    _no_build(monkeypatch)
    _assert_layouts_equal(live, swell.get_swell_plan(csr))


def test_entry_of_another_dtype_is_not_served(cache):
    """An entry whose arrays do not fit the key (here: f32 values under the
    f64 name) is rebuilt, not served."""
    csr = _fem()
    swell.get_swell_plan(csr, dtype=torch.float32)
    swell.get_swell_plan(csr)
    f32, f64 = (cache / n for n in sorted(_entries(cache), key=lambda n: "f64" in n))
    f64.write_bytes(f32.read_bytes())
    swell.clear_swell_cache()
    lay, steps = _planned(lambda: swell.get_swell_plan(csr))
    assert lay.dtype == torch.float64 and "slabs" in steps


def test_schedule_is_rebuilt_from_the_loaded_layout(cache, monkeypatch):
    csr = _fem()
    live = swell.get_swell_plan(csr)
    swell.clear_swell_cache()
    _no_build(monkeypatch)
    monkeypatch.setattr(swell_plan, "SWELL_CHUNK_ROWS", 1)
    loaded, steps = _planned(lambda: swell.get_swell_plan(csr))
    assert "schedule" in steps
    assert live.schedule.max_rows == 64 and loaded.schedule.max_rows == 1
    assert loaded.schedule.nchunks > live.schedule.nchunks
    assert torch.equal(loaded.vals, live.vals)


def test_no_plan_cache_writes_nothing(cache, monkeypatch):
    monkeypatch.setenv("SPMV_TPU_NO_PLAN_CACHE", "1")
    _, steps = _planned(lambda: swell.get_swell_plan(_fem()))
    assert not os.listdir(cache) and "hash" not in steps


def test_cpu_matrix_without_the_force_writes_nothing(cache, monkeypatch):
    monkeypatch.delenv("SPMV_TPU_PLAN_CACHE")
    swell.get_swell_plan(_fem())
    assert not os.listdir(cache)


def test_past_the_cap_stores_nothing(cache, monkeypatch):
    monkeypatch.setattr(swell, "SWELL_MAX_SLOTS", 1000)
    assert swell.swell_plan_within_cap(_fem()) is None
    assert not os.listdir(cache)


def test_failed_save_leaves_the_call_whole(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("SPMV_TPU_PLAN_CACHE", "1")
    monkeypatch.setenv("SPMV_TPU_PLAN_CACHE_DIR", str(blocker / "plans"))
    lay, steps = _planned(lambda: swell.get_swell_plan(_fem()))
    # the save was tried (its span records the failed attempt) and wrote nothing
    assert lay.slots > 0 and "save" in steps and list(tmp_path.iterdir()) == [blocker]


def test_jax_entries_and_port_entries_never_meet(cache, monkeypatch):
    """The reference's roundtrip recipe and the port's in one directory: each
    package writes its own entry and, with its in-process cache cleared, loads
    its own; the names never collide."""
    from spmv_acc_tpu.ops import swell as ref_swell

    ref = fem_like_csr(4096, 4096, 6 * 4096, block=3, seed=77, dtype=np.float64)
    ref_swell.get_swell_plan(ref, np.float64)
    jax_files = sorted(p.name for p in cache.glob("plan_*.npz"))
    assert len(jax_files) == 1 and not _entries(cache)
    csr = CSR.from_numpy(*ref.to_numpy())
    live, steps = _planned(lambda: swell.get_swell_plan(csr))  # the JAX entry is there:
    assert "slabs" in steps and len(_entries(cache)) == 1          # the port builds anyway
    assert sorted(p.name for p in cache.glob("plan_*.npz")) == jax_files
    ref_swell._SWELL_CACHE.clear()
    assert ref_swell.get_swell_plan(ref, np.float64).plan.buckets == ()  # its own entry
    assert len(os.listdir(cache)) == 2
    swell.clear_swell_cache()
    _no_build(monkeypatch)
    _assert_layouts_equal(live, swell.get_swell_plan(csr))
