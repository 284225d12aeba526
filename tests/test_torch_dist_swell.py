"""The port's distributed swell layer (``parallel/dist_swell.py``): the
shards of one global layout, the serial baseline, and the all-gather and
halo paths in gloo ranks against the JAX package's ``dist_swell`` on its
8-device virtual CPU mesh, on the same numpy inputs.

The port's shard unit is a 128*r-row block, the JAX package's a TPU
out-window, so padded lengths (and even the halo choice) may differ: the
comparisons read ``y[:m]`` and the CG solution only.  Tolerances: shards put
together equal the layout array for array; the serial baseline on the CPU
equals ``swell_ax_plain`` over the whole layout bit for bit without a tail
(the same slots summed in the same order), within the float64 gate with one;
every distributed SpMV passes the float64 gate (``verify_y``) against JAX's
output and against ``host_spmv``; the swell CG reaches 1e-7 of x_true and the
JAX package's iteration count."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays
from spmv_acc_tpu.formats.generate import banded_csr as ref_banded
from spmv_acc_tpu.formats.generate import fem_like_csr as ref_fem_like
from spmv_acc_tpu.formats.generate import random_csr as ref_random
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.golden import host_spmv, host_spmv_plain
from spmv_acc_tpu.parallel import make_mesh as ref_make_mesh
from spmv_acc_tpu.parallel.dist_swell import build_dist_swell as ref_build_dist_swell
from spmv_acc_tpu.parallel.dist_swell import dist_swell_cg_solve as ref_dist_swell_cg_solve
from spmv_acc_tpu.parallel.dist_swell import dist_swell_spmv_fn as ref_dist_swell_spmv_fn
from spmv_acc_tpu.parallel.dist_swell import pad_global as ref_pad_global
from spmv_acc_tpu.utils.verify import verify_y
from spmv_acc_tpu_torch.config import LANES
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.parallel.dist_swell import (build_dist_swell, dist_swell_serial_fn,
                                                    dist_swell_spmv_fn, pad_global)
from spmv_acc_tpu_torch.parallel.launch import rank_cases, spawn

TAIL_ENV = {"SPMV_TPU_SPILL": "16", "SPMV_TPU_NO_PLAN_CACHE": "1"}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    swell.clear_swell_cache()


def _tailed(D):
    """Gate 4b's fixture: a band plus 12 outliers per shard boundary, one
    16384-row block to the right of their rows (spilled to the COO tail
    under SPMV_TPU_SPILL=16)."""
    Lh = 16384
    mh = D * Lh
    rp, ci, v, _ = ref_banded(mh, bandwidth=5, seed=31, dtype=np.float64).to_numpy()
    rng = np.random.default_rng(32)
    rows = np.repeat(np.arange(mh), np.diff(rp))
    ro = np.concatenate([d * Lh + rng.integers(4000, 8000, size=12) for d in range(D - 1)])
    vo = rng.uniform(-1, 1, size=len(ro))
    rp, ci, v = coo_to_csr_arrays(np.concatenate([rows, ro]), np.concatenate([ci, ro + Lh]),
                                  np.concatenate([v, vo]), (mh, mh))
    return rp, ci, v, (mh, mh)


def _spd(m, seed):
    """test_parallel.py::test_dist_swell_cg_solve's system (fem_like, symmetrised,
    diagonally dominant)."""
    rp, ci, v, _ = ref_fem_like(m, m, 6 * m, block=3, seed=seed, dtype=np.float64).to_numpy()
    rr = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    diag = np.zeros(m)
    np.add.at(diag, rr, 0.5 * np.abs(v))
    np.add.at(diag, ci, 0.5 * np.abs(v))
    rp, ci, v = coo_to_csr_arrays(
        np.concatenate([rr, ci, np.arange(m)]), np.concatenate([ci, rr, np.arange(m)]),
        np.concatenate([0.5 * v, 0.5 * v, diag + 1.0]), (m, m))
    return rp, ci, v, (m, m)


LOCAL = {
    "fem_b6": lambda: ref_fem_like(3001, 3001, 90000, block=6, seed=5).to_numpy(),
    "banded": lambda: ref_banded(3001, bandwidth=5, seed=70).to_numpy(),
    "random": lambda: ref_random(2000, 2000, 20000, seed=9).to_numpy(),
    "tailed": lambda: _tailed(2),
}


def _local_csr(name, monkeypatch):
    if name == "tailed":
        for k, v in TAIL_ENV.items():
            monkeypatch.setenv(k, v)
    return CSR.from_numpy(*LOCAL[name]())


@pytest.mark.parametrize("halo", [None, False])
@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(LOCAL))
def test_shards_put_together_equal_the_layout(name, D, halo, monkeypatch):
    csr = _local_csr(name, monkeypatch)
    lay, _ = swell._host_layout(csr, torch.float64, None)
    dsp = build_dist_swell(csr, D, halo=halo)
    r, K, L = lay.r, dsp.blocks_per_shard, dsp.rows_local
    assert K == -(-lay.mrb // D) and L == K * LANES * r and dsp.padded_len >= csr.rows
    assert dsp.x_rows == (3 * L if dsp.halo_ok else csr.cols)
    if halo is False:
        assert not dsp.halo_ok
    cat = lambda name: np.concatenate([getattr(s, name) for s in dsp.shards])  # noqa: E731
    for field in ("vals", "lidx", "slab_log2d", "tail_v"):
        assert np.array_equal(cat(field), getattr(lay, field)), field
    shift = [(d - 1) * L if dsp.halo_ok else 0 for d in range(D)]
    base = np.concatenate([s.slab_col_base.astype(np.int64) + shift[d] // r
                           for d, s in enumerate(dsp.shards)])
    assert np.array_equal(base, lay.slab_col_base)
    tail_ci = np.concatenate([s.tail_ci.astype(np.int64) + shift[d]
                              for d, s in enumerate(dsp.shards)])
    tail_rows = np.concatenate([s.tail_rows.astype(np.int64) + d * L
                                for d, s in enumerate(dsp.shards)])
    assert np.array_equal(tail_ci, lay.tail_ci) and np.array_equal(tail_rows, lay.tail_rows)
    assert (dsp.tail_nnz > 0) == (name == "tailed")
    slots = np.cumsum([0] + [len(s.lidx) for s in dsp.shards])
    slabs = np.cumsum([0] + [len(s.slab_off) for s in dsp.shards])
    assert np.array_equal(np.concatenate([s.slab_off + slots[d] for d, s in enumerate(dsp.shards)]),
                          lay.slab_off)
    ptr = np.concatenate([dsp.shards[d].rb_slab_ptr[:-1] + slabs[d] for d in range(D)] + [[slabs[-1]]])
    assert np.array_equal(ptr[: lay.mrb + 1], lay.rb_slab_ptr)
    assert np.all(ptr[lay.mrb:] == slabs[-1])  # a short last shard's blocks hold no slab
    for s, sc in zip(dsp.shards, dsp.schedules):
        assert s.rows == K * LANES and s.mrb == K and sc.nchunks >= K


@pytest.mark.parametrize("halo", [None, False])
@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(LOCAL))
def test_serial_equals_single_device(name, D, halo, monkeypatch):
    csr = _local_csr(name, monkeypatch)
    dsp = build_dist_swell(csr, D, halo=halo)
    x = torch.from_numpy(random_x_y(csr.cols, csr.rows, seed=D)[0])
    y = dist_swell_serial_fn(dsp, "cpu")(pad_global(dsp, x))
    assert y.shape == (dsp.padded_len,) and torch.all(y[csr.rows:] == 0)
    whole = swell.swell_ax_plain(swell.get_swell_plan(csr), x)
    if dsp.tail_nnz == 0:
        assert torch.equal(y[: csr.rows], whole)
    else:
        assert verify_y(y[: csr.rows].numpy(), whole.numpy(), np.float64).failed_count == 0
    rp, ci, v, _ = csr.to_numpy()
    assert verify_y(y[: csr.rows].numpy(), host_spmv_plain(rp, ci, v, x.numpy()),
                    np.float64).failed_count == 0


def test_build_dist_swell_refuses():
    csr = CSR.from_numpy(*ref_random(2000, 2000, 20000, seed=9).to_numpy())
    with pytest.raises(ValueError, match="halo=True"):
        build_dist_swell(csr, 4, halo=True)
    with pytest.raises(ValueError, match="float64"):
        build_dist_swell(csr.astype(torch.float32), 2, dtype=np.float64)
    with pytest.raises(ValueError, match="plan was not built halo-feasible"):
        dist_swell_spmv_fn(build_dist_swell(csr, 4), None, halo=True)
    with pytest.raises(ValueError, match="halo-feasible"):
        dist_swell_spmv_fn(build_dist_swell(csr, 2), None, halo=False)
    with pytest.raises(ValueError, match="does not fit"):
        pad_global(build_dist_swell(csr, 2), torch.zeros(10 ** 6))


# in gloo ranks: (name, csr, x or b, halo, env)
M = 16384


def _rank_inputs():
    fem = ref_fem_like(M, M, 6 * M, block=3, seed=21, dtype=np.float64).to_numpy()
    x = random_x_y(M, M, seed=22, dtype=np.float64)[0]
    spd = _spd(8192, 31)
    x_true = np.random.default_rng(32).uniform(-1, 1, size=8192)
    b = host_spmv(1.0, 0.0, *spd[:3], x_true, np.zeros(8192))
    return fem, x, spd, b, x_true


def _rank_cases(D):
    fem, x, spd, b, _ = _rank_inputs()
    tailed = _tailed(D)
    xt = np.random.default_rng(D).uniform(-1, 1, size=tailed[3][0])
    return [dict(kind="swell", csr=fem, x=x, halo=None),
            dict(kind="swell", csr=fem, x=x, halo=False),
            dict(kind="swell", csr=tailed, x=xt, halo=None, env=TAIL_ENV),
            dict(kind="swell_cg", csr=spd, b=b, tol=1e-10, max_iters=300)]


_RESULTS = {}


def _results(D):
    if D not in _RESULTS:
        _RESULTS[D] = spawn(rank_cases, D, "cpu", _rank_cases(D))[0]
    return _RESULTS[D]


def _ref_y(csr_arrays, x, D, env=None):
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        dsp = ref_build_dist_swell(RefCSR.from_numpy(*csr_arrays), D)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    mesh = ref_make_mesh(D)
    xp = pad_global_ref = ref_pad_global(dsp, jnp.asarray(x))
    import jax

    out = ref_dist_swell_spmv_fn(dsp, mesh)(jax.device_put(xp, NamedSharding(mesh, P("x"))))
    del pad_global_ref
    return np.asarray(out)[: csr_arrays[3][0]], dsp


@pytest.mark.parametrize("case", ["halo", "gather", "tailed-halo"])
@pytest.mark.parametrize("D", [2, 4])
def test_dist_swell_spmv_matches_reference(D, case):
    """test_parallel.py::test_dist_swell_spmv_matches_golden's matrix through
    the halo and the all-gather paths, and gate 4b's tailed plan through the
    halo path, against JAX's dist_swell_spmv_fn and host_spmv."""
    i = ["halo", "gather", "tailed-halo"].index(case)
    spec = _rank_cases(D)[i]
    y, halo_ok, tail_nnz = _results(D)[i]
    assert halo_ok == (case != "gather")
    assert (tail_nnz > 0) == (case == "tailed-halo")
    ref_y, ref_dsp = _ref_y(spec["csr"], spec["x"], D, spec.get("env"))
    if case == "tailed-halo":
        assert ref_dsp.halo_ok and ref_dsp.tail[0].shape[0] == D
    golden = host_spmv_plain(*spec["csr"][:3], spec["x"])
    assert y.shape == golden.shape
    assert verify_y(y, ref_y, np.float64).failed_count == 0
    assert verify_y(y, golden, np.float64).failed_count == 0


@pytest.mark.parametrize("D", [2, 4])
def test_dist_swell_cg_solve_matches_reference(D):
    """test_parallel.py::test_dist_swell_cg_solve's system at D shards:
    converges to x_true and takes the JAX package's iteration count."""
    x, iters = _results(D)[3]
    _, _, spd, b, x_true = _rank_inputs()
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-7
    res, _ = ref_dist_swell_cg_solve(RefCSR.from_numpy(*spd), jnp.asarray(b), ref_make_mesh(D),
                                     tol=1e-10, max_iters=300)
    assert iters == int(res.iters) and 0 < iters < 300
    assert np.linalg.norm(x - np.asarray(res.x)[:8192]) <= 1e-8 * np.linalg.norm(x_true)
