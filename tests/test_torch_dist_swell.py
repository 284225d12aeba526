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
JAX package's iteration count.

The halo exchange sends each shard only the spans of its neighbours' x blocks
that its rows read (``DistSwellPlan.halo_spans``): the spans on the host
against what each shard's columns reach, and in the gloo ranks the product and
the CG solve over spans against the same plan over whole neighbour blocks,
byte for byte (entries outside the spans are read only by zero-valued padding
slots).  ``dist_spmv_halo_fn``, the gather product that ``dist_cg_solve``
runs, takes its spans from the same scan: its spans on the host, and in the
ranks its product over spans against its product over whole blocks."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from perfbench.matrices import hpcg27
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
from spmv_acc_tpu_torch.parallel.partition import partition_rows

_DIST_SPMV = importlib.import_module("spmv_acc_tpu_torch.parallel.dist_spmv")

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


def _hpcg(nx, ny, nz):
    return hpcg27.build({"nx": nx, "ny": ny, "nz": nz})


def _irregular(m, seed):
    """A banded matrix whose rows reach left and right by amounts drawn per
    row, below a cap that grows every 256 rows, so each shard boundary's
    spans differ by side and by rank: the diagonal (dominant), the two
    reaches' ends and three columns between."""
    rng = np.random.default_rng(seed)
    i = np.arange(m)
    cap = 30 + 37 * (i // 256)
    left, right = rng.integers(0, cap), rng.integers(0, cap)
    cols = np.stack([i, i - left, i + right] + [rng.integers(i - left, i + right + 1)
                                                 for _ in range(3)], axis=1)
    rows = np.repeat(i, cols.shape[1])
    cols = np.clip(cols.reshape(-1), 0, m - 1)
    vals = np.where(rows == cols, 10.0, rng.uniform(-1, 1, size=len(cols)))
    rp, ci, v = coo_to_csr_arrays(rows, cols, vals, (m, m))
    return rp, ci, v, (m, m)


def _block_diagonal(m, b=8):
    """Dense b x b blocks on the diagonal: no shard reads a neighbour's x."""
    rng = np.random.default_rng(b)
    rows = np.repeat(np.arange(m), b)
    cols = (rows // b * b) + np.tile(np.arange(b), m)
    rp, ci, v = coo_to_csr_arrays(rows, cols, rng.uniform(-1, 1, size=len(rows)), (m, m))
    return rp, ci, v, (m, m)


SPANS = {
    "hpcg": lambda: _hpcg(8, 8, 32),
    "hpcg_16x8": lambda: _hpcg(16, 8, 8),
    "irregular": lambda: _irregular(4096, 41),
    "block_diagonal": lambda: _block_diagonal(2048),
}


def _read_spans(arrays, D, L, r):
    """Shard d's (left, right) found from the entries of x each of its
    nonzero cells reads (r of them a node column), marked in its window."""
    rp, ci, _, (m, _) = arrays
    spans = []
    for d in range(D):
        c = ci[rp[min(d * L, m)]: rp[min((d + 1) * L, m)]].astype(np.int64)
        read = np.zeros(3 * L, dtype=bool)
        for k in range(r):
            read[np.unique(c // r) * r + k - (d - 1) * L] = True
        left = L - int(np.flatnonzero(read[:L])[0]) if read[:L].any() else 0
        right = int(np.flatnonzero(read[2 * L:])[-1]) + 1 if read[2 * L:].any() else 0
        spans.append((left, right))
    return tuple(spans)


@pytest.mark.parametrize("path", ["swell", "gather"])
@pytest.mark.parametrize("name", sorted(SPANS))
def test_halo_spans_are_what_each_shard_reads(name, path):
    """Over 4 shards, in ``build_dist_swell``'s plan and in the square
    partition that ``dist_spmv_halo_fn`` reads (``partition_rows``, its
    padded coordinates the global ones here): a z-slab of the 27-point
    stencil reads one nx*ny plane of each neighbour (a row at x = 0, y = 0
    has no neighbour at x - 1 or y - 1, so the lowest column is the first
    entry of the plane below); a block-diagonal matrix reads none; an
    irregular band reads spans that differ by side and by rank."""
    arrays = SPANS[name]()
    csr = CSR.from_numpy(*arrays)
    if path == "swell":
        dsp = build_dist_swell(csr, 4)
        assert dsp.halo_ok
        rows_local, spans = dsp.rows_local, dsp.halo_spans
        assert spans == _read_spans(arrays, 4, rows_local, dsp.r)
        assert build_dist_swell(csr, 4, halo=False).halo_spans == ()
    else:
        part = partition_rows(csr, 4, balance=False)
        rows_local, spans = part.local_rows, _DIST_SPMV._part_spans(part, None, True)
        assert 4 * rows_local == csr.rows and spans == _read_spans(arrays, 4, rows_local, 1)
    assert spans[0][0] == spans[-1][1] == 0
    if name.startswith("hpcg"):
        plane = {"hpcg": 8 * 8, "hpcg_16x8": 16 * 8}[name]
        assert rows_local == {"hpcg": 512, "hpcg_16x8": 256}[name]
        assert spans == ((0, plane), (plane, plane), (plane, plane), (plane, 0))
    elif name == "block_diagonal":
        assert spans == ((0, 0),) * 4
    else:
        inner = [s for pair in spans for s in pair][1:-1]
        assert len(set(inner)) == len(inner) and min(inner) > 0


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


SPAN_CASES = ["hpcg", "irregular", "block_diagonal", "tailed"]


def _span_inputs(name, D):
    """(csr arrays, two x, env) of a span-against-whole-blocks case."""
    arrays = _tailed(D) if name == "tailed" else SPANS[name]()
    rng = np.random.default_rng(len(name) + D)
    xs = [rng.uniform(-1, 1, size=arrays[3][1]) for _ in range(2)]
    return arrays, xs, TAIL_ENV if name == "tailed" else None


def _hpcg_b():
    return np.random.default_rng(43).uniform(-1, 1, size=8 * 8 * 32)


def _rank_cases(D):
    fem, x, spd, b, _ = _rank_inputs()
    tailed = _tailed(D)
    xt = np.random.default_rng(D).uniform(-1, 1, size=tailed[3][0])
    spans = []
    for name in SPAN_CASES:
        arrays, xs, env = _span_inputs(name, D)
        spans.append(dict(kind="swell_spans", csr=arrays, xs=xs, env=env))
    return [dict(kind="swell", csr=fem, x=x, halo=None),
            dict(kind="swell", csr=fem, x=x, halo=False),
            dict(kind="swell", csr=tailed, x=xt, halo=None, env=TAIL_ENV),
            dict(kind="swell_cg", csr=spd, b=b, tol=1e-10, max_iters=300),
            dict(kind="swell_cg_spans", csr=SPANS["hpcg"](), b=_hpcg_b(), tol=1e-10,
                 max_iters=500, eager_iters=4)] + spans


_RESULTS = {}


def _all_ranks(D):
    if D not in _RESULTS:
        _RESULTS[D] = spawn(rank_cases, D, "cpu", _rank_cases(D))
    return _RESULTS[D]


def _results(D):
    return _all_ranks(D)[0]


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


@pytest.mark.parametrize("name", SPAN_CASES)
@pytest.mark.parametrize("D", [2, 4])
def test_span_exchange_equals_whole_blocks(D, name):
    """``dist_swell_spmv_fn``'s y over the spans equals, byte for byte, the
    same plan's y over whole neighbour blocks, for two x in turn through the
    one kept window; each rank issues one op for each nonzero span it sends
    or receives (none on the block-diagonal matrix), where the whole blocks
    take two a neighbour; the tailed plan's spans hold its COO tail's
    columns.  ``dist_spmv_halo_fn`` (the gather product in the square
    partition's padded coordinates, as ``dist_cg_solve`` runs it) over its
    spans equals its product over whole blocks byte for byte, and moves fewer
    elements."""
    arrays, xs, _ = _span_inputs(name, D)
    golden = [host_spmv_plain(*arrays[:3], x) for x in xs]
    for d, res in enumerate(r[5 + SPAN_CASES.index(name)] for r in _all_ranks(D)):
        spans = res["spans"]
        sends = (spans[d - 1][1] if d > 0 else 0, spans[d + 1][0] if d < D - 1 else 0)
        ops = sum(n > 0 for n in sends + spans[d])
        assert res["span"]["ops"] == [ops] * len(xs) and res["windows"] == 1
        assert res["whole"]["ops"] == [2 * ((d > 0) + (d < D - 1))] * len(xs)
        for y, whole, want in zip(res["span"]["y"], res["whole"]["y"], golden):
            assert y.tobytes() == whole.tobytes()
            assert verify_y(y, want, np.float64).failed_count == 0
        gather, gather_whole = res["gather_span"], res["gather_whole"]
        assert gather_whole["ops"] == res["whole"]["ops"]
        for y, whole, want in zip(gather["y"], gather_whole["y"], golden):
            assert y.tobytes() == whole.tobytes()
            assert verify_y(y, want, np.float64).failed_count == 0
        for got, full in zip(gather["elems"], gather_whole["elems"]):
            assert got < full
        if name == "block_diagonal":
            assert ops == 0 and spans == ((0, 0),) * D
            assert gather["ops"] == gather["elems"] == [0] * len(xs)
        else:
            assert all(pair != (0, 0) for pair in spans)
            assert all(n > 0 for n in gather["ops"])
    if name == "tailed":
        assert res["spans"][0][1] > 4000  # the tail's outliers, a block to the right


@pytest.mark.parametrize("D", [2, 4])
def test_span_solve_equals_whole_blocks(D):
    """On the 27-point operator, ``dist_swell_cg_solve`` over the spans takes
    the iterations of a solver whose matvec exchanges whole blocks, and gives
    its x byte for byte (plain start of 4 iterations, then masked blocks)."""
    for res in (r[4] for r in _all_ranks(D)):
        assert res["iters"] == res["whole_iters"] and 4 < res["iters"] < 500
        assert res["x"].tobytes() == res["whole_x"].tobytes()
    op = hpcg27.Operator({"nx": 8, "ny": 8, "nz": 32}, None, "cpu")
    resid = op(torch.from_numpy(res["x"])) - torch.from_numpy(_hpcg_b())
    assert float(resid.norm() / np.linalg.norm(_hpcg_b())) <= 1e-10
