"""The chunk schedules that split long row blocks over several thread blocks of
the swell and tile kernels (``build_swell_schedule``, ``build_tile_schedule``),
and a chunked plain sum over them.

The kernels run only on a card; here the schedules' invariants are checked, and
the sum each kernel computes is written out in numpy in the kernels' order:
every chunk walks its slot rows (swell: moving to the next slab where one ends,
as the kernel does) into FP64 partials, and each split row block adds its
partials in chunk order.  That sum is held against the JAX package's
``spmv_swell`` / ``adaptive_plus`` on the CPU (Pallas interpret mode, as
``tests/test_torch_swell.py`` and ``tests/test_torch_adaptive_plus.py`` run
them) and against ``host_spmv``, element-wise within ``ROW_TOL·(|A|·|x|)``:
both sides sum in FP64 (the JAX swell kernel two-f32, ~1e-14 relative) in
another order, nothing else.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu import dispatch as ref_dispatch
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, random_csr
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays
from spmv_acc_tpu.formats.generate import example_like, fem_like_csr, random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.swell import spmv_swell as ref_spmv_swell
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import adaptive_plus, swell, swell_plan, tile_plan

ROW_TOL = 1e-12
LANES = 128
MAX_ROWS = (1, 4, 64)


def _long_row():
    """tests/test_torch_swell.py's matrix with one row of 260 entries."""
    m = 260
    rows = np.concatenate([np.repeat(np.arange(m), 2), np.full(m, 7)])
    cols = np.concatenate([np.tile(np.array([0, 1]), m) + np.repeat(np.arange(m), 2) % 100,
                           np.arange(m)])
    vals = np.random.default_rng(3).standard_normal(len(rows))
    rp, ci, v = coo_to_csr_arrays(rows, cols, vals, (m, m))
    return RefCSR.from_numpy(rp, ci, v, (m, m))


def _gap():
    """A band with rows 128..383 empty: two row blocks without a slab."""
    rp, ci, v, _ = banded_csr(700, bandwidth=7, seed=8).to_numpy()
    rows = np.repeat(np.arange(700), np.diff(rp))
    keep = (rows < 128) | (rows >= 384)
    rp, ci, v = coo_to_csr_arrays(rows[keep], ci[keep], v[keep], (700, 700))
    return RefCSR.from_numpy(rp, ci, v, (700, 700))


MATRICES = {
    "long_row": _long_row,
    "outlier": lambda: dense_row_outlier_csr(300, 300, avg_nnz=3, n_dense=3, seed=73),
    "banded": lambda: banded_csr(300, bandwidth=5, seed=70),
    "rajat03": lambda: example_like("rajat03"),
    "gap": _gap,
    # TSOPF_RS_b2383's structure class (dense 16-row node blocks), cut to 600 rows
    "tsopf_like": lambda: fem_like_csr(600, 600, 48000, block=16, spread_frac=0.01, seed=9),
    "random100": lambda: random_csr(100, 100, 2000, seed=78),
}
SWELL_CASES = [(name, r) for name in sorted(MATRICES)
               for r in ((1, 2, 3, 4) if name == "tsopf_like" else (1,))]
TILE_CASES = sorted(MATRICES)
# the JAX adaptive_plus float64 kernel takes seconds a matrix in interpret mode
TILE_JAX = ("random100", "tsopf_like")

_REF: dict = {}


def _case(name):
    """(reference CSR, x, host arrays, JAX spmv_swell's A@x), made once per module."""
    if name not in _REF:
        ref = MATRICES[name]()
        m, n = ref.shape
        x, _ = random_x_y(n, m, seed=75)
        out = np.asarray(ref_spmv_swell(1.0, 0.0, ref, jnp.asarray(x), jnp.asarray(np.zeros(m))))
        _REF[name] = (ref, x, ref.to_numpy(), out)
    return _REF[name]


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _bound(rp, ci, v, x):
    return host_spmv(1.0, 0.0, rp, ci, np.abs(v), np.abs(x), np.zeros(len(rp) - 1))


def _swell_layout(name, r):
    ref, x, (rp, ci, v, shape), _ = _case(name)
    return swell.get_swell_plan(CSR.from_numpy(rp, ci, v, shape), r=r)


def _rows_of_rb(layout):
    """First slot row of each row block and of each slab, and slab depths."""
    srow = layout.slab_off.numpy() // LANES
    depth = 1 << layout.slab_log2d.numpy().astype(np.int64)
    ends = np.append(srow, srow[-1] + depth[-1] if len(srow) else 0)
    return ends[layout.rb_slab_ptr.numpy()], srow, depth


def _check_parts(sc, mrb):
    """Partial slots: -1 for a row block's only chunk, else in chunk order."""
    nch = np.bincount(sc.rb, minlength=mrb)
    assert (nch >= 1).all()
    assert (np.diff(sc.rb) >= 0).all()
    sole = nch[sc.rb] == 1
    assert (sc.part[sole] == -1).all()
    assert np.array_equal(sc.part[~sole], np.arange(int((~sole).sum())))
    assert np.array_equal(sc.split_rb, np.flatnonzero(nch > 1))
    assert np.array_equal(np.diff(sc.split_ptr), nch[nch > 1]) and sc.split_ptr[0] == 0
    for i, rb in enumerate(sc.split_rb):
        assert np.array_equal(sc.part[sc.rb == rb], np.arange(sc.split_ptr[i], sc.split_ptr[i + 1]))
    packed = sc.packed()
    assert packed.dtype == np.int64 and len(packed) == (
        3 * sc.nchunks + 1 + 2 * sc.nsplit + 1 + len(sc.slab))


@pytest.mark.parametrize("max_rows", MAX_ROWS)
@pytest.mark.parametrize("name,r", SWELL_CASES)
def test_swell_schedule_invariants(name, r, max_rows):
    layout = _swell_layout(name, r)
    sc = swell_plan.build_swell_schedule(layout, max_rows)
    rb_row, srow, depth = _rows_of_rb(layout)
    assert sc.max_rows == max_rows
    # every slot row once, in layout order: the chunk pointer runs 0 .. all rows
    assert sc.ptr[0] == 0 and sc.ptr[-1] == layout.slots // LANES == rb_row[-1]
    assert (np.diff(sc.ptr) >= 0).all() and (np.diff(sc.ptr) <= max_rows).all()
    for rb in range(layout.mrb):
        mine = np.flatnonzero(sc.rb == rb)
        lo, hi = rb_row[rb], rb_row[rb + 1]
        # consecutive chunks that cover the row block's rows and never cross it
        assert np.array_equal(mine, np.arange(mine[0], mine[-1] + 1))
        assert sc.ptr[mine[0]] == lo and sc.ptr[mine[-1] + 1] == hi
        if hi == lo:
            assert len(mine) == 1  # an empty row block has one chunk, which writes zeros
        else:
            assert (np.diff(sc.ptr)[mine] > 0).all()
    live = np.diff(sc.ptr) > 0
    s = sc.slab[:-1][live]
    first = sc.ptr[:-1][live]
    assert ((srow[s] <= first) & (first < srow[s] + depth[s])).all()
    rb_slab_ptr = layout.rb_slab_ptr.numpy()
    slab = sc.slab[:-1]
    assert ((rb_slab_ptr[sc.rb] <= slab) & (slab <= rb_slab_ptr[sc.rb + 1])).all()
    # a row-block's only chunk walks exactly its slabs, slab[c] .. slab[c+1] - 1
    assert len(sc.slab) == sc.nchunks + 1 and sc.slab[-1] == len(srow)
    sole = sc.part < 0
    assert np.array_equal(sc.slab[:-1][sole], rb_slab_ptr[sc.rb[sole]])
    assert np.array_equal(sc.slab[1:][sole], rb_slab_ptr[sc.rb[sole] + 1])
    _check_parts(sc, layout.mrb)


def test_swell_schedule_covers_empty_row_blocks():
    layout = _swell_layout("gap", 1)
    sc = swell_plan.build_swell_schedule(layout, 4)
    empty = np.flatnonzero(np.diff(layout.rb_slab_ptr.numpy()) == 0)
    assert list(empty) == [1, 2]
    for rb in empty:
        c = np.flatnonzero(sc.rb == rb)
        assert len(c) == 1 and sc.ptr[c[0]] == sc.ptr[c[0] + 1] and sc.part[c[0]] == -1


def _swell_chunked_sum(layout, sc, X):
    """The swell kernel's sum over schedule ``sc`` in numpy: (out_rows, k)."""
    r, k = layout.r, X.shape[1]
    vals = layout.vals.numpy().astype(np.float64)
    lidx = layout.lidx.numpy().astype(np.int64)
    off = layout.slab_off.numpy()
    log2d = layout.slab_log2d.numpy().astype(np.int64)
    col_base = layout.slab_col_base.numpy().astype(np.int64)
    Xn = np.zeros((layout.cols * r + r, k))
    Xn[: layout.x_rows] = X
    acc = np.zeros((sc.nchunks, LANES, r, k))
    for c in range(sc.nchunks):
        if sc.part[c] < 0:  # a row-block's only chunk: its slabs, whole
            walk = [(off[s] // LANES, off[s] // LANES + (1 << log2d[s]), s)
                    for s in range(sc.slab[c], sc.slab[c + 1])]
        else:  # from slot row ptr[c] in slab[c], to slot row ptr[c+1]
            walk, row, end, s = [], sc.ptr[c], sc.ptr[c + 1], sc.slab[c]
            while row < end:
                te = min(off[s] // LANES + (1 << log2d[s]), end)
                walk.append((row, te, s))
                row, s = te, s + 1
        for row, te, s in walk:
            for t in range(row, te):
                node = col_base[s] + lidx[t * LANES:(t + 1) * LANES]           # (128,)
                cells = vals[t * LANES * r * r:(t + 1) * LANES * r * r].reshape(r, r, LANES)
                for l in range(r):
                    xr = node * r + l
                    live = (node >= 0) & (xr < layout.x_rows)
                    xv = np.where(live[:, None], Xn[np.where(live, xr, 0)], 0.0)  # (128, k)
                    acc[c] += cells[:, l, :].T[:, :, None] * xv[:, None, :]
    out = np.zeros((layout.mrb, LANES, r, k))
    sole = sc.part < 0
    out[sc.rb[sole]] = acc[sole]
    for i, rb in enumerate(sc.split_rb):
        total = np.zeros((LANES, r, k))
        for c in np.flatnonzero(sc.rb == rb):  # chunk order
            total += acc[c]
        out[rb] = total
    out = out.reshape(-1, k)[: layout.out_rows]
    if layout.tail_v.numel():  # the COO tail of a scalar plan
        np.add.at(out, layout.tail_rows.numpy(),
                  layout.tail_v.numpy()[:, None] * Xn[layout.tail_ci.numpy()])
    return out


@pytest.mark.parametrize("max_rows", MAX_ROWS)
@pytest.mark.parametrize("name,r", SWELL_CASES)
def test_swell_chunked_sum_matches_reference(name, r, max_rows):
    ref, x, (rp, ci, v, shape), ref_ax = _case(name)
    layout = _swell_layout(name, r)
    sc = swell_plan.build_swell_schedule(layout, max_rows)
    got = _swell_chunked_sum(layout, sc, x[:, None])[:, 0]
    golden = host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(shape[0]))
    bound = ROW_TOL * _bound(rp, ci, v, x)
    assert (np.abs(got - golden) <= bound).all()
    assert (np.abs(got - ref_ax) <= bound).all()


@pytest.mark.parametrize("max_rows", (1, 4))
@pytest.mark.parametrize("r,k", [(1, 3), (2, 8), (4, 8)])
def test_swell_chunked_spmm_matches_golden(r, k, max_rows):
    _, _, (rp, ci, v, shape), _ = _case("tsopf_like")
    layout = _swell_layout("tsopf_like", r)
    sc = swell_plan.build_swell_schedule(layout, max_rows)
    X = np.random.default_rng(4).standard_normal((shape[1], k))
    got = _swell_chunked_sum(layout, sc, X)
    for j in range(k):
        golden = host_spmv(1.0, 0.0, rp, ci, v, X[:, j], np.zeros(shape[0]))
        assert (np.abs(got[:, j] - golden) <= ROW_TOL * _bound(rp, ci, v, X[:, j])).all()


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_swell_schedule_follows_the_module_constant(monkeypatch, r):
    """A plan takes SWELL_CHUNK_ROWS // r (at least 1) as the constant is when
    the plan is built."""
    _, _, (rp, ci, v, shape), _ = _case("tsopf_like")
    monkeypatch.setattr(swell_plan, "SWELL_CHUNK_ROWS", 8)
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, shape), r=r)
    assert layout.schedule.max_rows == max(1, 8 // r) and layout.schedule.nsplit > 0
    assert torch.equal(layout.sched, torch.from_numpy(layout.schedule.packed()))
    again = swell.rescheduled(layout, 64)
    assert again.schedule.max_rows == 64 and again.vals is layout.vals
    with pytest.raises(ValueError):
        swell_plan.build_swell_schedule(layout, 0)


@pytest.mark.parametrize("max_rows", MAX_ROWS)
@pytest.mark.parametrize("name", TILE_CASES)
def test_tile_schedule_invariants(name, max_rows):
    _, _, (rp, ci, v, shape), _ = _case(name)
    dp = adaptive_plus.get_tile_plan(CSR.from_numpy(rp, ci, v, shape))
    depth = dp.blk_depth.numpy().astype(np.int64)
    rb_ptr = dp.rb_ptr.numpy()
    sc = tile_plan.build_tile_schedule(depth, rb_ptr, max_rows)
    assert sc.ptr[0] == 0 and sc.ptr[-1] == len(depth) and len(sc.slab) == 0
    assert (np.diff(sc.ptr) >= 0).all()
    cum = np.concatenate([[0], np.cumsum(depth)])
    for c in range(sc.nchunks):
        b0, b1, rb = sc.ptr[c], sc.ptr[c + 1], sc.rb[c]
        assert rb_ptr[rb] <= b0 <= b1 <= rb_ptr[rb + 1]  # never crosses its row block
        if b1 > b0:
            rows = cum[b1] - cum[b0]
            assert rows <= max_rows or b1 == b0 + 1  # a chunk holds at least one block
            # greedy: the next block of the row block would not have fitted
            assert b1 == rb_ptr[rb + 1] or rows + depth[b1] > max_rows
        else:
            assert rb_ptr[rb] == rb_ptr[rb + 1]  # only an empty row block's chunk is empty
    for rb in range(dp.num_row_blocks):
        mine = np.flatnonzero(sc.rb == rb)
        assert np.array_equal(mine, np.arange(mine[0], mine[-1] + 1))
        assert sc.ptr[mine[0]] == rb_ptr[rb] and sc.ptr[mine[-1] + 1] == rb_ptr[rb + 1]
    _check_parts(sc, dp.num_row_blocks)


def _tile_chunked_sum(dp, sc, x):
    """The tile kernel's sum over schedule ``sc`` in numpy: (rows,)."""
    vals = dp.vals.numpy().astype(np.float64).reshape(-1, LANES)
    lidx = dp.lidx.numpy().astype(np.int64).reshape(-1, LANES)
    off, depth, ct = (a.numpy().astype(np.int64) for a in (dp.blk_off, dp.blk_depth, dp.blk_ct))
    xp = np.zeros((int(ct.max(initial=0)) + 1) * LANES)
    xp[: dp.cols] = x
    acc = np.zeros((sc.nchunks, LANES))
    for c in range(sc.nchunks):
        for b in range(sc.ptr[c], sc.ptr[c + 1]):
            xs = xp[ct[b] * LANES:(ct[b] + 1) * LANES]
            for t in range(off[b], off[b] + depth[b]):
                acc[c] += vals[t] * xs[lidx[t]]
    out = np.zeros((dp.num_row_blocks, LANES))
    sole = sc.part < 0
    out[sc.rb[sole]] = acc[sole]
    for rb in sc.split_rb:
        total = np.zeros(LANES)
        for c in np.flatnonzero(sc.rb == rb):  # chunk order
            total += acc[c]
        out[rb] = total
    return out.reshape(-1)[: dp.rows]


@pytest.mark.parametrize("max_rows", MAX_ROWS)
@pytest.mark.parametrize("name", TILE_CASES)
def test_tile_chunked_sum_matches_reference(name, max_rows):
    ref, x, (rp, ci, v, shape), _ = _case(name)
    dp = adaptive_plus.get_tile_plan(CSR.from_numpy(rp, ci, v, shape))
    sc = adaptive_plus.rescheduled(dp, max_rows).schedule
    got = _tile_chunked_sum(dp, sc, x)
    bound = ROW_TOL * _bound(rp, ci, v, x)
    assert (np.abs(got - host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(shape[0]))) <= bound).all()
    if name in TILE_JAX and max_rows == 1:
        want = np.asarray(ref_dispatch.spmv(ref, jnp.asarray(x), jnp.asarray(np.zeros(shape[0])),
                                            1.0, 0.0, strategy="adaptive_plus"))
        assert (np.abs(got - want) <= bound).all()


def test_tile_schedule_follows_the_module_constant(monkeypatch):
    _, _, (rp, ci, v, shape), _ = _case("tsopf_like")
    monkeypatch.setattr(tile_plan, "TILE_CHUNK_ROWS", 4)
    dp = adaptive_plus.get_tile_plan(CSR.from_numpy(rp, ci, v, shape))
    assert dp.schedule.max_rows == 4 and dp.schedule.nsplit > 0
    assert torch.equal(dp.sched, torch.from_numpy(dp.schedule.packed()))
    with pytest.raises(ValueError):
        tile_plan.build_tile_schedule(dp.blk_depth, dp.rb_ptr, 0)
