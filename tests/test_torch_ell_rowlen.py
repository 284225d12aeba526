"""The ELL row-sum kernel's walk (``csrc/ell_rowsum.cu``) rewritten in numpy
over the port's own slab, and held against the JAX package's row-sum kernel
and the host golden; ``csr_to_ell``'s ``row_len``.

The kernel runs only on the card, so its arithmetic is checked here on the
same arrays: each row stops at ``row_len`` cells; lane ``j`` of ``vs`` takes
the row's vectors of ``e`` cells ``j, j + vs, ...`` (``e`` = 2 in float64, 4 in
float32, 1 where a row does not start on a 16-B boundary), the last partial
vector cell by cell; lane 0 adds ``0 * x[0]`` once for a row shorter than the
width; the lanes reduce in the kernel's shuffle tree.  JAX's kernels read
256 x 512 tiles and return NaN past a smaller slab in interpret mode, so their
slabs are zero-padded to whole tiles, as in ``test_torch_vector_row.py``.
Tolerances, element-wise, with ``B`` the row sums of ``|vals|·|x[col]|``:
float64 ``1e-12 · B``; float32 ``1e-5 · B`` (JAX sums in float32, the walk in
float64)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import powerlaw_csr, random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.vector_row import TILE_M, TILE_W, ell_rowsum_pallas
from spmv_acc_tpu_torch.formats.containers import CSR, ELL
from spmv_acc_tpu_torch.formats.convert import csr_to_ell
from spmv_acc_tpu_torch.ops import vector_row
from spmv_acc_tpu_torch.utils.verify import verify_y

TOL = {np.float64: 1e-12, np.float32: 1e-5}
VS = [2, 4, 8, 16, 32]


def lane_walk(vals, cols, row_len, x, vs, e):
    """The kernel's row sums, in its order: ``vals``/``cols`` the (rows, width)
    slab, ``row_len`` each row's stored cells (None: the width), ``e`` cells a
    vector.  Sums in float64, rounded once to the values' dtype."""
    rows, width = vals.shape
    lens = np.full(rows, width, np.int64) if row_len is None else row_len.astype(np.int64)
    with np.errstate(invalid="ignore"):
        prod = vals.astype(np.float64) * x.astype(np.float64)[cols]
        pad = 0.0 * np.float64(x[0]) if len(x) else 0.0
    nvec = lens // e
    steps = -(-int(nvec.max(initial=0)) // vs)
    r = np.arange(rows)
    acc = np.zeros((rows, vs))
    for j in range(vs):
        for s in range(steps):  # whole vectors j, j + vs, ...
            q = j + s * vs
            live = q < nvec
            for k in range(e):
                if q * e + k < width:
                    acc[live, j] += prod[live, q * e + k]
        for i in range(e):  # the last partial vector, cell by cell
            t = nvec * e + j + i * vs
            live = t < lens
            acc[live, j] += prod[r[live], t[live]]
    short = lens < width
    acc[short, 0] += pad  # the padding's 0 * x[0], once
    off = vs // 2
    while off:
        acc[:, :off] = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0].astype(vals.dtype)


def kernel_vector(width, itemsize):
    """Cells a vector, as the kernel picks them for a slab that starts aligned."""
    e = 16 // itemsize
    return e if width % e == 0 else 1


def _lengths_csr(m, n, width, seed):
    """m rows whose lengths cycle through 0, 1, width - 1 and width, then random
    ones; every third row holds column 0."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.tile([0, 1, width - 1, width], 8),
                           rng.integers(0, width + 1, m - 32)])
    cols = []
    for i, ln in enumerate(lens):
        c = rng.choice(np.arange(1, n), ln, replace=False)
        if ln and i % 3 == 0:
            c[0] = 0
        cols.append(np.sort(c))
    rp = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ci = np.concatenate(cols).astype(np.int32)
    return rp, ci, rng.standard_normal(len(ci)), (m, n)


CASES = {
    # width 24: rows of 0, 1, 23, 24 cells; 203 rows, so 5 padded rows
    "lengths": lambda: (_lengths_csr(203, 300, 24, seed=11), 8),
    # width 13 (width_multiple 1): not a multiple of either vector
    "odd_width": lambda: (_lengths_csr(150, 200, 13, seed=12), 1),
    "powerlaw": lambda: (powerlaw_csr(180, 180, avg_nnz=6, seed=2).to_numpy(), 8),
    "wide_rows": lambda: (random_csr(40, 900, 20000, seed=61).to_numpy(), 8),  # > one tile
}


@functools.lru_cache(maxsize=None)
def _case(name, dtype, inf=False):
    """(csr arrays, port ELL, x, JAX row sums) of one case, made once."""
    (rp, ci, v, (m, n)), wm = CASES[name]()
    v = np.asarray(v).astype(dtype)
    ell = csr_to_ell(CSR.from_numpy(rp, ci, v, (m, n)), width_multiple=wm)
    x = random_x_y(n, m, seed=13, dtype=dtype)[0]
    if inf:
        x[0] = np.inf
    vals, cols = ell.values.numpy(), ell.col_idx.numpy()
    pad = lambda a: jnp.asarray(_tile_padded(a))  # noqa: E731
    jax_sums = np.asarray(ell_rowsum_pallas(pad(vals), pad(x[cols])))[: ell.padded_rows]
    return (rp, ci, v, (m, n)), ell, x, jax_sums


def _tile_padded(a):
    out = np.zeros((-(-a.shape[0] // TILE_M) * TILE_M, -(-a.shape[1] // TILE_W) * TILE_W),
                   a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_csr_to_ell_row_len_is_the_csr_row_lengths(name):
    (rp, ci, v, shape), wm = CASES[name]()
    ell = csr_to_ell(CSR.from_numpy(rp, ci, v, shape), width_multiple=wm)
    lens = ell.row_len.numpy()
    assert ell.row_len.dtype == torch.int32 and lens.shape == (ell.padded_rows,)
    assert np.array_equal(lens[: shape[0]], np.diff(rp)) and not lens[shape[0]:].any()
    # the stored cells lead each row; the rest is padding (value 0, column 0)
    cells = np.arange(ell.width)[None, :] >= lens[:, None]
    assert not ell.values.numpy()[cells].any() and not ell.col_idx.numpy()[cells].any()
    if name == "odd_width":
        assert ell.width == 13 and lens.min() == 0 and lens.max() == 13


@pytest.mark.parametrize("vs", VS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_walk_matches_reference(name, dtype, vs):
    """The walk, at the kernel's vector and at single cells, against JAX's
    ``ell_rowsum_pallas`` and ``host_spmv``."""
    (rp, ci, v, (m, n)), ell, x, want = _case(name, dtype)
    vals, cols, lens = ell.values.numpy(), ell.col_idx.numpy(), ell.row_len.numpy()
    bound = (np.abs(vals.astype(np.float64)) * np.abs(x.astype(np.float64))[cols]).sum(1)
    golden = host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(m))
    for e in {kernel_vector(ell.width, vals.itemsize), 1}:
        got = lane_walk(vals, cols, lens, x, vs, e)
        assert got.dtype == dtype and np.isfinite(got).all()
        gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert (gap <= TOL[dtype] * bound).all(), (e, float(gap.max()))
        assert verify_y(got[:m], golden, dtype=dtype).ok


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["lengths", "odd_width"])
def test_slab_without_row_len_gives_the_same_sums(name, dtype):
    """An ELL built without ``row_len`` is read to the width: the same sums
    as the walk that stops at each row's length, and ``ell_rowsum`` takes it."""
    _, ell, x, _ = _case(name, dtype)
    bare = ELL(ell.col_idx, ell.values, ell.shape)
    vals, cols = ell.values.numpy(), ell.col_idx.numpy()
    bound = (np.abs(vals.astype(np.float64)) * np.abs(x.astype(np.float64))[cols]).sum(1)
    e = kernel_vector(ell.width, vals.itemsize)
    for vs in VS:
        a = lane_walk(vals, cols, None, x, vs, e).astype(np.float64)
        b = lane_walk(vals, cols, ell.row_len.numpy(), x, vs, e).astype(np.float64)
        ulp = 2.0**-23 * np.abs(b) if dtype == np.float32 else 0.0
        assert (np.abs(a - b) <= ulp + 1e-12 * bound).all()
    tx = torch.from_numpy(x)
    assert torch.equal(vector_row.ell_rowsum(bare, tx), vector_row.ell_rowsum(ell, tx))


@pytest.mark.parametrize("vs", VS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["lengths", "odd_width", "powerlaw"])
def test_inf_at_x0_spreads_as_in_the_whole_slab(name, dtype, vs):
    """x[0] = inf: exactly the rows with padding and the rows that hold column
    0 are non-finite, in the walk, in ``ell_rowsum_plain`` and in JAX's kernel;
    the other rows agree as above."""
    _, ell, x, want = _case(name, dtype, inf=True)
    vals, cols, lens = ell.values.numpy(), ell.col_idx.numpy(), ell.row_len.numpy()
    held = np.zeros(ell.padded_rows, bool)
    held[np.nonzero((cols == 0) & (np.arange(ell.width)[None, :] < lens[:, None]))[0]] = True
    expect = (lens < ell.width) | held
    assert expect.any() and (name == "powerlaw" or not expect.all())
    plain = vector_row.ell_rowsum_plain(ell, torch.from_numpy(x)).numpy()
    got = lane_walk(vals, cols, lens, x, vs, kernel_vector(ell.width, vals.itemsize))
    for out in (got, plain, want):
        assert np.array_equal(~np.isfinite(out), expect)
    fin = ~expect
    bound = (np.abs(vals[fin].astype(np.float64)) * np.abs(x.astype(np.float64))[cols[fin]]).sum(1)
    gap = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64))
    assert (gap <= TOL[dtype] * bound).all()


def test_vector_sizes_of_the_case_widths():
    """Every VS above is reached by some (width, dtype) of the rule."""
    assert {vector_row.vector_size(w, s) for w in (8, 24, 40, 128, 448) for s in (4, 8)} == set(VS)


def test_launch_checks_row_len():
    """The CUDA wrapper refuses a row_len it cannot hand the kernel, before it
    builds anything."""
    _, ell, x, _ = _case("lengths", np.float64)
    for bad in (ell.row_len.long(), ell.row_len[:-1]):
        with pytest.raises(ValueError, match="row_len"):
            vector_row._launch(ELL(ell.col_idx, ell.values, ell.shape, bad),
                               torch.from_numpy(x), 8)
