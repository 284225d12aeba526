"""The port's bf16 plane split (``prep_x_plain``, the CPU path of ``prep_x``)
and the plane form of the swell product (``swell_ax_planes_plain``) against
the JAX package: ``_prep_x_pure(native=False)`` and K-d itself
(``_plane_split_call``, run under ``force_tpu_interpret_mode``).

Tolerances: the planes must be equal bit for bit (compared as int16, so -0.0
and every rounding tie count).  The plane-form product equals
``swell_ax_plain`` of the x~ the planes hold exactly (same arithmetic), and in
float32, where x~ == x, the direct product exactly; in float64 it lies within
2^-40 (|A|·|x|) of the direct product (x~ keeps 48 bits of x)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spmv_acc_tpu.formats import banded_csr, random_csr
from spmv_acc_tpu.formats.generate import fem_like_csr
from spmv_acc_tpu.ops import swell as ref_swell
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import swell

# delta 2, 0, 117 and 0 with three x chunks
MATRICES = {
    "banded": lambda: banded_csr(300, bandwidth=5, seed=70),
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "tall": lambda: random_csr(40000, 300, 9000, seed=75),
    "wide": lambda: random_csr(300, 40000, 9000, seed=76),
}
DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _layout(name, dtype, r=1):
    np_dt, t_dt = DTYPES[dtype]
    ref = MATRICES[name]() if isinstance(name, str) else name
    csr = CSR.from_numpy(*ref.to_numpy()).astype(t_dt)
    return swell.get_swell_plan(csr, r=r), np_dt


def _x(n, np_dt, seed=3, k=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n if k is None else (n, k))
    # edge values: signed zeros, exact bf16 values, rounding ties, large and
    # small (none whose planes are subnormal: XLA on the CPU flushes those)
    edge = np.array([-0.0, 0.0, 1.0, -1.5, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8,
                     -(1.0 + 2.0**-8 + 2.0**-16), 3.0e38, -1.0e-20, 2.0**-100])
    flat = x.reshape(-1)
    flat[: min(len(edge), flat.size)] = edge[: flat.size]
    return x.astype(np_dt)


def _ref_planes(layout, x, np_dt, r=1, k=1):
    return np.asarray(ref_swell._prep_x_pure(jnp.asarray(x), layout.nchunks,
                                             np_dt == np.float64, native=False,
                                             delta=layout.delta, r=r, k=k))


def _bits(p):
    return p.view(torch.int16).numpy() if isinstance(p, torch.Tensor) else p.view(np.int16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_prep_x_plain_matches_reference(name, dtype):
    layout, np_dt = _layout(name, dtype)
    x = _x(layout.x_rows, np_dt)
    got = swell.prep_x_plain(layout, torch.from_numpy(x))
    want = _ref_planes(layout, x, np_dt)
    sets = 2 if np_dt == np.float64 else 1
    assert tuple(got.shape) == want.shape == (layout.nchunks, 128, 3 * sets * 128)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["banded", "tall", "wide"])
def test_prep_x_plain_matches_plane_split_kernel(name, dtype):
    """K-d itself (interpret mode) on the padded sets the JAX package feeds it."""
    layout, np_dt = _layout(name, dtype)
    x = _x(layout.x_rows, np_dt, seed=4)
    n_pad = layout.nchunks * 128 * 128

    def pad(a):
        return jnp.zeros((n_pad,), jnp.float32).at[layout.delta: layout.delta + len(x)].set(
            a).reshape(layout.nchunks, 128, 128)

    xj = jnp.asarray(x)
    if np_dt == np.float64:
        hi = xj.astype(jnp.float32)
        parts = [pad(hi), pad((xj - hi.astype(jnp.float64)).astype(jnp.float32))]
    else:
        parts = [pad(xj)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_swell._plane_split_call(parts))
    got = swell.prep_x_plain(layout, torch.from_numpy(x))
    assert np.array_equal(_bits(got), _bits(want))


def test_plans_under_test_have_a_column_shift():
    assert _layout("banded", "float64")[0].delta > 0
    assert _layout("tall", "float64")[0].delta > 0
    assert _layout("wide", "float64")[0].nchunks == 3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,k", [(2, 1), (2, 3), (4, 1), (4, 3)])
def test_prep_x_plain_slice_layouts_match_reference(r, k, dtype):
    """BSR r x r plans and k columns: slice s = c*r + j of X, node-level delta."""
    ref = fem_like_csr(602, 602, 9000, block=4, seed=5)
    layout, np_dt = _layout(ref, dtype, r=r)
    assert layout.r == r
    X = _x(layout.x_rows, np_dt, seed=6, k=k)
    x = X[:, 0].copy() if k == 1 else X
    got = swell.prep_x_plain(layout, torch.from_numpy(x))
    want = _ref_planes(layout, x, np_dt, r=r, k=k)
    assert np.array_equal(_bits(got), _bits(want))


def _x_tilde(layout, planes_bits, np_dt):
    """x~ from the reference's planes in numpy: each set's three planes summed
    in float32 (exact), hi + lo in float64."""
    f = (planes_bits.astype(np.int32) << 16).view(np.float32)   # (nchunks, 128, K*128)
    K = f.shape[2] // 128
    f = f.reshape(-1, K, 128).transpose(0, 2, 1).reshape(-1, K)  # (n_pad, K)
    f = f[layout.delta: layout.delta + layout.x_rows]
    hi = (f[:, 0] + f[:, 1]) + f[:, 2]
    if K == 3:
        return hi
    return hi.astype(np.float64) + ((f[:, 3] + f[:, 4]) + f[:, 5]).astype(np.float64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_swell_ax_planes_plain_matches_swell_of_x_tilde(name, dtype):
    layout, np_dt = _layout(name, dtype)
    x = np.random.default_rng(8).uniform(-1, 1, layout.x_rows).astype(np_dt)
    planes = swell.prep_x(layout, torch.from_numpy(x))
    got = swell.swell_ax_planes(layout, planes)
    assert torch.equal(got, swell.swell_ax_planes_plain(layout, planes))
    xt = _x_tilde(layout, _bits(_ref_planes(layout, x, np_dt)), np_dt)
    assert torch.equal(got, swell.swell_ax_plain(layout, torch.from_numpy(xt)))
    direct = swell.swell_ax_plain(layout, torch.from_numpy(x))
    if np_dt == np.float32:
        assert np.array_equal(xt, x) and torch.equal(got, direct)
    else:
        rp, ci, v, _ = MATRICES[name]().to_numpy()
        bound = np.zeros(layout.out_rows)
        np.add.at(bound, np.repeat(np.arange(layout.out_rows), np.diff(rp)), np.abs(v * x[ci]))
        assert (np.abs(got.numpy() - direct.numpy()) <= 2.0**-40 * bound).all()


def test_prep_x_on_the_cpu_launches_nothing():
    layout, np_dt = _layout("banded", "float64")
    x = torch.from_numpy(_x(layout.x_rows, np_dt))
    before = sum(swell.LAUNCHES.values())
    assert torch.equal(swell.prep_x(layout, x).view(torch.int16),
                       swell.prep_x_plain(layout, x).view(torch.int16))
    swell.swell_ax_planes(layout, swell.prep_x(layout, x))
    assert sum(swell.LAUNCHES.values()) == before == 0


def test_plane_functions_check_inputs():
    layout, _ = _layout("banded", "float64")
    with pytest.raises(ValueError):
        swell.prep_x(layout, torch.zeros(layout.x_rows, dtype=torch.float32))
    with pytest.raises(ValueError):
        swell.prep_x(layout, torch.zeros(layout.x_rows + 1, dtype=torch.float64))
    with pytest.raises(TypeError):
        swell.prep_x(layout, np.zeros(layout.x_rows))
    good = swell.prep_x(layout, torch.zeros(layout.x_rows, dtype=torch.float64))
    with pytest.raises(ValueError):
        swell.swell_ax_planes(layout, good[:, :, :384].contiguous())
    with pytest.raises(TypeError):
        swell.swell_ax_planes(layout, good.float())
    bsr, _ = _layout(fem_like_csr(602, 602, 9000, block=4, seed=5), "float64", r=2)
    with pytest.raises(ValueError):
        swell.swell_ax_planes(bsr, good)
