"""F-1, the chained loop's feedback (``ops/feedback.py``): its plain version
against the expression the port's chains ran before (``axpby_finish``, cast
to float32, mean of squares, ``x * (1 + mean * 1e-30)``), its in-place CPU
path, and the chains that use it against the JAX package's ``_swell_power_run``
and ``_swell_amx_power_run`` (Pallas interpret mode, x64).

Tolerances: the plain version repeats the old expression's operations, so it
is equal bit for bit.  Against JAX, y is scaled by 1e8 so that the multiplier
(1 + ~1e-14) moves x: both sides then agree within 1e-15 relative (the
float32 mean's summation order moves the multiplier by ~1e-21, below an ulp
of 1; the JAX SpMM body squares in float64, which moves it no further)."""

import numpy as np
import pytest
import torch

from spmv_acc_tpu.formats import banded_csr, random_csr
from spmv_acc_tpu.ops.swell import make_swell_amx_run as ref_make_swell_amx_run
from spmv_acc_tpu.ops.swell import make_swell_run as ref_make_swell_run
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.ops import feedback, swell
from spmv_acc_tpu_torch.ops.xla import axpby_finish

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _old_expression(x, ax, y, alpha, beta):
    """The feedback as ``make_swell_run`` / ``make_swell_amx_run`` wrote it."""
    s = (ax if y is None else axpby_finish(alpha, beta, ax, y)).float()
    return x * (1.0 + (s * s).mean().to(x.dtype) * 1e-30)


def _case(kind, dtype, scale):
    rng = np.random.default_rng(len(kind))
    m, n, k = {"square": (500, 500, 1), "rect": (700, 31, 1), "spmm": (300, 300, 8)}[kind]
    ax = torch.from_numpy(rng.uniform(-1, 1, (m, k)) * scale).to(dtype)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, k))).to(dtype)
    if k == 1:
        y = torch.from_numpy(rng.uniform(-1, 1, m) * scale).to(dtype)
        return x[:, 0].contiguous(), ax[:, 0].contiguous(), y
    return x, ax, None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["square", "rect", "spmm"])
@pytest.mark.parametrize("scale", [1.0, 1e11])
def test_plain_is_the_old_expression(kind, dtype, scale):
    x, ax, y = _case(kind, dtype, scale)
    got = feedback.feedback_plain(x, ax, y, 1.25, -0.5)
    assert torch.equal(got, _old_expression(x, ax, y, 1.25, -0.5))
    # float32: 1 + ~3e-9 rounds to 1 too
    assert torch.equal(got, x) == (scale == 1.0 or dtype == torch.float32)


@pytest.mark.parametrize("kind", ["square", "rect", "spmm"])
def test_in_place_on_the_cpu(kind):
    x, ax, y = _case(kind, torch.float64, 1e11)
    want = feedback.feedback_plain(x, ax, y, 2.0, 0.5)
    feedback.LAUNCHES.clear()
    xx = x.clone()
    out = feedback.feedback_(xx, ax, y, 2.0, 0.5)
    assert out is xx and torch.equal(xx, want) and not torch.equal(xx, x)
    assert not feedback.LAUNCHES  # the CPU runs the plain version: no kernel launch


def test_feedback_rejects_what_the_kernel_does_not_take():
    x, ax, y = _case("square", torch.float64, 1.0)
    with pytest.raises(ValueError, match="is torch.float32"):
        feedback.feedback_(x, ax.float(), y)
    with pytest.raises(ValueError, match="y has shape"):
        feedback.feedback_(x, ax, y[:-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        feedback.feedback_(x, torch.stack([ax, ax], 1)[:, 0], y)
    with pytest.raises(ValueError, match="empty"):
        feedback.feedback_(x, ax[:0], y[:0])
    with pytest.raises(ValueError, match="float64 and float32"):
        feedback.feedback_(x.half(), ax.half(), y.half())
    with pytest.raises(TypeError):
        feedback.feedback_(x, ax.numpy(), y)


@pytest.mark.parametrize("name,ref", [
    ("square", lambda: banded_csr(300, bandwidth=5, seed=70)),
    ("rect", lambda: random_csr(150, 260, 1700, seed=71)),
    ("tall", lambda: random_csr(4000, 300, 9000, seed=75)),
])
def test_swell_chain_matches_jax_power_run(name, ref):
    """make_swell_run (swell_ax, then F-1 in place) against the JAX package's
    _swell_power_run over 3 steps, with y large enough that x moves."""
    ref = ref()
    rp, ci, v, (m, n) = ref.to_numpy()
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-1, 1, n), rng.uniform(-1, 1, m) * 1e8
    want = np.asarray(ref_make_swell_run(ref, 1.25, -0.5)(jnp.asarray(x), jnp.asarray(y), 3))
    got = swell.make_swell_run(CSR.from_numpy(rp, ci, v, (m, n)), 1.25, -0.5)(
        torch.from_numpy(x), torch.from_numpy(y), 3).numpy()
    assert not np.array_equal(want, x)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_swell_amx_chain_matches_jax_power_run():
    ref = banded_csr(300, bandwidth=5, seed=70)
    rp, ci, v, (m, n) = ref.to_numpy()
    X = np.random.default_rng(11).uniform(-1, 1, (n, 8)) * 1e8
    want = np.asarray(ref_make_swell_amx_run(ref, 8)(jnp.asarray(X), 3))
    got = swell.make_swell_amx_run(CSR.from_numpy(rp, ci, v, (m, n)), 8)(
        torch.from_numpy(X), 3).numpy()
    assert not np.array_equal(want, X)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
