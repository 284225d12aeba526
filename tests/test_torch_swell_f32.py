"""The port's float32 swell path against the JAX package's f32 swell (Pallas
interpret mode) and the CPU golden, through ``spmv_swell``, ``spmv(adaptive)``,
``make_spmv_fn`` and ``spmv-cli --dtype float32``.

Tolerances: every f32 output passes the reference's f32 gate (``config.py``
``*_F32``: rel 1e-3, abs 1e-5 near |golden| <= 1e-4) against ``host_spmv``
evaluated in float64 on the same float32 inputs.  The kernel's plain version
sums in float64 and rounds once, so ``swell_ax`` in float32 is also held to one
float32 rounding of the float64 sum: |ax - golden| <= 2^-24 |golden| plus
1e-12 * (|A|·|x|)[row] for the float64 summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.cli.main import main as ref_cli_main
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.generate import example_like, random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.swell import spmv_swell as ref_spmv_swell
from spmv_acc_tpu_torch import dispatch
from spmv_acc_tpu_torch.cli.main import main as cli_main
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.io import write_bin2
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.utils.verify import verify_y

F32 = np.float32

MATRICES = {
    # the JAX package's f32 swell cases (tests/test_swell.py:90) and more shapes
    "banded": lambda: banded_csr(300, bandwidth=5, seed=70),
    "random": lambda: random_csr(150, 260, 1700, seed=71),
    "window_dense": lambda: random_csr(64, 100, 3000, seed=74),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=72),
    "outlier": lambda: dense_row_outlier_csr(140, 140, avg_nnz=3, n_dense=2, seed=73),
    "wide": lambda: random_csr(300, 40000, 9000, seed=76),
    "rajat03": lambda: example_like("rajat03"),
    "af23560": lambda: example_like("af23560"),
}


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    dispatch.clear_caches()


def _f32_case(name, seed=77):
    ref = MATRICES[name]().astype(jnp.float32)
    m, n = ref.shape
    x, y = random_x_y(n, m, seed=seed, dtype=F32)
    return ref, x, y


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_swell_f32_matches_reference(name):
    ref, x, y = _f32_case(name)
    rp, ci, v, _ = ref.to_numpy()
    assert v.dtype == F32
    ref_out = np.asarray(ref_spmv_swell(1.0, 1.0, ref, jnp.asarray(x), jnp.asarray(y)))
    out = swell.spmv_swell(1.0, 1.0, CSR.from_numpy(rp, ci, v, ref.shape),
                           torch.from_numpy(x), torch.from_numpy(y))
    assert out.dtype == torch.float32
    golden = host_spmv(1.0, 1.0, rp, ci, v, x, y)
    assert verify_y(out, golden, dtype=F32).ok
    assert verify_y(ref_out, golden, dtype=F32).ok


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_swell_ax_f32_rounds_once(name):
    ref, x, _ = _f32_case(name, seed=78)
    rp, ci, v, (m, n) = ref.to_numpy()
    layout = swell.get_swell_plan(CSR.from_numpy(rp, ci, v, (m, n)))
    assert layout.dtype == torch.float32 and layout.vals.dtype == torch.float32
    ax = swell.swell_ax(layout, torch.from_numpy(x)).numpy()
    golden = host_spmv(1.0, 0.0, rp, ci, v, x, np.zeros(m))
    bound = host_spmv(1.0, 0.0, rp, ci, np.abs(v.astype(np.float64)),
                      np.abs(x.astype(np.float64)), np.zeros(m))
    assert (np.abs(ax - golden) <= 2.0**-24 * np.abs(golden) + 1e-12 * bound).all()


@pytest.mark.parametrize("name", ["af23560", "rajat03"])
def test_adaptive_f32_picks_swell(name):
    ref, x, y = _f32_case(name, seed=79)
    rp, ci, v, shape = ref.to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    h = dispatch.Handle()
    out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), 1.5, -0.5, handle=h)
    assert h.strategy_used == "swell" and out.dtype == torch.float32
    assert verify_y(out, host_spmv(1.5, -0.5, rp, ci, v, x, y), dtype=F32).ok
    fn, chosen = dispatch.make_spmv_fn(csr, 1.5, -0.5)
    assert chosen == "swell"
    assert torch.equal(fn(torch.from_numpy(x), torch.from_numpy(y)), out)


def test_f32_plan_of_f64_values_and_dtype_checks():
    rp, ci, v, shape = random_csr(90, 80, 700, seed=80).to_numpy()
    csr64 = CSR.from_numpy(rp, ci, v, shape)
    lay32 = swell.get_swell_plan(csr64, dtype=torch.float32)
    assert lay32.dtype == torch.float32 and lay32 is not swell.get_swell_plan(csr64)
    assert swell.get_swell_plan(csr64, dtype=np.float32) is lay32
    x = torch.from_numpy(random_x_y(80, 90, seed=81, dtype=F32)[0])
    golden = host_spmv(1.0, 0.0, rp, ci, v.astype(F32), x.numpy(), np.zeros(90))
    assert verify_y(swell.swell_ax(lay32, x), golden, dtype=F32).ok
    with pytest.raises(ValueError):
        swell.swell_ax(lay32, x.double())
    csr32 = CSR.from_numpy(rp, ci, v.astype(F32), shape)
    with pytest.raises(ValueError):
        swell.get_swell_plan(csr32, dtype=torch.float64)
    with pytest.raises(ValueError):
        swell.get_swell_plan(csr32, dtype=torch.float16)


@pytest.mark.parametrize("name", ["af23560", "random"])
def test_cli_float32_passes_like_reference(name, tmp_path, capsys):
    """``spmv-cli --dtype float32`` passes the reference's f32 gate."""
    path = str(tmp_path / f"{name}.bin2")
    write_bin2(path, *MATRICES[name]().to_numpy())
    assert cli_main([path, "-f", "bin2", "--dtype", "float32", "--warmups", "1",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[strategy: swell]" in out
    assert ref_cli_main([path, "-f", "bin2", "--dtype", "float32", "--warmups", "1"]) == 0
    ref_out = capsys.readouterr().out
    m = MATRICES[name]().shape[0]
    line = f"Congratulation, pass {m} validation!"
    assert line in out.splitlines() and line in ref_out.splitlines()
