"""The port's public entry points against the JAX package's: ``spmv`` with the
adaptive picker, trans='T', the empty matrix, every strategy through each
entry point, and the spmv-cli port on csr/mtx/bin2 files."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu import dispatch as ref_dispatch
from spmv_acc_tpu.cli.main import main as ref_cli_main
from spmv_acc_tpu.formats import random_csr
from spmv_acc_tpu.formats.generate import example_like, random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu_torch import dispatch, spmm
from spmv_acc_tpu_torch.cli.main import main as cli_main
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.io import write_bin2, write_csr_text, write_mtx
from spmv_acc_tpu_torch.ops import swell
from spmv_acc_tpu_torch.utils.verify import verify_y

ALPHA, BETA = 1.25, -0.5


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    dispatch.clear_caches()


def _port(ref):
    return CSR.from_numpy(*ref.to_numpy())


def _close(out, ref_out, rp, ci, v, x, y):
    """Row-wise agreement within 1e-12 * (|alpha||A||x| + |beta y|)[row]."""
    scale = host_spmv(abs(ALPHA), abs(BETA), rp, ci, np.abs(v), np.abs(x), np.abs(y))
    return bool((np.abs(np.asarray(out) - np.asarray(ref_out)) <= 1e-12 * scale).all())


@pytest.mark.parametrize("name", ["rajat03", "dw4096", "af23560", "bcsstk18", "poli_large"])
def test_adaptive_picks_swell_and_matches_reference(name):
    ref = example_like(name)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=31)
    ref_out = ref_dispatch.spmv(ref, jnp.asarray(x), jnp.asarray(y), ALPHA, BETA)
    h = dispatch.Handle()
    out = dispatch.spmv(_port(ref), torch.from_numpy(x), torch.from_numpy(y), ALPHA, BETA,
                        strategy="adaptive", handle=h)
    assert h.strategy_used == "swell"
    assert h.analyze_time_us > 0 and h.kernel_time_us > 0
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok
    assert _close(out, ref_out, rp, ci, v, x, y)


def _sleepy(fn, secs=0.2):
    def slow(*args, **kwargs):
        time.sleep(secs)
        return fn(*args, **kwargs)

    return slow


def test_handle_puts_the_picker_in_kernel_time(monkeypatch):
    """As in the reference (spmv_acc_tpu/dispatch.py:222-225), the analyze time
    ends with get_plan: the picker (which builds the swell layout) falls into
    kernel_time_us."""
    csr = _port(random_csr(60, 60, 400, seed=40))
    monkeypatch.setattr(dispatch, "pick_strategy", _sleepy(dispatch.pick_strategy))
    h = dispatch.Handle()
    dispatch.spmv(csr, torch.ones(60, dtype=torch.float64), strategy="adaptive", handle=h)
    assert h.strategy_used == "swell"
    assert h.analyze_time_us < 2e5 and h.kernel_time_us >= 2e5


@pytest.mark.parametrize("strategy", ["adaptive", "swell"])
def test_handle_analyze_time_is_get_plan_for_every_strategy_name(monkeypatch, strategy):
    csr = _port(random_csr(60, 60, 400, seed=41))
    monkeypatch.setattr(dispatch, "get_plan", _sleepy(dispatch.get_plan))
    h = dispatch.Handle()
    dispatch.spmv(csr, torch.ones(60, dtype=torch.float64), strategy=strategy, handle=h)
    assert h.analyze_time_us >= 2e5 and h.kernel_time_us < 2e5


def test_transpose_matches_reference():
    ref = random_csr(150, 260, 1700, seed=71)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(m, n, seed=32)  # A^T is (n, m)
    ref_out = ref_dispatch.spmv(ref, jnp.asarray(x), jnp.asarray(y), ALPHA, BETA, trans="T")
    csr = _port(ref)
    out = dispatch.sparse_csr_spmv("T", ALPHA, BETA, csr, torch.from_numpy(x),
                                   torch.from_numpy(y))
    assert out.shape == (n,)
    dense = np.zeros((m, n))
    dense[np.repeat(np.arange(m), np.diff(rp)), ci] = v
    trp, tci, tv = (np.asarray(a) for a in dispatch._get_transposed(csr).to_numpy()[:3])
    assert verify_y(out, host_spmv(ALPHA, BETA, trp, tci, tv, x, y)).ok
    np.testing.assert_allclose(out.numpy(), ALPHA * dense.T @ x + BETA * y, rtol=1e-12,
                               atol=1e-12)
    assert _close(out, ref_out, trp, tci, tv, x, y)
    assert dispatch._get_transposed(csr) is dispatch._get_transposed(csr)


def test_empty_matrix_goes_to_default():
    csr = CSR.from_numpy(np.zeros(6, np.int32), np.zeros(0, np.int32), np.zeros(0), (5, 7))
    h = dispatch.Handle()
    y = torch.arange(5, dtype=torch.float64)
    out = dispatch.spmv(csr, torch.ones(7, dtype=torch.float64), y, 2.0, 3.0, handle=h)
    assert h.strategy_used == "default"
    assert torch.equal(out, 3.0 * y)


@pytest.mark.parametrize("strategy", sorted(dispatch.STRATEGIES))
def test_matrix_without_columns_gives_beta_y(strategy):
    """An m x 0 matrix: every strategy returns beta*y; the padded layouts hold
    column 0 in their padding, which an empty x does not have."""
    csr = CSR.from_numpy(np.zeros(6, np.int32), np.zeros(0, np.int32), np.zeros(0), (5, 0))
    x, y = torch.zeros(0, dtype=torch.float64), torch.arange(5, dtype=torch.float64)
    assert torch.equal(dispatch.spmv(csr, x, y, 2.0, 3.0, strategy=strategy), 3.0 * y)
    fn, _ = dispatch.make_spmv_fn(csr, 2.0, 3.0, strategy=strategy)
    assert torch.equal(fn(x, y), 3.0 * y)


def test_default_strategy_matches_golden():
    ref = random_csr(90, 80, 700, seed=33)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=34)
    out = dispatch.spmv(_port(ref), torch.from_numpy(x), torch.from_numpy(y), ALPHA, BETA,
                        strategy="default")
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok


# the names that raised NotImplementedError before the zoo was ported
ZOO_NAMES = sorted(dispatch.STRATEGIES - {"adaptive", "default", "swell"})


@pytest.mark.parametrize("strategy", ZOO_NAMES)
def test_strategy_runs_through_every_entry_point(strategy):
    """spmv, make_spmv_fn and sparse_csr_spmv run the strategy and agree."""
    ref = random_csr(40, 40, 200, seed=35)
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = random_x_y(n, m, seed=35)
    csr = _port(ref)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    h = dispatch.Handle()
    out = dispatch.spmv(csr, tx, ty, ALPHA, BETA, strategy=strategy, handle=h)
    assert h.strategy_used == strategy
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok
    fn, chosen = dispatch.make_spmv_fn(csr, ALPHA, BETA, strategy=strategy)
    assert chosen == strategy and torch.equal(fn(tx, ty), out)
    assert torch.equal(dispatch.sparse_csr_spmv("N", ALPHA, BETA, csr, tx, ty, strategy), out)


def test_unknown_strategy_raises():
    csr = _port(random_csr(40, 40, 200, seed=35))
    with pytest.raises(ValueError):
        dispatch.spmv(csr, torch.zeros(40, dtype=torch.float64), strategy="nope")


def test_below_fill_gate_runs_reference_tree_choice(monkeypatch):
    """Below the swell gate the picker takes the reference's tree and runs it."""
    ref = example_like("rajat03")
    rp, ci, v, (m, n) = ref.to_numpy()
    csr = _port(ref)
    monkeypatch.setattr(dispatch, "SWELL_MIN_FILL", 2.0)
    expect = ref_dispatch.pick_strategy(ref_dispatch.get_plan(ref), ref)
    assert dispatch.pick_strategy(dispatch.get_plan(csr), csr) == expect
    x, y = random_x_y(n, m, seed=39)
    h = dispatch.Handle()
    out = dispatch.spmv(csr, torch.from_numpy(x), torch.from_numpy(y), ALPHA, BETA, handle=h)
    assert h.strategy_used == expect
    assert verify_y(out, host_spmv(ALPHA, BETA, rp, ci, v, x, y)).ok


def test_slot_cap_passes_swell_over_without_building(monkeypatch):
    """Past SWELL_MAX_SLOTS the picker takes the reference's tree choice, an
    explicit swell request raises ValueError, and no layout is ever built."""
    ref = example_like("rajat03")
    csr = _port(ref)
    built = []
    monkeypatch.setattr(swell, "build_swell_layout", built.append)
    monkeypatch.setattr(swell, "SWELL_MAX_SLOTS", 1000)
    expect = ref_dispatch.pick_strategy(ref_dispatch.get_plan(ref), ref)
    assert dispatch.pick_strategy(dispatch.get_plan(csr), csr) == expect != "swell"
    assert swell.swell_plan_within_cap(csr) is None
    x = torch.zeros(csr.cols, dtype=torch.float64)
    h = dispatch.Handle()
    assert torch.equal(dispatch.spmv(csr, x, handle=h), torch.zeros(csr.rows, dtype=torch.float64))
    assert h.strategy_used == expect
    with pytest.raises(ValueError, match="SWELL_MAX_SLOTS"):
        dispatch.spmv(csr, x, strategy="swell")
    with pytest.raises(ValueError, match="SWELL_MAX_SLOTS"):
        dispatch.make_spmv_fn(csr, strategy="swell")
    with pytest.raises(ValueError, match="SWELL_MAX_SLOTS"):
        spmm(csr, torch.zeros(csr.cols, 2, dtype=torch.float64), strategy="swell")
    assert built == []


def test_make_spmv_fn_matches_spmv():
    ref = example_like("dw4096")
    rp, ci, v, (m, n) = ref.to_numpy()
    x, y = (torch.from_numpy(a) for a in random_x_y(n, m, seed=36))
    csr = _port(ref)
    fn, chosen = dispatch.make_spmv_fn(csr, ALPHA, BETA)
    assert chosen == "swell"
    assert torch.equal(fn(x, y), dispatch.spmv(csr, x, y, ALPHA, BETA))
    assert sum(swell.LAUNCHES.values()) == 0


@pytest.fixture
def files(tmp_path):
    ref = random_csr(300, 300, 2400, seed=37)
    rp, ci, v, shape = ref.to_numpy()
    x, _ = random_x_y(shape[1], shape[0], seed=38)
    paths = {"csr": tmp_path / "m.csr", "mtx": tmp_path / "m.mtx", "bin2": tmp_path / "m.bin2"}
    write_csr_text(paths["csr"], rp, ci, v, x)
    write_mtx(paths["mtx"], np.repeat(np.arange(shape[0]), np.diff(rp)), ci, v, shape)
    write_bin2(paths["bin2"], rp, ci, v, shape)
    return {k: str(p) for k, p in paths.items()}


@pytest.mark.parametrize("fmt", ["csr", "mtx", "bin2"])
def test_cli_passes_like_reference(files, fmt, capsys):
    assert cli_main([files[fmt], "-f", fmt, "--warmups", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"loaded {files[fmt]}: rows=300 cols=300 nnz=2400" in out
    assert "elapsed time:" in out and "[strategy: swell]" in out
    assert ref_cli_main([files[fmt], "-f", fmt, "--warmups", "1"]) == 0
    ref_out = capsys.readouterr().out
    pass_line = "Congratulation, pass 300 validation!"
    assert pass_line in out.splitlines() and pass_line in ref_out.splitlines()


def test_cli_alpha_beta_and_device_verify(files, capsys):
    rc = cli_main([files["bin2"], "-f", "bin2", "--alpha", "2.5", "--beta", "-1.0",
                   "--device-verify", "--warmups", "1", "--device", "cpu"])
    assert rc == 0
    assert "pass 300 validation" in capsys.readouterr().out


def test_cli_exit_codes(tmp_path, files, capsys):
    assert cli_main([str(tmp_path / "nope.csr"), "-f", "csr", "--device", "cpu"]) == 2
    assert cli_main([files["csr"], "-f", "csr", "-s", "nope", "--device", "cpu"]) == 2
    assert "unknown strategy 'nope'" in capsys.readouterr().err
    assert cli_main([files["csr"], "-f", "csr", "-s", "flat", "--device", "cpu"]) == 0
