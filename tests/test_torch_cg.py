"""The port's CG solver (``models/cg.py``), ``spmv-solve`` and the anisotropic
diffusion generator against the JAX package's, on the same numpy inputs.

Tolerances: CG iteration counts may differ by one, because the two sides sum
in another order and the residual test can fall either side of the threshold;
the solutions agree within 1e-9 relative and are within 1e-8 of x_true at tol
1e-10 (the matrices are well conditioned).  The generator's arrays and the
CLI's verdict line and exit code are equal."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_acc_tpu.cli.solve import main as ref_solve_main
from spmv_acc_tpu.formats import banded_csr
from spmv_acc_tpu.formats import random_csr as ref_random_csr
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays, csr_to_dense
from spmv_acc_tpu.formats.generate import aniso_laplacian_csr as ref_aniso
from spmv_acc_tpu.formats.generate import random_x_y as ref_random_x_y
from spmv_acc_tpu.models import cg as ref_cg
from spmv_acc_tpu.ops import trisolve as ref_tri
from spmv_acc_tpu_torch.cli.solve import main as solve_main
from spmv_acc_tpu_torch.dispatch import clear_caches
from spmv_acc_tpu_torch.formats.containers import CSR
from spmv_acc_tpu_torch.formats.generate import aniso_laplacian_csr
from spmv_acc_tpu_torch.io import write_csr_text
from spmv_acc_tpu_torch.models import cg
from spmv_acc_tpu_torch.ops import trisolve as tri


@pytest.fixture(autouse=True)
def _clear_port_caches():
    yield
    clear_caches()


def _spd(m, seed):
    rp, ci, v, shape = banded_csr(m, bandwidth=5, seed=seed).to_numpy()
    d = csr_to_dense(rp, ci, v, shape)
    d = 0.5 * (d + d.T)
    d += np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    return coo_to_csr_arrays(rr, cc, d[rr, cc], shape) + (shape, d)


@pytest.mark.parametrize("nx,ny,eps", [(16, 12, 1e-4), (7, 9, 0.3)])
def test_aniso_laplacian_matches_reference(nx, ny, eps):
    ours = aniso_laplacian_csr(nx, ny, eps).to_numpy()
    ref = ref_aniso(nx, ny, eps).to_numpy()
    for a, b in zip(ours[:3], ref[:3]):
        assert np.array_equal(a, np.asarray(b))
    assert ours[3] == ref[3] == (nx * ny, nx * ny)


def test_jacobi_preconditioner_matches_reference():
    rp, ci, v, shape, _ = _spd(50, 3)
    r = np.random.default_rng(4).standard_normal(50)
    ours = cg.jacobi_preconditioner(CSR.from_numpy(rp, ci, v, shape))(torch.from_numpy(r))
    ref = ref_cg.jacobi_preconditioner(RefCSR.from_numpy(rp, ci, v, shape))(jnp.asarray(r))
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def _precond(kind, csr, ref_csr):
    if kind == "jacobi":
        return cg.jacobi_preconditioner(csr), ref_cg.jacobi_preconditioner(ref_csr)
    if kind == "ilu":
        return tri.ilu0(csr, sweeps=3), ref_tri.ilu0(ref_csr, sweeps=3)
    return None, None


@pytest.mark.parametrize("precond", ["none", "jacobi", "ilu"])
@pytest.mark.parametrize("strategy", ["line", "swell"])
def test_cg_solve_matches_reference(strategy, precond):
    m = 200
    rp, ci, v, shape, d = _spd(m, 14)
    x_true = np.random.default_rng(15).standard_normal(m)
    b = d @ x_true
    csr, ref_csr = CSR.from_numpy(rp, ci, v, shape), RefCSR.from_numpy(rp, ci, v, shape)
    p, p_ref = _precond(precond, csr, ref_csr)
    res = cg.cg_solve(csr, torch.from_numpy(b), tol=1e-10, max_iters=400, strategy=strategy,
                      precond=p)
    ref = ref_cg.cg_solve(ref_csr, jnp.asarray(b), tol=1e-10, max_iters=400,
                          strategy=strategy, precond=p_ref)
    x, x_ref = res.x.numpy(), np.asarray(ref.x)
    assert abs(res.iters - int(ref.iters)) <= 1 and res.iters < 400
    assert np.linalg.norm(x - x_ref) <= 1e-9 * np.linalg.norm(x_ref)
    assert np.linalg.norm(x - x_true) < 1e-8 * np.linalg.norm(x_true)
    assert float(res.residual_norm) <= 1e-10 * np.linalg.norm(b)


def test_cg_on_the_aniso_system_matches_reference():
    """The weakly dominant case where ILU(0) pays: fewer iterations than Jacobi."""
    rp, ci, v, shape = aniso_laplacian_csr(20, 20).to_numpy()
    x_true = np.random.default_rng(5).standard_normal(400)
    b = csr_to_dense(rp, ci, v, shape) @ x_true
    csr, ref_csr = CSR.from_numpy(rp, ci, v, shape), RefCSR.from_numpy(rp, ci, v, shape)
    iters = {}
    for kind in ("jacobi", "ilu"):
        p, p_ref = _precond(kind, csr, ref_csr)
        res = cg.cg_solve(csr, torch.from_numpy(b), tol=1e-10, max_iters=2000,
                          strategy="swell", precond=p)
        ref = ref_cg.cg_solve(ref_csr, jnp.asarray(b), tol=1e-10, max_iters=2000,
                              strategy="swell", precond=p_ref)
        assert abs(res.iters - int(ref.iters)) <= 1
        assert np.linalg.norm(res.x.numpy() - np.asarray(ref.x)) <= 1e-9 * np.linalg.norm(x_true)
        iters[kind] = res.iters
    assert iters["ilu"] < iters["jacobi"] < 2000


def test_cg_loop_stops_at_max_iters():
    rp, ci, v, shape = aniso_laplacian_csr(20, 20).to_numpy()
    csr = CSR.from_numpy(rp, ci, v, shape)
    b = torch.ones(400, dtype=torch.float64)
    res = cg.cg_solve(csr, b, tol=1e-14, max_iters=5, strategy="line")
    assert res.iters == 5 and float(res.residual_norm) > 1e-14 * 20


def test_cg_solve_with_a_zero_right_hand_side_takes_no_iteration():
    rp, ci, v, shape, _ = _spd(30, 2)
    res = cg.cg_solve(CSR.from_numpy(rp, ci, v, shape), torch.zeros(30, dtype=torch.float64))
    assert res.iters == 0 and not res.x.any()


@pytest.fixture
def csr_file(tmp_path):
    """The JAX package's CLI fixture (tests/test_cli.py)."""
    csr = ref_random_csr(40, 40, 300, seed=51)
    rp, ci, v, shape = csr.to_numpy()
    x, _ = ref_random_x_y(shape[1], shape[0], seed=52)
    path = tmp_path / "test.csr"
    write_csr_text(str(path), rp, ci, v, x)
    return str(path)


@pytest.mark.parametrize("args", [
    ["--precond", "jacobi", "--strategy", "line"],
    ["--precond", "ilu0", "--sweeps", "4"],
    ["--precond", "ilu0"],
    ["--precond", "none", "--strategy", "swell", "--tol", "1e-12"],
])
def test_solve_cli_matches_reference(csr_file, capsys, args):
    rc_ref = ref_solve_main([csr_file, "-f", "csr", *args])
    ref_out = capsys.readouterr().out.splitlines()
    rc = solve_main([csr_file, "-f", "csr", *args, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == rc_ref == 0
    assert out[0] == ref_out[0] and out[0].startswith("SPD-ized: nnz (40, 40) -> ")
    assert out[-1] == ref_out[-1] == "Congratulation, solution verified!"
    kind = args[1]
    assert out[1].startswith(f"{csr_file} cg[{kind}] iters=")
    iters = [int(line.split("iters=")[1].split()[0]) for line in (out[1], ref_out[1])]
    assert abs(iters[0] - iters[1]) <= 1


def test_solve_cli_fails_verification_like_reference(csr_file, capsys):
    args = [csr_file, "-f", "csr", "--max-iters", "1", "--precond", "none"]
    rc_ref = ref_solve_main(args)
    ref_last = capsys.readouterr().out.splitlines()[-1]
    rc = solve_main(args + ["--device", "cpu"])
    last = capsys.readouterr().out.splitlines()[-1]
    assert rc == rc_ref == 1
    assert last.startswith("solution FAILED verification (rel err ")
    assert ref_last.startswith("solution FAILED verification (rel err ")


def test_solve_cli_needs_a_card_or_the_cpu(csr_file, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert solve_main([csr_file, "-f", "csr"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert solve_main([csr_file, "-f", "csr", "--device", "cuda"]) == 2


def test_solve_cli_refuses_a_rectangular_matrix(tmp_path, capsys):
    rp, ci, v, shape = ref_random_csr(20, 30, 100, seed=3).to_numpy()
    path = str(tmp_path / "rect.csr")
    write_csr_text(path, rp, ci, v, np.zeros(30))
    assert solve_main([path, "-f", "csr", "--device", "cpu"]) == 2
    assert "CG needs square" in capsys.readouterr().err


# ---- the masked blocks (cg.CGBlocks): what a captured graph replays on a card,
# run eagerly here.  Masked iterations do the plain loop's arithmetic where
# active and keep the carry where not, so iterations and x equal _cg_loop's
# bit for bit.

def _aniso_system(n=20):
    rp, ci, v, shape = aniso_laplacian_csr(n, n).to_numpy()
    x_true = np.random.default_rng(5).standard_normal(n * n)
    b = csr_to_dense(rp, ci, v, shape) @ x_true
    return CSR.from_numpy(rp, ci, v, shape), torch.from_numpy(b)


def _matvec(csr):
    from spmv_acc_tpu_torch.ops import swell

    layout = swell.get_swell_plan(csr)
    return lambda v: swell.swell_ax(layout, v)


@pytest.mark.parametrize("block", [1, 3, 16])
@pytest.mark.parametrize("case", ["converges", "max_iters", "zero_rhs"])
def test_masked_blocks_equal_the_plain_loop(block, case):
    csr, b = _aniso_system()
    if case == "zero_rhs":
        b = torch.zeros_like(b)
    tol, max_iters = (1e-14, 7) if case == "max_iters" else (1e-8, 2000)
    M = cg.jacobi_preconditioner(csr)
    mv = _matvec(csr)
    want = cg._cg_loop(mv, M, b, torch.zeros_like(b), tol, max_iters)
    got = cg.CGBlocks(mv, M, b, block=block, eager_iters=0).solve(b, torch.zeros_like(b), tol,
                                                                 max_iters)
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x) and torch.equal(got.residual_norm, want.residual_norm)
    if case == "converges":
        assert 1 < want.iters < 2000 and (block == 1 or want.iters % block)  # stops mid-block
    if case == "zero_rhs":
        assert got.iters == 0 and not got.x.any()
    if case == "max_iters":
        assert got.iters == 7


@pytest.mark.parametrize("block", [3, 16])
def test_a_block_past_max_iters_is_masked(block):
    """A whole block from 0 with max_iters 2: the masked iterations past it
    leave the carry as the plain loop's 2 iterations left it."""
    from spmv_acc_tpu_torch.utils.graphs import Loop

    csr, b = _aniso_system()
    mv = _matvec(csr)
    solver = cg.CGBlocks(mv, None, b, block=block)
    carry, tol2 = cg._cg_start(mv, solver.M, b, torch.zeros_like(b), 1e-14)
    solver.tol2.copy_(tol2)
    solver.max_iters.fill_(2)
    step = functools.partial(cg._masked_step, mv, solver.M, None, solver.tol2,
                             solver.max_iters)
    loop = Loop(step, carry, unroll=block)
    loop.advance(block)
    x, _, _, _, _, it = loop.carry
    want = cg._cg_loop(mv, None, b, torch.zeros_like(b), 1e-14, 2)
    assert int(it) == 2 and torch.equal(x, want.x)


@pytest.mark.parametrize("block", [1, 3, 16])
def test_masked_blocks_match_reference(block, monkeypatch):
    """cg_solve through the masked blocks against JAX cg_solve, under the gates
    of test_cg_solve_matches_reference."""
    monkeypatch.setattr(cg, "CG_BLOCK", block)
    m = 200
    rp, ci, v, shape, d = _spd(m, 14)
    x_true = np.random.default_rng(15).standard_normal(m)
    b = d @ x_true
    csr, ref_csr = CSR.from_numpy(rp, ci, v, shape), RefCSR.from_numpy(rp, ci, v, shape)
    p, p_ref = _precond("ilu", csr, ref_csr)
    res = cg.cg_solve(csr, torch.from_numpy(b), tol=1e-10, max_iters=400, strategy="swell",
                      precond=p)
    ref = ref_cg.cg_solve(ref_csr, jnp.asarray(b), tol=1e-10, max_iters=400, strategy="swell",
                          precond=p_ref)
    assert abs(res.iters - int(ref.iters)) <= 1 and res.iters < 400
    assert np.linalg.norm(res.x.numpy() - np.asarray(ref.x)) <= 1e-9 * np.linalg.norm(ref.x)


@pytest.mark.parametrize("eager_iters", [0, 1, 5, 8, 9, 63, 5000])
@pytest.mark.parametrize("case", ["converges", "max_iters"])
def test_plain_iterations_then_masked_blocks_equal_the_plain_loop(eager_iters, case):
    """CGBlocks' plain start (eager_iters iterations, the stop test on the
    host) hands its carry to the masked blocks: iterations and x are the
    plain loop's bit for bit wherever the hand-over falls, and the blocks'
    loop is built only when the solve goes past the plain start."""
    csr, b = _aniso_system()
    tol, max_iters = (1e-14, 40) if case == "max_iters" else (1e-8, 2000)
    M = cg.jacobi_preconditioner(csr)
    mv = _matvec(csr)
    want = cg._cg_loop(mv, M, b, torch.zeros_like(b), tol, max_iters)
    solver = cg.CGBlocks(mv, M, b, block=8, eager_iters=eager_iters)
    got = solver.solve(b, torch.zeros_like(b), tol, max_iters)
    assert got.iters == want.iters
    assert torch.equal(got.x, want.x) and torch.equal(got.residual_norm, want.residual_norm)
    assert (solver.loop is None) == (eager_iters >= want.iters)


def test_cg_solve_captures_only_past_the_plain_start(monkeypatch):
    """cg_solve builds a block loop (a capture on a card) only when the solve
    runs past CG_EAGER_ITERS plain iterations."""
    csr, b = _aniso_system()
    built = []
    real = cg.CGBlocks.solve

    def solve(self, *a):
        out = real(self, *a)
        built.append(self.loop is not None)
        return out

    monkeypatch.setattr(cg.CGBlocks, "solve", solve)
    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 8)
    res = cg.cg_solve(csr, b, tol=1e-8, strategy="swell", precond=cg.jacobi_preconditioner(csr))
    assert res.iters > 8 and built == [True]
    monkeypatch.setattr(cg, "CG_EAGER_ITERS", res.iters + 1)
    again = cg.cg_solve(csr, b, tol=1e-8, strategy="swell",
                        precond=cg.jacobi_preconditioner(csr))
    assert built == [True, False]
    assert again.iters == res.iters and torch.equal(again.x, res.x)


@pytest.mark.parametrize("strategy", ["flat", "line", "default"])
def test_cg_solve_runs_every_strategy_through_the_blocks(strategy, monkeypatch):
    """No strategy is held back from the blocks (flat's chunk spans come from
    the plan, not from the device): cg_solve from the first iteration in
    blocks equals the plain loop on the same matvec, bit for bit (the CPU's
    index_add_ repeats itself)."""
    from spmv_acc_tpu_torch.dispatch import spmv

    monkeypatch.setattr(cg, "CG_EAGER_ITERS", 0)
    csr, b = _aniso_system(12)
    want = cg._cg_loop(lambda v: spmv(csr, v, strategy=strategy), None, b, torch.zeros_like(b),
                       1e-10, 1000)
    got = cg.cg_solve(csr, b, tol=1e-10, max_iters=1000, strategy=strategy)
    assert got.iters == want.iters and torch.equal(got.x, want.x)
