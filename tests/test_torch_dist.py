"""The port's distributed SpMV, CG and hybrid mesh (``parallel/dist_spmv.py``,
``models/cg.py::dist_cg_solve``, ``parallel/multihost.py``) in gloo ranks
against the JAX package's on its 8-device virtual CPU mesh, on the same numpy
inputs.

One spawn per world size (D = 2 and D = 4) runs every case; the JAX side
runs in the test process.  Tolerances: every SpMV passes the reference's
float64 gate (``verify_y``: rel 1e-7, abs 1e-14 near zero) against JAX's
output and against ``host_spmv``; the CG solution agrees with JAX's within
1e-8 and takes the same number of iterations (both sum the dots over the
same row blocks, at tol 1e-12 on a well-conditioned system)."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_acc_tpu.formats import banded_csr as ref_banded
from spmv_acc_tpu.formats import powerlaw_csr as ref_powerlaw
from spmv_acc_tpu.formats import random_csr as ref_random
from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays, csr_to_dense
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.models.cg import dist_cg_solve as ref_dist_cg_solve
from spmv_acc_tpu.ops.golden import host_spmv_plain
from spmv_acc_tpu.parallel import dist_spmv as ref_dist_spmv
from spmv_acc_tpu.parallel import make_mesh as ref_make_mesh
from spmv_acc_tpu.parallel import pad_vector as ref_pad_vector
from spmv_acc_tpu.parallel import partition_rows as ref_partition_rows
from spmv_acc_tpu.parallel import shard_partitioned as ref_shard_partitioned
from spmv_acc_tpu.parallel import unpad_vector as ref_unpad_vector
from spmv_acc_tpu.parallel import unpad_y as ref_unpad_y
from spmv_acc_tpu.parallel.dist_spmv import halo_feasible as ref_halo_feasible
from spmv_acc_tpu.parallel.multihost import dist_spmv_hier as ref_dist_spmv_hier
from spmv_acc_tpu.parallel.multihost import hybrid_mesh as ref_hybrid_mesh
from spmv_acc_tpu.parallel.multihost import shard_partitioned_hier as ref_shard_hier
from spmv_acc_tpu.utils.verify import verify_y
from spmv_acc_tpu_torch.parallel.launch import rank_cases, spawn
from spmv_acc_tpu_torch.parallel.multihost import init_distributed

MATRICES = {
    "random": lambda: ref_random(96, 96, 900, seed=42),
    "powerlaw": lambda: ref_powerlaw(96, 96, avg_nnz=7, seed=43),
    "banded": lambda: ref_banded(4000, bandwidth=9, seed=13, dtype=np.float64),
    "scattered": lambda: ref_random(600, 600, 6000, seed=3),
    "hier": lambda: ref_powerlaw(96, 96, avg_nnz=7, seed=51),
}
# (matrix, balance, halo): halo None lets dist_spmv choose
SPMV_CASES = {
    "random": ("random", True, None),
    "powerlaw": ("powerlaw", True, None),
    "banded-halo": ("banded", False, True),
    "banded-auto": ("banded", False, None),
    "banded-gather": ("banded", False, False),
    "scattered-auto": ("scattered", False, None),
}
HIER = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}


def _x(name):
    m, n = MATRICES[name]().shape
    return random_x_y(n, m, seed=44)[0]


def _spd_system():
    """test_parallel.py::test_dist_cg_solve's system: (rp, ci, v, b, x_true)."""
    m = 64
    d = csr_to_dense(*ref_banded(m, bandwidth=3, seed=46).to_numpy())
    d = 0.5 * (d + d.T) + np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    rp, ci, v = coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m))
    x_true = np.random.default_rng(47).random(m)
    return rp, ci, v, d @ x_true, x_true


def _cases(D):
    cases = []
    for name, (mat, balance, halo) in SPMV_CASES.items():
        cases.append(dict(kind="spmv", csr=MATRICES[mat]().to_numpy(), x=_x(mat),
                          balance=balance, halo=halo))
    for shape in HIER[D]:
        cases.append(dict(kind="hier", csr=MATRICES["hier"]().to_numpy(), x=_x("hier"),
                          shape=shape))
    rp, ci, v, b, _ = _spd_system()
    cases.append(dict(kind="cg", csr=(rp, ci, v, (64, 64)), b=b, tol=1e-12, max_iters=200))
    for mat in ("banded", "scattered"):
        cases.append(dict(kind="context", csr=MATRICES[mat]().to_numpy()))
    return cases


_RESULTS = {}


def _results(D):
    """Every rank's results of one spawn of D ranks running every case."""
    if D not in _RESULTS:
        _RESULTS[D] = spawn(rank_cases, D, "cpu", _cases(D))
    return _RESULTS[D]


def _index(D, kind, i=0):
    cases = _cases(D)
    hits = [j for j, c in enumerate(cases) if c["kind"] == kind]
    return hits[i]


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_dist_spmv_matches_reference(D, case):
    mat, balance, halo = SPMV_CASES[case]
    ref_csr = MATRICES[mat]()
    x = _x(mat)
    y = _results(D)[0][list(SPMV_CASES).index(case)]
    mesh = ref_make_mesh(D)
    part = ref_shard_partitioned(ref_partition_rows(ref_csr, D, balance=balance), mesh)
    ref_y = np.asarray(ref_unpad_y(part, ref_dist_spmv(part, jnp.asarray(x), mesh, halo=halo)))
    golden = host_spmv_plain(*ref_csr.to_numpy()[:3], x)
    assert y.shape == golden.shape
    assert verify_y(y, ref_y, np.float64).failed_count == 0
    assert verify_y(y, golden, np.float64).failed_count == 0


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4)])
def test_hybrid_mesh_matches_reference(shape):
    D = shape[0] * shape[1]
    ref_csr = MATRICES["hier"]()
    x = _x("hier")
    y = _results(D)[0][len(SPMV_CASES) + HIER[D].index(shape)]
    mesh = ref_hybrid_mesh(dcn=shape[0], ici=shape[1], devices=jax.devices()[:D])
    part = ref_shard_hier(ref_partition_rows(ref_csr, D), mesh)
    ref_y = np.asarray(ref_unpad_y(part, ref_dist_spmv_hier(part, jnp.asarray(x), mesh)))
    golden = host_spmv_plain(*ref_csr.to_numpy()[:3], x)
    assert verify_y(y, ref_y, np.float64).failed_count == 0
    assert verify_y(y, golden, np.float64).failed_count == 0


@pytest.mark.parametrize("D", [2, 4])
def test_dist_cg_solve_matches_reference(D):
    """test_parallel.py::test_dist_cg_solve's system at D shards: the solution
    within 1e-8 of JAX's and of x_true, and the same iteration count."""
    x, iters = _results(D)[0][_index(D, "cg")]
    assert all(r[_index(D, "cg")][1] == iters for r in _results(D))
    rp, ci, v, b, x_true = _spd_system()
    mesh = ref_make_mesh(D)
    part = ref_shard_partitioned(ref_partition_rows(RefCSR.from_numpy(rp, ci, v, (64, 64)), D,
                                                    balance=False), mesh)
    res = ref_dist_cg_solve(part, ref_pad_vector(part, b), mesh, tol=1e-12, max_iters=200)
    ref_x = np.asarray(ref_unpad_vector(part, np.asarray(res.x)))
    assert iters == int(res.iters) and 0 < iters < 200
    assert np.allclose(x, ref_x, atol=1e-8) and np.allclose(x, x_true, atol=1e-8)


@pytest.mark.parametrize("mat", ["banded", "scattered"])
@pytest.mark.parametrize("D", [2, 4])
def test_rank_context_and_halo_choice(D, mat):
    """In a spawned rank: ``init_distributed()`` reports the joined group
    without joining again, every rank takes the reference's halo decision
    (and-ed over the mesh), and JAX was never imported."""
    i = _index(D, "context", ["banded", "scattered"].index(mat))
    ref = ref_halo_feasible(ref_partition_rows(MATRICES[mat](), D, balance=False))
    for rank, results in enumerate(_results(D)):
        ctx = results[i]
        assert ctx["process_count"] == ctx["global_device_count"] == D
        assert ctx["process_index"] == rank
        assert not ctx["initialized"] and not ctx["jax_imported"]
        assert ctx["halo_feasible"] == ref


def test_init_distributed_without_environment(monkeypatch):
    """No launcher variables and no arguments: the single-process context."""
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_JOB_ID", "SLURM_PROCID",
                "SLURM_NTASKS"):
        monkeypatch.delenv(key, raising=False)
    ctx = init_distributed(device="cpu")
    assert not ctx.initialized
    assert (ctx.process_index, ctx.process_count, ctx.global_device_count) == (0, 1, 1)


def test_init_distributed_explicit_joins_and_raises():
    """Explicit arguments join the group (gloo, a rendezvous file); a second
    explicit join raises instead of degrading; a bad device is refused."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="device"):
        init_distributed(process_id=0, device="tpu")
    with tempfile.TemporaryDirectory() as td:
        init = "file://" + os.path.join(td, "rendezvous")
        ctx = init_distributed(coordinator_address=init, num_processes=1, process_id=0,
                               device="cpu")
        try:
            assert ctx.initialized and dist.is_initialized()
            assert (ctx.process_index, ctx.process_count) == (0, 1)
            assert dist.get_backend() == "gloo"
            with pytest.raises((RuntimeError, ValueError)):
                init_distributed(coordinator_address=init, num_processes=1, process_id=0,
                                 device="cpu")
        finally:
            dist.destroy_process_group()


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="unknown case kind"):
        spawn(rank_cases, 2, "cpu", [dict(kind="nonsense")])
    with pytest.raises(ValueError):
        spawn(rank_cases, 1, "tpu", [])
    with pytest.raises(TypeError):  # the device is named by the caller, never assumed
        spawn(rank_cases, 1)
