"""The distributed loops as one device program: ``dist_cg_solve`` and
``dist_swell_cg_solve`` through ``models.cg.CGBlocks`` (plain iterations,
then masked blocks; captured graphs with the collectives inside on the card)
and the weak-scaling step through ``utils.graphs.Loop``, in gloo ranks at
D = 2 and 4 against the JAX package on its 8-device virtual CPU mesh, on the
same numpy inputs.

On the CPU the blocks and the loop run their steps eagerly: these tests hold
the logic that the card replays.  ``CG_EAGER_ITERS`` is lowered inside the
ranks, so that the masked blocks run: from the first iteration (the solve
then stops inside a block) or after a few plain ones (it stops at a block's
end).  Tolerances: the iteration count is the JAX package's on every rank,
and x is within 1e-8 of JAX's and of x_true, as ``test_torch_dist.py`` and
``test_torch_dist_swell.py`` hold the plain loop (both sum the dots over the
same row blocks; a masked iteration after convergence changes nothing).  A
solve at tol 0 runs exactly ``max_iters`` iterations on every rank, the last
block cut short.  The scaling step through ``Loop`` equals the Python chain
bit for bit, and one masked step reads nothing on the host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from spmv_acc_tpu.formats.containers import CSR as RefCSR
from spmv_acc_tpu.formats.convert import coo_to_csr_arrays, csr_to_dense
from spmv_acc_tpu.formats.generate import banded_csr as ref_banded
from spmv_acc_tpu.formats.generate import fem_like_csr as ref_fem_like
from spmv_acc_tpu.models.cg import dist_cg_solve as ref_dist_cg_solve
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.parallel import make_mesh as ref_make_mesh
from spmv_acc_tpu.parallel import pad_vector as ref_pad_vector
from spmv_acc_tpu.parallel import partition_rows as ref_partition_rows
from spmv_acc_tpu.parallel import shard_partitioned as ref_shard_partitioned
from spmv_acc_tpu.parallel import unpad_vector as ref_unpad_vector
from spmv_acc_tpu.parallel.dist_swell import dist_swell_cg_solve as ref_dist_swell_cg_solve
from spmv_acc_tpu.parallel.dist_swell import dist_swell_spmv_fn as ref_dist_swell_spmv_fn
from spmv_acc_tpu.parallel.dist_swell import build_dist_swell as ref_build_dist_swell
from spmv_acc_tpu_torch.models.cg import CG_BLOCK
from spmv_acc_tpu_torch.parallel.launch import rank_cases, spawn


def _banded_spd():
    """test_torch_dist.py's CG system (64 rows): (rp, ci, v, shape, b, x_true)."""
    m = 64
    d = csr_to_dense(*ref_banded(m, bandwidth=3, seed=46).to_numpy())
    d = 0.5 * (d + d.T) + np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    rp, ci, v = coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m))
    x_true = np.random.default_rng(47).random(m)
    return (rp, ci, v, (m, m)), d @ x_true, x_true


def _fem_spd():
    """test_torch_dist_swell.py's swell CG system (8192 rows, fem_like
    symmetrised, diagonally dominant): ((rp, ci, v, shape), b, x_true)."""
    m = 8192
    rp, ci, v, _ = ref_fem_like(m, m, 6 * m, block=3, seed=31, dtype=np.float64).to_numpy()
    rr = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    diag = np.zeros(m)
    np.add.at(diag, rr, 0.5 * np.abs(v))
    np.add.at(diag, ci, 0.5 * np.abs(v))
    rp, ci, v = coo_to_csr_arrays(
        np.concatenate([rr, ci, np.arange(m)]), np.concatenate([ci, rr, np.arange(m)]),
        np.concatenate([0.5 * v, 0.5 * v, diag + 1.0]), (m, m))
    x_true = np.random.default_rng(32).uniform(-1, 1, size=m)
    return (rp, ci, v, (m, m)), host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(m)), x_true


# (kind, system, tol, max_iters, CG_EAGER_ITERS in the ranks).  The JAX
# package takes 27 (banded) and 28 (fem) iterations at these tolerances: from
# 0 plain iterations both stop inside a block of 8, after 3 / 4 at a block's end
CASES = {
    "cg masked from 0": ("cg", "banded", 1e-12, 200, 0),
    "cg masked after 3": ("cg", "banded", 1e-12, 200, 3),
    "cg cut at 13": ("cg", "banded", 0.0, 13, 3),
    "swell_cg masked from 0": ("swell_cg", "fem", 1e-10, 300, 0),
    "swell_cg masked after 4": ("swell_cg", "fem", 1e-10, 300, 4),
    "swell_cg cut at 11": ("swell_cg", "fem", 0.0, 11, 0),
}
SYSTEMS = {"banded": _banded_spd, "fem": _fem_spd}
SCALING_STEPS = 11  # graphs of 4 steps and a remainder of 3


def _scaling_csr():
    return ref_banded(6000, bandwidth=9, seed=11, dtype=np.float64).to_numpy()


def _cases():
    cases = []
    for kind, system, tol, max_iters, eager in CASES.values():
        csr, b, _ = SYSTEMS[system]()
        cases.append(dict(kind=kind, csr=csr, b=b, tol=tol, max_iters=max_iters,
                          eager_iters=eager))
    cases.append(dict(kind="scaling_loop", csr=_scaling_csr(), steps=SCALING_STEPS))
    csr, b, _ = _banded_spd()
    cases.append(dict(kind="masked_step", csr=csr, b=b))
    return cases


_RESULTS = {}


def _results(D):
    """Every rank's results of one spawn of D gloo ranks running every case."""
    if D not in _RESULTS:
        _RESULTS[D] = spawn(rank_cases, D, "cpu", _cases())
    return _RESULTS[D]


def _reference(kind, system, tol, max_iters, D):
    """JAX's (x in global rows, iterations) on D of its virtual devices."""
    (rp, ci, v, shape), b, _ = SYSTEMS[system]()
    mesh = ref_make_mesh(D)
    if kind == "cg":
        part = ref_shard_partitioned(ref_partition_rows(RefCSR.from_numpy(rp, ci, v, shape), D,
                                                        balance=False), mesh)
        res = ref_dist_cg_solve(part, ref_pad_vector(part, b), mesh, tol=tol,
                                max_iters=max_iters)
        return np.asarray(ref_unpad_vector(part, np.asarray(res.x))), int(res.iters)
    res, _ = ref_dist_swell_cg_solve(RefCSR.from_numpy(rp, ci, v, shape), jnp.asarray(b), mesh,
                                     tol=tol, max_iters=max_iters)
    return np.asarray(res.x)[: shape[0]], int(res.iters)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("D", [2, 4])
def test_masked_blocks_match_reference(D, case):
    """Each solve takes the JAX package's iteration count on every rank, and
    x agrees with JAX's (and, converged, with x_true) within 1e-8."""
    kind, system, tol, max_iters, eager = CASES[case]
    i = list(CASES).index(case)
    x, iters = _results(D)[0][i]
    assert [r[i][1] for r in _results(D)] == [iters] * D
    ref_x, ref_iters = _reference(kind, system, tol, max_iters, D)
    assert iters == ref_iters and eager < iters <= max_iters
    assert np.linalg.norm(x - ref_x) <= 1e-8 * np.linalg.norm(ref_x)
    if tol > 0:
        x_true = SYSTEMS[system]()[2]
        assert np.linalg.norm(x - x_true) <= 1e-8 * np.linalg.norm(x_true)


@pytest.mark.parametrize("case", ["cg masked from 0", "swell_cg masked from 0"])
@pytest.mark.parametrize("D", [2, 4])
def test_a_solve_stops_inside_a_block(D, case):
    """Converged partway through a block: the block's last iterations are
    masked, the count stops where the stop test first failed, and the host
    reads the flag once a block (so the count is not a block multiple)."""
    _, _, _, _, eager = CASES[case]
    iters = _results(D)[0][list(CASES).index(case)][1]
    assert (iters - eager) % CG_BLOCK != 0


@pytest.mark.parametrize("case", ["cg cut at 13", "swell_cg cut at 11"])
@pytest.mark.parametrize("D", [2, 4])
def test_a_solve_cut_at_max_iters_runs_exactly_max_iters(D, case):
    """tol 0: every rank runs exactly ``max_iters`` iterations, the last
    block cut to the iterations left."""
    _, _, _, max_iters, eager = CASES[case]
    i = list(CASES).index(case)
    assert (max_iters - eager) % CG_BLOCK != 0
    assert [r[i][1] for r in _results(D)] == [max_iters] * D


@pytest.mark.parametrize("D", [2, 4])
def test_scaling_step_through_loop_equals_eager_chain(D):
    """The weak-scaling step (halo exchange, swell shard, all-reduced max)
    replayed by ``Loop`` equals the Python chain bit for bit on every rank,
    and both equal JAX's chain of the same step within the float64 gate."""
    looped, chained = _results(D)[0][len(CASES)]
    assert np.array_equal(looped, chained)
    for r in _results(D)[1:]:
        assert np.array_equal(r[len(CASES)][0], looped)
    rp, ci, v, shape = _scaling_csr()
    dsp = ref_build_dist_swell(RefCSR.from_numpy(rp, ci, v, shape), D)
    mesh = ref_make_mesh(D)
    run = ref_dist_swell_spmv_fn(dsp, mesh)
    x = jax.device_put(jnp.zeros(dsp.padded_len, dtype=jnp.float64).at[: shape[1]].set(1.0),
                       NamedSharding(mesh, P("x")))
    for _ in range(SCALING_STEPS):
        y = run(x)
        x = y * (1.0 / jnp.maximum(jnp.max(jnp.abs(y)), 1e-30))
    ref = np.asarray(x)[: shape[0]]
    assert np.all(np.abs(looped - ref) <= 1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("D", [2, 4])
def test_masked_step_reads_nothing_on_the_host(D):
    """One masked CG iteration over each distributed matvec (all-gather and
    halo ``dist_spmv``, ``dist_swell``) with ``Tensor.item`` and
    ``__bool__`` raising: the step the card captures makes no host read."""
    for r in _results(D):
        assert r[len(CASES) + 1] == ["gather", "halo", "swell"]
